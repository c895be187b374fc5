"""lm_steps.cam: Levenberg-Marquardt iterations per BPM estimate of the single
monitor (the program's ``monitor.estimate`` span), summed over the Gaussian
fits it ran (``steps`` of each ``bpm.fit`` span under it: the float32 fit and
the float64 refit of wild lanes), averaged over the profiled stretch's
estimates. Read from the program's span ring
(respmon_tpu_torch.utils.bench.snapshot), which records while the profiler
runs; nothing where the program has no such ring or span."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    spans = snapshot()
    by_id = {s["id"]: s for s in spans}
    steps = {s["id"]: 0 for s in spans if s["name"] == "monitor.estimate"}
    for s in spans:
        if s["name"] != "bpm.fit":
            continue
        up = s["parent"]
        while up is not None and up not in steps:
            up = by_id[up]["parent"] if up in by_id else None
        if up is not None:
            steps[up] += s["counts"]["steps"]
    if not steps:
        return None
    return sum(steps.values()) / len(steps)
