"""lm_steps.fleet: Levenberg-Marquardt iterations per BPM estimate of the
fleet (the program's ``fleet.estimate`` span: every stream's ring in one
lockstep fit), summed over the Gaussian fits it ran (``steps`` of each
``bpm.fit`` span under it; its slowest lane sets the count), averaged over
the profiled stretch's estimates. Read from the program's span ring
(respmon_tpu_torch.utils.bench.snapshot), which records while the profiler
runs; nothing where the program has no such ring or span."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    spans = snapshot()
    by_id = {s["id"]: s for s in spans}
    steps = {s["id"]: 0 for s in spans if s["name"] == "fleet.estimate"}
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
