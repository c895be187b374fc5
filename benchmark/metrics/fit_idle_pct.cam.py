"""fit_idle_pct.cam: the share of the profiled stretch in which the device sat
idle while the host was inside the single monitor's Gaussian LM fit, in
percent: the idle seconds that the trace labels with the program's
``bpm.fit`` or ``bpm.lm_step`` span (the innermost program span open at the
gap's start; ops/gaussfit) over the stretch's seconds (torch.profiler).
Nothing where the trace holds no such label."""

LABELS = ("bpm.fit", "bpm.lm_step")


def read(trace):
    p = trace.profile
    if not p or p["window_s"] <= 0:
        return None
    idle = [p["idle_s"][k] for k in LABELS if k in p["idle_s"]]
    if not idle:
        return None
    return 100.0 * sum(idle) / p["window_s"]
