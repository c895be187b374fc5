"""idle_pct.recover: the share of the profiled stretch of the window in which
no kernel, copy or set ran on the device, in percent (torch.profiler)."""


def read(trace):
    p = trace.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
