"""lm_lane_use_pct.fleet: the useful share of the fleet's lockstep
Levenberg-Marquardt iterations, in percent: over the Gaussian fits of the
profiled stretch's fleet BPM estimates (``bpm.fit`` spans under the program's
``fleet.estimate`` span), 100 x the live lanes summed over every iteration
(``live_lane_steps``) over the lanes live at the start times the iterations
run (``lanes`` x ``steps``). Read from the program's span ring
(respmon_tpu_torch.utils.bench.snapshot); nothing where the program has no
such ring or span, or no fit iterated."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    spans = snapshot()
    by_id = {s["id"]: s for s in spans}
    used = offered = 0
    for s in spans:
        if s["name"] != "bpm.fit":
            continue
        up = s["parent"]
        while up is not None and by_id.get(up, {}).get("name") \
                != "fleet.estimate":
            up = by_id[up]["parent"] if up in by_id else None
        if up is None:
            continue
        c = s["counts"]
        used += c["live_lane_steps"]
        offered += c["lanes"] * c["steps"]
    if offered <= 0:
        return None
    return 100.0 * used / offered
