"""k1_roofline_pct.absorb: K1's share of its roofline in the re-locking
fleet's absorbs (parallel/streams.absorb_streams: one K1 call over the
step's (S, H, W) frames into the rings' kept levels), in percent: the least
time the card could take for the profiled stretch's absorbs (each one's
float32 frames read once and kept Laplacian levels written once at 3.35
TB/s, or its operations at 67 TFLOP/s, from the shapes alone:
harness/timing.k1_bound at the ``frames`` count of each of the program's
``fleet.absorb`` spans and the cell's frame size and kept levels) over the
device seconds of K1's kernels in the trace. Nothing where the program has
no such span, or the stretch ran no K1 kernel."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    absorbs = [s for s in snapshot() if s["name"] == "fleet.absorb"]
    device_s = trace.k1_seconds(trace.profile["kernels_s"])
    if not absorbs or device_s <= 0:
        return None
    h, w = trace.run.frame_hw
    cal = trace.run.cfg.calibration
    bound_s = sum(trace.bound(s["counts"]["frames"], h, w,
                              cal.pyramid_levels,
                              cal.skip_levels_at_top)["bound_ms"] * 1e-3
                  for s in absorbs)
    return 100.0 * bound_s / device_s
