"""k1_roofline_pct.locate: K1's share of its roofline in the calibrations' K1
calls (pipeline/evm.locate), in percent: the least time the card could take
for the profiled stretch's K1 calls (each call's float32 frames read once
and kept Laplacian levels written once at 3.35 TB/s, or its operations at 67
TFLOP/s, from the call's shapes alone: harness/timing.k1_bound) over the
device seconds of K1's kernels in the trace. Nothing when the stretch ran no
K1 kernel."""


def read(trace):
    device_s = trace.k1_seconds(trace.profile["kernels_s"])
    if not trace.k1_calls or device_s <= 0:
        return None
    bound_s = sum(trace.bound(shape[0], shape[1], shape[2], levels,
                              skip)["bound_ms"] * 1e-3
                  for shape, levels, skip in trace.k1_calls)
    return 100.0 * bound_s / device_s
