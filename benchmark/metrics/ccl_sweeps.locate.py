"""ccl_sweeps.locate: fixed-point sweeps of the connected-component search per
calibration (``sweeps`` of the program's ``locate.ccl`` span, ops/ccl: the
hole fill's and the labelling's, each sweep one host read), averaged over the
profiled stretch's calibrations. Read from the program's span ring
(respmon_tpu_torch.utils.bench.snapshot); nothing where the program has no
such ring or span."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    sweeps = [s["counts"]["sweeps"] for s in snapshot()
              if s["name"] == "locate.ccl"]
    if not sweeps:
        return None
    return sum(sweeps) / len(sweeps)
