"""motion_ms.cam: mean milliseconds of one call of the single monitor's flow
motion step (pipeline/motion.measure_step: ops/corners, ops/lk, ops/pca),
each call timed to the end of its device work (the synchronising spans of
the traced run)."""


def read(trace):
    return trace.spans.mean_ms("motion")
