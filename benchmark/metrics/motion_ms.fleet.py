"""motion_ms.fleet: mean milliseconds of one call of the fleet's flow motion
step (pipeline/motion.measure_step_cached over S streams, with the carried
LK cache), each call timed to the end of its device work (the synchronising
spans of the traced run)."""


def read(trace):
    return trace.spans.mean_ms("motion")
