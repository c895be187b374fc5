"""locate_ms: mean milliseconds of one call of a calibration
(pipeline/evm.locate: K1, the bandpass, the collapse, the CCL), each call
timed to the end of its device work (the synchronising spans of the traced
run)."""


def read(trace):
    return trace.spans.mean_ms("locate")
