"""estimate_ms.cam: mean milliseconds of one call of the BPM estimate
(pipeline/bpm.estimate_bpm, its Gaussian LM fits in ops/gaussfit) of the
single monitor, each call timed to the end of its device work (the
synchronising spans of the traced run)."""


def read(trace):
    return trace.spans.mean_ms("estimate")
