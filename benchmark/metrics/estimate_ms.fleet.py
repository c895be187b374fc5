"""estimate_ms.fleet: mean milliseconds of one call of the fleet's BPM estimate
(pipeline/bpm.estimate_bpm over the S rings, its LM fits in ops/gaussfit),
each call timed to the end of its device work (the synchronising spans of
the traced run)."""


def read(trace):
    return trace.spans.mean_ms("estimate")
