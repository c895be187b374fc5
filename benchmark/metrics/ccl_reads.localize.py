"""ccl_reads.localize: host reads of the connected-component searches per
localize of the re-locking fleet: the ``sweeps`` of the ``locate.ccl``
spans (ops/ccl, one host read a sweep; one search a stream) under each of
the program's ``fleet.localize`` spans, summed, averaged over the profiled
stretch's localizes. Read from the program's span ring
(respmon_tpu_torch.utils.bench.snapshot); nothing where the program has no
such ring or span."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    spans = snapshot()
    by_id = {s["id"]: s for s in spans}
    reads = {s["id"]: 0 for s in spans if s["name"] == "fleet.localize"}
    for s in spans:
        if s["name"] != "locate.ccl":
            continue
        up = s["parent"]
        while up is not None and up not in reads:
            up = by_id[up]["parent"] if up in by_id else None
        if up is not None:
            reads[up] += s["counts"]["sweeps"]
    if not reads:
        return None
    return sum(reads.values()) / len(reads)
