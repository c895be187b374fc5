"""localize_ms.fleet: mean milliseconds of one localize of the re-locking
fleet (the program's ``fleet.localize`` span, parallel/streams.py: the
localize of every stream over its rolling rings, pipeline/streaming.
localize_batch, and the host read of the boxes the re-lock decides on),
less the batched absorb of that step that runs inside it (its
``fleet.absorb`` child span). Read from the program's span ring
(respmon_tpu_torch.utils.bench.snapshot), which records while the profiler
runs; nothing where the program has no such ring or span."""


def read(trace):
    try:
        from respmon_tpu_torch.utils.bench import snapshot
    except ImportError:
        return None
    spans = snapshot()
    own = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans
           if s["name"] == "fleet.localize"}
    for s in spans:
        if s["name"] == "fleet.absorb" and s["parent"] in own:
            own[s["parent"]] -= s["end_ns"] - s["start_ns"]
    if not own:
        return None
    return 1e-6 * sum(own.values()) / len(own)
