"""The port's tag timer (``utils/bench``) against the JAX package's."""

import os

import torch

from respmon_tpu.utils.bench import Benchmarker as JBenchmarker
from respmon_tpu_torch.utils.bench import (Benchmarker, profiler_trace,
                                           wait_for)

torch.set_num_threads(1)


def test_report_matches_the_jax_package():
    ours, theirs = Benchmarker(), JBenchmarker()
    for b in (ours, theirs):
        for tag in ("Measurement Loop", "Frame Capture", "Empty"):
            b.add_tag(tag)
        for tag, seconds in (("Measurement Loop", [0.25, 0.5]),
                             ("Frame Capture", [0.125])):
            b.ticks[tag].extend(seconds)
    assert ours.get_report() == theirs.get_report()
    assert ours.has_tag("Empty") and not ours.has_tag("missing")


def test_tick_and_device_tick_record_one_time_each():
    b = Benchmarker()
    b.add_tag("a")
    b.tick_start("a")
    b.tick_end("a")
    held = []
    with b.device_tick("b", held):
        held.append(torch.ones(3) * 2)
    with b.device_tick("b"):
        pass
    assert len(b.ticks["a"]) == 1 and len(b.ticks["b"]) == 2
    assert all(t >= 0 for t in b.ticks["a"] + b.ticks["b"])
    # CPU tensors, nested containers and non-tensors need no wait.
    wait_for({"x": [torch.zeros(1), (torch.ones(1), None)], "y": 3})


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(None):
        torch.ones(4).sum()
    log_dir = str(tmp_path / "trace")
    with profiler_trace(log_dir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(f.endswith(".json") for f in os.listdir(log_dir))
