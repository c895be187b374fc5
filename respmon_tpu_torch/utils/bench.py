# Copied from respmon_tpu/utils/bench.py:1-74 (device waits through torch).
"""Wall-clock tag profiler + device-aware timing helpers.

Mirrors the reference's ``Benchmarker`` API (tools.py:60-82: named tags,
tick_start/tick_end, CSV-ish mean-time report) so the monitor can log the
same three phase tags (base.py:410-412) — and extends it with a
``device_tick`` context manager that waits for a result's CUDA device so
device kernels are timed honestly, plus an optional ``torch.profiler``
trace hook.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np


def wait_for(result) -> None:
    """Wait until the device has computed ``result`` (a tensor, or a tuple,
    list or dict of them): synchronise the CUDA device of each CUDA tensor;
    a CPU tensor is ready when its op returns."""
    import torch

    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            wait_for(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            wait_for(v)


class Benchmarker:
    """Named-tag wall-clock timer (reference tools.py:60-82 API)."""

    def __init__(self) -> None:
        self.starts: Dict[str, float] = {}
        self.ticks: Dict[str, List[float]] = {}

    def add_tag(self, tag: str) -> None:
        self.ticks[tag] = []

    def has_tag(self, tag: str) -> bool:
        return tag in self.ticks

    def tick_start(self, tag: str) -> None:
        self.starts[tag] = time.time()

    def tick_end(self, tag: str) -> None:
        self.ticks[tag].append(time.time() - self.starts[tag])

    def get_report(self) -> str:
        rows = [
            "{0}, {1}, {2}".format(tag, np.mean(vals) if vals else np.nan,
                                   len(vals))
            for tag, vals in self.ticks.items()
        ]
        return "Tag, Average Time (seconds), Iterations\r\n" + \
            "\r\n".join(rows)

    @contextlib.contextmanager
    def device_tick(self, tag: str, result_holder=None):
        """Bracket a device computation; waits for the result so the timing
        covers actual execution, not the launch."""
        if tag not in self.ticks:
            self.add_tag(tag)
        self.tick_start(tag)
        try:
            yield
        finally:
            if result_holder is not None:
                wait_for(result_holder)
            self.tick_end(tag)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optional ``torch.profiler`` trace of the CPU and, where there is one,
    the CUDA device, written to ``log_dir`` for TensorBoard (no-op when
    ``log_dir`` is None)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
