# Copied from respmon_tpu/utils/bench.py:1-74 (device waits through torch).
"""Wall-clock tag profiler + device-aware timing helpers, and the
program's spans.

Mirrors the reference's ``Benchmarker`` API (tools.py:60-82: named tags,
tick_start/tick_end, CSV-ish mean-time report) so the monitor can log the
same three phase tags (base.py:410-412) — and extends it with a
``device_tick`` context manager that waits for a result's CUDA device so
device kernels are timed honestly, plus an optional ``torch.profiler``
trace hook.

The spans: ``span(name, **counts)`` brackets a stretch of the program's
host code (``monitor.step``, ``bpm.lm_step``, ...).  Recording is off
unless ``enable()`` was called or a ``torch.profiler`` is recording; off,
a span is one check and records nothing.  On, each span keeps its name,
its id, its parent's and its root's ids, its start and end and its counts
in a bounded ring (``snapshot()``), and opens
``torch.profiler.record_function("span:<name>")``, so that a profiler's
timeline carries it beside the kernels it launched.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


def wait_for(result) -> None:
    """Wait until the device has computed ``result`` (a tensor, or a tuple,
    list or dict of them): synchronise the CUDA device of each CUDA tensor;
    a CPU tensor is ready when its op returns."""
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
    ``log_dir`` is None).  The program's spans record while it runs, so
    the timeline carries them as ``span:<name>`` ranges."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


# ---------------------------------------------------------------------------
# The program's spans
# ---------------------------------------------------------------------------

# Records the ring keeps: the newest RING finished spans.
RING = 65536

_enabled = False
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """What ``span`` gives while recording is off: a context manager that
    does nothing, and a record whose counts go nowhere."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    """One span while recording is on: its own record."""

    __slots__ = ("name", "counts", "id", "parent", "step", "offset", "start",
                 "end", "_mirror")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def set(self, **counts) -> None:
        """Set counts of this span (kept when it ends)."""
        self.counts.update(counts)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.step, self.offset = top.id, top.step, top.offset
        else:
            # A root: its tree shares one offset from this clock to the
            # device trace's (Unix-epoch ns, as kineto's events give it).
            self.parent, self.step = None, self.id
            self.offset = time.time_ns() - time.perf_counter_ns()
        self._mirror = torch.profiler.record_function("span:" + self.name)
        self._mirror.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        self._mirror.__exit__(*exc)
        # Both clock reads follow the mirror's own (record_function takes
        # its time before it returns), so the two agree to microseconds.
        self.end = time.perf_counter_ns()
        self._mirror = None
        _ring.append(self)
        return False


def span(name: str, **counts):
    """A context manager around a stretch of the program, giving its record
    (``.set(**counts)`` sets counts on the way).  Off (neither ``enable()``
    nor a recording ``torch.profiler``), it records nothing."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, counts)


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a ``torch.profiler`` records."""
    global _enabled
    _enabled = False


def snapshot() -> List[dict]:
    """The finished spans in the ring, oldest end first, as plain dicts:
    ``name``, ``id``, ``parent`` (None for a root), ``step`` (the root's
    id), ``start_ns`` and ``end_ns`` on the device trace's clock, and
    ``counts``."""
    return [{"name": r.name, "id": r.id, "parent": r.parent, "step": r.step,
             "start_ns": r.start + r.offset, "end_ns": r.end + r.offset,
             "counts": dict(r.counts)} for r in list(_ring)]


def clear() -> None:
    """Empty the ring."""
    _ring.clear()
