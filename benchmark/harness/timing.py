"""Spans around the program's layers, the device trace and the yardstick
of peaks and bounds.

``Spans`` wraps module functions of the program, as ``chip_smoke.py``'s
``split_timer`` does (chip_smoke.py:1089-1178): in ``"time"`` mode each
call ends in a device synchronise and its seconds are kept by span name;
in ``"trace"`` mode each call is a ``torch.profiler.record_function``
range and nothing synchronises, so that the trace's idle gaps can be
labelled with the span the host was in.  ``reduce_profile`` turns a
``torch.profiler`` run into busy seconds, kernel seconds by name and idle
seconds by span.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet), chip_smoke.py:79-82.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# The kernels of K1 (respmon_tpu_torch/csrc/pyramid.cu), by the names the
# device trace gives them.
K1_KERNELS = ("pyr_down_levels", "pyr_tail", "lap_level")


# Copied from chip_smoke.py:172-180.
def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes that
    must move (every input read once, every output written once) over the
    memory rate and the operations over the float32 rate."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _pyramid_shapes(h: int, w: int, levels: int):
    shapes = [(h, w)]
    for _ in range(1, levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


# Copied from chip_smoke.py:1378-1386, with the pyramid's shapes worked
# out here: it depends on the call's shapes only.
def k1_bound(t_len: int, h: int, w: int, levels: int, skip: int) -> dict:
    """The bound of one K1 call: the float32 frames read once and the kept
    levels written once; 54 operations per pyrDown output of every level,
    17 per kept Laplacian output."""
    sizes = [t_len * hh * ww for hh, ww in _pyramid_shapes(h, w, levels)]
    kept = sum(sizes[skip:levels - 1])
    return bound(4 * (sizes[0] + kept), 54 * sum(sizes[1:]) + 17 * kept)


class Spans:
    """Wrap ``(module, attribute, span)`` functions for the ``with`` block.

    ``"time"``: each call synchronises the device at its end and its
    seconds go to ``seconds[span]``.  ``"trace"``: each call runs inside
    ``record_function("span:<name>")``.  In both, ``calls[span]`` keeps
    what ``notes[span]`` (where given) reads off each call's arguments."""

    def __init__(self, mode: str, targets, notes: Optional[Dict] = None):
        if mode not in ("time", "trace"):
            raise ValueError(mode)
        self.mode = mode
        self.targets = list(targets)
        self.notes = notes or {}
        self.seconds: Dict[str, List[float]] = {}
        self.calls: Dict[str, list] = {}
        self._saved = []

    def _wrap(self, fn: Callable, span: str) -> Callable:
        note = self.notes.get(span)
        sync = self.mode == "time"
        cuda = torch.cuda.is_available()

        def wrapped(*args, **kwargs):
            if note is not None:
                self.calls.setdefault(span, []).append(note(*args, **kwargs))
            if not sync:
                with torch.profiler.record_function("span:" + span):
                    return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
            self.seconds.setdefault(span, []).append(time.perf_counter() - t0)
            return out
        return wrapped

    def __enter__(self):
        for module, name, span in self.targets:
            fn = getattr(module, name)
            self._saved.append((module, name, fn))
            setattr(module, name, self._wrap(fn, span))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved = []
        return False

    def mean_ms(self, span: str) -> Optional[float]:
        v = self.seconds.get(span)
        return 1e3 * sum(v) / len(v) if v else None


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def _merge(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


WINDOW = "bench:window"


def reduce_profile(prof) -> dict:
    """From a finished ``torch.profiler.profile`` whose traced stretch ran
    inside ``record_function(WINDOW)``: the device's busy seconds in that
    window (the union of every kernel, copy and set on the device), the
    seconds of each kernel by name, the idle gaps between busy stretches
    labelled with the innermost ``span:`` range open on the host at the
    gap's start ("host" where none is), and the window's seconds.  Reads
    the trace's raw events (``kineto_results``), not ``prof.events()``,
    whose tree of host operations takes minutes to build for a fleet
    step's launches."""
    device_events, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        ours = name == WINDOW or name.startswith("span:")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The trace mirrors record_function ranges on the device's
            # timeline; they are not device work.
            if not ours and not e.is_user_annotation():
                device_events.append((a, b, name))
        elif name.startswith("span:"):
            spans.append((a, b, name[5:]))
        elif name == WINDOW:
            window = (a, b)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    t0_us, t1_us = window
    by_kernel: Dict[str, float] = {}
    for a, b, name in device_events:
        if b <= t0_us or a >= t1_us:
            continue
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) * 1e-6
    busy = _merge([(max(a, t0_us), min(b, t1_us))
                   for a, b, _ in device_events if b > t0_us and a < t1_us])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], t0_us
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1_us > prev:
        gaps.append((prev, t1_us))
    spans.sort()
    starts = [sa for sa, _, _ in spans]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        label = "host"
        # The innermost open span: the latest-starting one that has not
        # ended at the gap's start.
        for k in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if spans[k][1] > a:
                label = spans[k][2]
                break
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy_s, "window_s": (t1_us - t0_us) * 1e-6,
            "kernels_s": by_kernel, "idle_s": idle,
            "device_events": len(device_events)}


def k1_seconds(kernels_s: Dict[str, float]) -> float:
    """Device seconds of K1's kernels in a reduced profile."""
    return sum(s for name, s in kernels_s.items()
               if any(k in name for k in K1_KERNELS))
