# Copied from respmon_tpu/io/faults.py:1-91 (numpy only).
"""Fault-injecting capture wrapper.

The reference has a real error-recovery subsystem but no way to exercise it
deliberately (SURVEY.md §5: "No fault injection exists; rebuild should add
NaN/blackout/occlusion injectors to exercise the state machine").  This
wrapper decorates any CaptureSource with scheduled faults:

  - 'blackout':  frames become zeros (kills optical-flow gradients ->
                 tracking loss -> NaN -> error state),
  - 'noise':     frames become uncorrelated noise,
  - 'occlusion': a rectangle is blanked over the ROI region,
  - 'nan':       frames carry NaNs (sensor dropout),
  - 'freeze':    the last good frame repeats (zero motion).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from respmon_tpu_torch.io.capture import CaptureSource


class FaultSchedule:
    """Inject ``kind`` for frames [start, end) (frame indices)."""

    def __init__(self, kind: str, start: int, end: int,
                 rect: Optional[Tuple[int, int, int, int]] = None,
                 seed: int = 0) -> None:
        assert kind in ("blackout", "noise", "occlusion", "nan", "freeze")
        self.kind = kind
        self.start = start
        self.end = end
        self.rect = rect
        self.rng = np.random.default_rng(seed)

    def active(self, idx: int) -> bool:
        return self.start <= idx < self.end


class FaultInjector:
    def __init__(self, source: CaptureSource,
                 schedules: List[FaultSchedule]) -> None:
        self.source = source
        self.schedules = schedules
        self.fps = source.fps
        self.width = source.width
        self.height = source.height
        self.frame_dtype = np.dtype(getattr(source, "frame_dtype",
                                            np.float32))
        if self.frame_dtype == np.uint8 and any(
                s.kind == "nan" for s in schedules):
            raise ValueError("'nan' faults need float frames; uint8 "
                             "ingest cannot carry NaN (use 'blackout')")
        self._idx = 0
        self._last_good: Optional[np.ndarray] = None

    def next_frame(self):
        frame = self.source.next_frame()
        if frame is None:
            return None
        idx = self._idx
        self._idx += 1
        out = frame
        for s in self.schedules:
            if not s.active(idx):
                continue
            if s.kind == "blackout":
                out = np.zeros_like(out)
            elif s.kind == "noise":
                out = (s.rng.integers(0, 256, out.shape, np.uint8)
                       if out.dtype == np.uint8
                       else s.rng.random(out.shape).astype(out.dtype))
            elif s.kind == "occlusion":
                out = out.copy()
                x, y, w, h = s.rect or (0, 0, out.shape[1], out.shape[0])
                out[y:y + h, x:x + w] = 0.0
            elif s.kind == "nan":
                out = np.full_like(out, np.nan)
            elif s.kind == "freeze" and self._last_good is not None:
                out = self._last_good
        if np.isfinite(out).all():
            self._last_good = out
        return out

    def is_open(self) -> bool:
        return self.source.is_open()

    def release(self) -> None:
        self.source.release()
