# Copied from respmon_tpu/io/capture.py:1-108 (numpy only; cv2 imported
# inside OpenCVCapture).
"""Host-side frame capture sources.

The reference reads frames with ``cv2.VideoCapture`` + BGR→gray + uint8→float
(base.py:46-51, 227-233).  Capture stays host-side and native
(SURVEY.md §2.1): OpenCV's C++ decoders feed grayscale float frames into the
device pipeline.  An in-memory array source makes recorded-clip replay and
synthetic-fixture testing first-class (the reference's de-facto test
strategy, SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np


class CaptureSource(Protocol):
    fps: float
    width: int
    height: int

    def next_frame(self) -> Optional[np.ndarray]:
        """Grayscale float frame in [0, 1], or None at end of stream."""
        ...

    def is_open(self) -> bool: ...

    def release(self) -> None: ...


class OpenCVCapture:
    """cv2.VideoCapture-backed source (webcam index or file path), with the
    reference's probe semantics: fps==0 -> NaN for downstream detection
    (base.py:108-110).

    ``native_uint8=True`` returns the gray frame as camera-native uint8
    instead of the reference's host conversion chain (base.py:230-233) —
    the monitor then ships bytes to the device (4x less upload/staging)
    and widens on the exact [0,255] lattice there
    (``ops/dtype.uint8_to_float``, bit-exact to this host chain), so
    results are bit-identical to float ingest."""

    def __init__(self, target, native_uint8: bool = False) -> None:
        import cv2

        self.target = target
        self._cap = cv2.VideoCapture(target)
        fps = int(self._cap.get(cv2.CAP_PROP_FPS))
        self.fps = float("nan") if fps == 0 else float(fps)
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._cv2 = cv2
        self.native_uint8 = bool(native_uint8)
        self.frame_dtype = np.dtype(np.uint8 if native_uint8
                                    else np.float64)

    def next_frame(self) -> Optional[np.ndarray]:
        ret, frame = self._cap.read()
        if frame is None or ret is False:
            return None
        gray = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY)
        if self.native_uint8:
            return gray
        return gray.astype(np.float64) * (1.0 / 255.0)

    def is_open(self) -> bool:
        return bool(self._cap.isOpened())

    def release(self) -> None:
        self._cap.release()


class ArrayCapture:
    """Replay a preloaded (T, H, W) float array as a capture source."""

    def __init__(self, frames: np.ndarray, fps: float = float("nan"),
                 target: str = "array") -> None:
        assert frames.ndim == 3, "frames must be (T, H, W)"
        self.frames = frames
        self.fps = float(fps)
        self.height = int(frames.shape[1])
        self.width = int(frames.shape[2])
        self.target = target
        self.frame_dtype = frames.dtype
        self._idx = 0
        self._open = True

    def next_frame(self) -> Optional[np.ndarray]:
        if self._idx >= len(self.frames):
            return None
        f = self.frames[self._idx]
        self._idx += 1
        return f

    def is_open(self) -> bool:
        return self._open and self._idx <= len(self.frames)

    def release(self) -> None:
        self._open = False


def open_capture(target, fps: float | None = None,
                 native_uint8: bool = False) -> CaptureSource:
    """Factory: numpy arrays replay in-memory; ints/paths go through OpenCV."""
    if isinstance(target, np.ndarray):
        return ArrayCapture(target, fps=float("nan") if fps is None else fps)
    return OpenCVCapture(target, native_uint8=native_uint8)
