# Copied from respmon_tpu/io/recorder.py:1-77 (numpy only; cv2 imported
# when the first frame is written).
"""Session recording: cropped-ROI video + (t, motion) trace.

Byte-compatible with the reference's ``save_all_data`` outputs
(base.py:465-468, 486-488, 511-513): an AVI of the cropped ROI written with
the 'MSVC' fourcc at the detected fps, and ``<target>.npy`` holding the
``(t, motion_value)`` pairs; both released/flushed at stream end or reset.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class _NullWriter:
    def write(self, frame) -> None:
        pass

    def release(self) -> None:
        pass


class SessionRecorder:
    def __init__(self, target, fps: float, roi_wh: Tuple[int, int]) -> None:
        self.target = target
        self.fps = fps
        self.roi_wh = roi_wh
        self._writer = None
        self.all_data: List[Tuple[float, float]] = []

    def _ensure_writer(self):
        if self._writer is None:
            import logging

            import cv2

            # The reference writes 'MSVC' (Microsoft Video 1, base.py:466),
            # which Linux ffmpeg builds cannot encode; fall back through
            # portable codecs so recording works everywhere.
            path = str(self.target) + ".avi"
            for fourcc in ("MSVC", "MJPG", "XVID"):
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*fourcc), self.fps,
                    self.roi_wh)
                if writer.isOpened():
                    if fourcc != "MSVC":
                        logging.getLogger(__name__).info(
                            "MSVC codec unavailable; recording with %s",
                            fourcc)
                    self._writer = writer
                    break
                writer.release()
            if self._writer is None:  # pragma: no cover
                logging.getLogger(__name__).warning(
                    "no usable AVI codec; video recording disabled")
                self._writer = _NullWriter()
        return self._writer

    def write(self, cropped_u8: np.ndarray, t: float, motion: float) -> None:
        """cropped_u8: (h, w) uint8 ROI crop (the reference writes
        float_to_uint8(cropped), base.py:487).  VideoWriter silently drops
        2-D frames, so grayscale is expanded to BGR before writing."""
        writer = self._ensure_writer()
        if cropped_u8.ndim == 2:
            cropped_u8 = np.repeat(cropped_u8[:, :, None], 3, axis=2)
        writer.write(np.ascontiguousarray(cropped_u8))
        self.all_data.append((t, motion))

    def release_video(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def finalize(self) -> None:
        self.release_video()
        np.save(str(self.target) + ".npy", np.asarray(self.all_data))
