# Copied from respmon_tpu/io/native.py:1-191 (the loader builds the port's
# own copy of the source; the fleet's collect_latest left out).
"""ctypes bindings for the native host runtime (``csrc/resp_native.cpp``).

Provides the C++ SPSC frame ring and fused color conversions used by the
frame feeder.  The host C++ compiler builds the library on first use
(``ops/_build``, into ``build/respmon_tpu_torch/``); every entry point has a
pure-numpy fallback, so the framework works without a compiler (at reduced
host throughput).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional

import numpy as np

from respmon_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

_lib = None
_lib_lock = threading.Lock()


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = _build.load("resp_native", ".cpp")
        except (OSError, RuntimeError) as e:
            logger.info("native library unavailable: %s", e)
            return None
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int64
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ring_pop.restype = ctypes.c_int64
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ring_pop_latest.restype = ctypes.c_int64
        lib.ring_pop_latest.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_int64
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_dropped.restype = ctypes.c_int64
        lib.ring_dropped.argtypes = [ctypes.c_void_p]
        lib.bgr_u8_to_gray_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64]
        lib.gray_u8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64]
        lib.f32_to_u8_wrap.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64]
        _lib = lib
        return _lib


def bgr_to_gray_f32(bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 (H, W, 3) -> grayscale float32 [0,1] with cv2's
    fixed-point BT.601 rounding."""
    h, w = bgr.shape[:2]
    out = np.empty((h, w), np.float32)
    lib = load_native()
    if lib is not None and bgr.flags["C_CONTIGUOUS"]:
        lib.bgr_u8_to_gray_f32(bgr.ctypes.data, out.ctypes.data, h * w)
        return out
    b = bgr[..., 0].astype(np.uint32)
    g = bgr[..., 1].astype(np.uint32)
    r = bgr[..., 2].astype(np.uint32)
    y = (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
    # Canonical chain (io/capture.py, OpenCVCapture.next_frame): f64
    # multiply then f32 cast — matches the native LUT bit-for-bit on every
    # byte.
    return (y.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)


class FrameRing:
    """SPSC frame ring with drop-oldest live semantics.

    Uses the C++ implementation when available; otherwise a GIL-protected
    numpy ring with identical semantics.
    """

    def __init__(self, capacity: int, frame_shape, dtype=np.float32) -> None:
        self.capacity = capacity
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        # The C ring moves fixed-size float slots; other dtypes ride the
        # same slots as raw bytes (padded up to a float boundary), so e.g.
        # camera-native uint8 frames take 4x less ring memory/bandwidth
        # than float32.
        self._nbytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self._n = (self._nbytes + 3) // 4
        self._lib = load_native()
        if self._lib is not None:
            self._ptr = self._lib.ring_create(capacity, self._n)
            if not self._ptr:  # pragma: no cover
                self._lib = None
        if self._lib is None:
            self._slots = np.zeros((capacity, self._n), np.float32)
            self._seqs = np.zeros(capacity, np.int64)
            self._head = 0
            self._tail = 0
            self._dropped = 0
            self._lock = threading.Lock()

    def _as_slot(self, frame: np.ndarray) -> np.ndarray:
        """Contiguous frame bytes viewed as a full f32 slot."""
        f = np.ascontiguousarray(frame, self.dtype)
        raw = f.view(np.uint8).reshape(-1)
        if raw.size != self._n * 4:
            pad = np.zeros(self._n * 4, np.uint8)
            pad[:raw.size] = raw
            raw = pad
        return raw.view(np.float32)

    def push(self, frame: np.ndarray) -> int:
        f = self._as_slot(frame)
        if self._lib is not None:
            return int(self._lib.ring_push(self._ptr, f.ctypes.data))
        with self._lock:
            seq = self._head
            slot = seq % self.capacity
            self._slots[slot] = f
            self._seqs[slot] = seq
            self._head = seq + 1
            if self._head - self._tail > self.capacity:
                new_tail = self._head - self.capacity
                self._dropped += new_tail - self._tail
                self._tail = new_tail
            return seq

    def _pop(self, latest: bool):
        out = np.empty(self._n, np.float32)
        if self._lib is not None:
            fn = self._lib.ring_pop_latest if latest else self._lib.ring_pop
            seq = int(fn(self._ptr, out.ctypes.data))
        else:
            with self._lock:
                if self._tail >= self._head:
                    return None, -1
                seq = (self._head - 1) if latest else self._tail
                out[:] = self._slots[seq % self.capacity]
                if latest and seq > self._tail:
                    self._dropped += seq - self._tail
                self._tail = self._head if latest else self._tail + 1
        if seq < 0:
            return None, -1
        frame = out.view(np.uint8)[:self._nbytes].view(self.dtype)
        return frame.reshape(self.frame_shape), seq

    def pop(self):
        """Oldest unread frame (FIFO) or (None, -1)."""
        return self._pop(latest=False)

    def pop_latest(self):
        """Newest frame, discarding older (live monitoring) or (None, -1)."""
        return self._pop(latest=True)

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._ptr))
        with self._lock:
            return min(self._head - self._tail, self.capacity)

    @property
    def dropped(self) -> int:
        """Cumulative frames pushed but never delivered (overwritten while
        unread, or skipped over by pop_latest)."""
        if self._lib is not None:
            return int(self._lib.ring_dropped(self._ptr))
        with self._lock:
            return self._dropped

    def __del__(self):  # pragma: no cover
        lib = getattr(self, "_lib", None)
        ptr = getattr(self, "_ptr", None)
        if lib is not None and ptr:
            lib.ring_destroy(ptr)
