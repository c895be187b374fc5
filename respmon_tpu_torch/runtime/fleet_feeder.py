# Copied from respmon_tpu/runtime/fleet_feeder.py:1-211 (numpy only).
"""Lockstep multi-stream ingestion for fleet monitoring.

``MultiStreamMonitor.step`` consumes one (S, H, W) batch per lockstep
tick; production sources are S independent cameras/clips.  FleetFeeder is
the host side of that fan-in: one decode thread per source feeds a native
SPSC ring (runtime/feeder.py per stream), and ``next_batch`` assembles
the freshest frame of every stream into ONE persistent contiguous batch —
a single fused (S, H, W) upload per step instead of S frame-sized ones,
with the C++ collector (csrc/resp_native.cpp rings_collect_latest)
doing the S freshest-frame pops + row copies in one call.

The reference is single-camera (its loop blocks on one ``cap.read()``,
base.py:416-421); this is the fleet-scale generalization of that I/O
stage for the multi-stream deployment.

Two lockstep semantics:

- live (``lossless=False``): freshest-frame-wins per stream; a stream
  with nothing new since the last tick keeps (repeats) its previous frame
  and is reported in the ``stale`` mask.  Slow consumers drop old frames
  per stream (counted per stream).
- replay (``lossless=True``): strict FIFO per stream with capture
  backpressure — every frame of every stream is delivered in order
  (reference frame accounting).  Streams that end keep repeating their
  last frame with ``active=False`` until every stream has ended.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from respmon_tpu_torch.io.capture import CaptureSource
from respmon_tpu_torch.io.native import collect_latest
from respmon_tpu_torch.runtime.feeder import FrameFeeder


class FleetBatch(NamedTuple):
    frames: np.ndarray   # (S, H, W) — independent snapshot by default;
    #                      with next_batch(copy=False), a view of the
    #                      persistent buffer valid until the next call
    seqs: np.ndarray     # (S,) int64 per-stream sequence of the row
    stale: np.ndarray    # (S,) bool — row repeats the previous frame
    active: np.ndarray   # (S,) bool — stream has not ended


class FleetFeeder:
    def __init__(self, sources: Sequence[CaptureSource], capacity: int = 4,
                 lossless: bool = False, dtype=np.uint8,
                 fps_limit: Optional[float] = None) -> None:
        assert len(sources) > 0
        self.dtype = np.dtype(dtype)
        h, w = sources[0].height, sources[0].width
        for s in sources:
            assert (s.height, s.width) == (h, w), \
                "fleet sources must share one frame shape"
        self.frame_shape = (h, w)
        self.lossless = bool(lossless)
        self.feeders = [FrameFeeder(s, capacity=capacity, lossless=lossless,
                                    fps_limit=fps_limit, dtype=self.dtype)
                        for s in sources]
        self._rings = [f.ring for f in self.feeders]
        n_floats = self._rings[0]._n
        self._nbytes = h * w * self.dtype.itemsize
        s_count = len(sources)
        # Persistent batch: stale/ended rows keep their previous content.
        self._buf = np.zeros((s_count, n_floats), np.float32)
        self._scratch_seqs = np.empty(s_count, np.int64)
        self._seqs = np.full(s_count, -1, np.int64)
        self._active = np.ones(s_count, bool)
        # Streams already holding THIS tick's frame (persists across a
        # TimeoutError retry; cleared when a batch is returned).
        self._tick_fresh = np.zeros(s_count, bool)
        if self._nbytes == n_floats * 4:
            # Frame bytes fill the f32 slots exactly -> zero-copy batch view.
            self._frames = self._buf.view(self.dtype).reshape(
                (s_count, h, w))
        else:  # padded slots (nbytes % 4 != 0): per-row strided view
            self._frames = self._buf.view(np.uint8)[:, :self._nbytes] \
                .view(self.dtype).reshape((s_count, h, w))

    def start(self) -> "FleetFeeder":
        for f in self.feeders:
            f.start()
        return self

    # -- lockstep assembly ------------------------------------------------

    def _row_write(self, i: int, frame: np.ndarray) -> None:
        raw = np.ascontiguousarray(frame, self.dtype).view(np.uint8) \
            .reshape(-1)
        self._buf[i].view(np.uint8)[:raw.size] = raw

    def _finish_tick(self, copy: bool) -> FleetBatch:
        fresh = self._tick_fresh
        self._tick_fresh = np.zeros(len(self.feeders), bool)
        return FleetBatch(frames=self._frames.copy() if copy
                          else self._frames, seqs=self._seqs.copy(),
                          stale=~fresh, active=self._active.copy())

    def _next_live(self, deadline: float, copy: bool) -> Optional[FleetBatch]:
        # ``self._tick_fresh`` accumulates until a batch is RETURNED (it
        # survives a TimeoutError retry): a row is stale only if nothing
        # new arrived since the last delivered batch.
        while True:
            collect_latest(self._rings, self._buf, self._scratch_seqs)
            got = self._scratch_seqs >= 0
            np.copyto(self._seqs, self._scratch_seqs, where=got)
            self._tick_fresh |= got
            ended = np.asarray([f.ended for f in self.feeders])
            self._active = ~ended
            started = self._seqs >= 0
            if started.all() and (self._tick_fresh.any() or ended.all()):
                if not self._tick_fresh.any() and ended.all():
                    return None  # every stream ended, nothing new
                return self._finish_tick(copy)
            if ended.all() and not started.all():
                return None  # some stream ended before its first frame
            if time.time() > deadline:
                raise TimeoutError(
                    "fleet live tick stalled past the deadline (frames "
                    "already collected stay pending; retry continues the "
                    "same tick)")
            time.sleep(0.0005)

    def _next_lossless(self, deadline: float,
                       copy: bool) -> Optional[FleetBatch]:
        # ``self._tick_fresh[i]`` marks streams whose FIFO frame for THIS
        # tick is already in the buffer — a TimeoutError retry resumes the
        # same tick without re-popping them (no skipped frames, no mixed
        # ticks).
        for i, f in enumerate(self.feeders):
            if not self._active[i] or self._tick_fresh[i]:
                continue
            frame, seq = f.next_frame(
                latest=False, timeout=max(deadline - time.time(), 0.001))
            if frame is None:
                if f.ended:
                    self._active[i] = False
                    continue
                raise TimeoutError(
                    f"fleet lossless tick stalled on stream {i} (frames "
                    "already collected stay pending; retry continues the "
                    "same tick)")
            self._row_write(i, frame)
            self._seqs[i] = seq
            self._tick_fresh[i] = True
        if not self._tick_fresh.any():
            return None  # all streams ended
        if not (self._seqs >= 0).all():
            return None  # a stream ended before its first frame
        return self._finish_tick(copy)

    def next_batch(self, timeout: float = 5.0,
                   copy: bool = True) -> Optional[FleetBatch]:
        """Assemble the next lockstep batch; None means the fleet ENDED
        (a stall past ``timeout`` raises TimeoutError instead, and a retry
        resumes the same tick — no frames are lost or mixed across ticks).

        The first batch blocks until EVERY stream has delivered a frame
        (no uninitialized rows).  ``copy=True`` (default) returns an
        independent snapshot.  ``copy=False`` returns a VIEW of the
        persistent batch buffer — zero-copy, but the next ``next_batch``
        call overwrites it, and ``torch.from_numpy`` (or a CPU-device
        step) aliases the host buffer while the step still reads it:
        only pass ``copy=False`` when the consumer fully reads the batch
        (e.g. an explicit host copy or a synchronous device transfer)
        before the next call.
        """
        deadline = time.time() + timeout
        if self.lossless:
            return self._next_lossless(deadline, copy)
        return self._next_live(deadline, copy)

    def collect_buffer(self, t: int,
                       timeout: float = 5.0) -> Optional[np.ndarray]:
        """Stack ``t`` lockstep ticks into a (S, t, H, W) buffer — the
        ingest for fleet (re)calibration (``MultiStreamMonitor.calibrate``
        / ``recalibrate`` take exactly this shape, camera-native u8).

        Lossless mode yields ``t`` consecutive frames per stream; live
        mode the freshest frame at each of ``t`` ticks (stale rows repeat,
        as in ``next_batch``).  Returns None if the fleet ends first.
        """
        out = np.empty((len(self.feeders), t) + self.frame_shape,
                       self.dtype)
        for k in range(t):
            # copy=False is safe: out[:, k] fully reads the row before the
            # next call overwrites the shared buffer.
            b = self.next_batch(timeout=timeout, copy=False)
            if b is None:
                return None
            out[:, k] = b.frames
        return out

    # -- observability / lifecycle ----------------------------------------

    @property
    def dropped(self) -> np.ndarray:
        """Per-stream cumulative frames captured but never delivered."""
        return np.asarray([f.dropped for f in self.feeders], np.int64)

    @property
    def ended(self) -> bool:
        return all(f.ended for f in self.feeders)

    def stop(self) -> None:
        for f in self.feeders:
            f.stop()
