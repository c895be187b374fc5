"""The port's FleetFeeder (``respmon_tpu_torch/runtime/fleet_feeder.py``):
the six tests of ``tests/test_fleet_feeder.py``, run against the port's
feeder and its ``MultiStreamMonitor`` on the CPU, and the C++ freshest-frame
collector (``csrc/resp_native.cpp`` ``rings_collect_latest``) against the
per-ring Python loop.
"""

import time

import numpy as np
import pytest

from respmon_tpu_torch.io import native as native_mod
from respmon_tpu_torch.io.capture import ArrayCapture
from respmon_tpu_torch.runtime.fleet_feeder import FleetFeeder

S, T, H, W = 4, 12, 24, 32


def _clips(t=T, seed=0):
    rng = np.random.default_rng(seed)
    # Per-stream recognizable content: stream s, frame i pixel [0,0] = coded
    clips = rng.integers(0, 255, (S, t, H, W), dtype=np.uint8)
    for s in range(S):
        for i in range(t):
            clips[s, i, 0, 0] = s * 50 + i
    return clips


def _sources(clips):
    # Ring-dtype contract (same as FrameFeeder): sources yield frames
    # already on the ring dtype's scale — u8 rings take u8 frames.
    return [ArrayCapture(c, fps=10.0) for c in clips]


@pytest.mark.parametrize("backend", ["native", "python"])
def test_lossless_lockstep_replays_every_frame(backend, monkeypatch):
    if backend == "python":
        monkeypatch.setattr(native_mod, "load_native", lambda: None)
    clips = _clips()
    fleet = FleetFeeder(_sources(clips), capacity=3, lossless=True,
                        dtype=np.uint8).start()
    got = []
    while True:
        b = fleet.next_batch(timeout=10.0)
        if b is None:
            break
        assert b.frames.shape == (S, H, W) and b.frames.dtype == np.uint8
        assert b.stale.sum() == 0 and b.active.all()
        # no .copy(): default batches are independent snapshots — later
        # ticks must not mutate earlier ones.
        got.append(b.frames)
    fleet.stop()
    assert len(got) == T
    for i, frames in enumerate(got):
        np.testing.assert_array_equal(frames, clips[:, i])
    assert (fleet.dropped == 0).all()


def test_lossless_unequal_lengths_marks_inactive():
    clips = _clips()
    sources = [ArrayCapture(clips[s, :T - 6 if s == 1 else T], fps=10.0)
               for s in range(S)]
    fleet = FleetFeeder(sources, capacity=3, lossless=True,
                        dtype=np.uint8).start()
    batches = []
    while True:
        b = fleet.next_batch(timeout=10.0)
        if b is None:
            break
        batches.append((b.frames.copy(), b.active.copy(), b.stale.copy()))
    fleet.stop()
    assert len(batches) == T
    for i, (frames, active, stale) in enumerate(batches):
        if i < T - 6:
            assert active.all() and not stale.any()
            np.testing.assert_array_equal(frames, clips[:, i])
        else:
            assert not active[1] and stale[1] and active[[0, 2, 3]].all()
            # Ended stream repeats its last frame; others advance.
            np.testing.assert_array_equal(frames[1], clips[1, T - 7])
            np.testing.assert_array_equal(frames[0], clips[0, i])


def test_live_freshest_wins_and_counts_drops():
    clips = _clips(t=40)
    # Producers paced at ~200 fps vs a ~50 fps consumer: freshest-wins
    # must skip (and count) frames the slow consumer never saw.
    fleet = FleetFeeder(_sources(clips), capacity=3, lossless=False,
                        dtype=np.uint8, fps_limit=200.0).start()
    batches = []
    while True:
        b = fleet.next_batch(timeout=10.0)
        if b is None:   # all clips exhausted
            break
        batches.append((b.frames.copy(), b.seqs.copy()))
        time.sleep(0.02)
    fleet.stop()
    assert len(batches) >= 2
    for frames, seqs in batches:
        for s in range(S):
            i = int(frames[s, 0, 0]) - s * 50  # frame idx encoded at [0,0]
            assert i == seqs[s], (s, i, seqs[s])
    # Monotone per-stream sequences, and strictly fewer batches than
    # frames -> some frames were skipped and counted dropped.
    seq_mat = np.stack([s for _, s in batches])
    assert (np.diff(seq_mat, axis=0) >= 0).all()
    assert len(batches) < 40
    assert fleet.dropped.sum() > 0


def test_live_batch_feeds_fleet_monitor_step():
    # End-to-end: FleetFeeder u8 batches drive MultiStreamMonitor.step.
    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.parallel import streams as streams_mod

    cfg = MonitorConfig(calibration=CalibrationConfig(
        buffer_length=16, pyramid_levels=3, skip_levels_at_top=1))
    clips = np.stack([
        breathing_clip(num_frames=24, height=H, width=W, fps=10.0, bpm=20.0,
                       patch_center=(12, 16), patch_size=(8, 10),
                       amplitude=0.25, seed=s)
        for s in range(S)])
    u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)

    mon = streams_mod.MultiStreamMonitor(cfg, None, (H, W), 10.0,
                                         device="cpu")
    mon.calibrate(u8[:, :16])

    fleet = FleetFeeder(
        [ArrayCapture(c[16:], fps=10.0) for c in u8],
        capacity=4, lossless=True, dtype=np.uint8).start()
    steps = 0
    res = None
    while True:
        b = fleet.next_batch(timeout=10.0)
        if b is None:
            break
        res = mon.step(b.frames, stale=b.stale)
        steps += 1
    fleet.stop()
    assert steps == 8 and mon.stale_rows == 0
    assert res.samples.shape == (S,)
    assert res.samples.isfinite().all()


def test_collect_buffer_feeds_fleet_calibration():
    # (S, T, H, W) calibration ingest straight from the feeder: lossless
    # collection reproduces the exact leading frames, and the buffer is
    # what MultiStreamMonitor.calibrate consumes (camera-native u8).
    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.parallel import streams as streams_mod

    cfg = MonitorConfig(calibration=CalibrationConfig(
        buffer_length=16, pyramid_levels=3, skip_levels_at_top=1))
    clips = np.stack([
        breathing_clip(num_frames=20, height=H, width=W, fps=10.0, bpm=20.0,
                       patch_center=(12, 16), patch_size=(8, 10),
                       amplitude=0.25, seed=s)
        for s in range(S)])
    u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)

    fleet = FleetFeeder([ArrayCapture(c, fps=10.0) for c in u8],
                        capacity=4, lossless=True, dtype=np.uint8).start()
    buf = fleet.collect_buffer(16, timeout=10.0)
    fleet.stop()
    assert buf is not None and buf.shape == (S, 16, H, W)
    np.testing.assert_array_equal(buf, u8[:, :16])

    mon = streams_mod.MultiStreamMonitor(cfg, None, (H, W), 10.0,
                                         device="cpu")
    loc = mon.calibrate(buf)
    assert loc.found.all()


def test_lossless_stall_raises_and_retry_resumes_tick():
    # A transient stall past the deadline raises TimeoutError (NOT the
    # None end-of-fleet signal), and a retry resumes the SAME tick: frames
    # popped from faster streams before the stall stay pending, so no
    # frame is skipped and no batch mixes ticks.
    class StallSource:
        def __init__(self, frames, stall_at, stall_s):
            self._f, self._i = frames, 0
            self._at, self._s = stall_at, stall_s
            self.fps, self.height, self.width = 10.0, H, W

        def next_frame(self):
            if self._i >= len(self._f):
                return None
            if self._i == self._at:
                time.sleep(self._s)
            f = self._f[self._i]
            self._i += 1
            return f

        def is_open(self):
            return True

        def release(self):
            pass

    base = np.arange(H * W, dtype=np.uint8).reshape(H, W)
    clips = [base[None] + np.arange(5, dtype=np.uint8)[:, None, None] * 10
             + s for s in range(2)]
    fleet = FleetFeeder([StallSource(clips[0], 99, 0),
                         StallSource(clips[1], 2, 0.5)],
                        capacity=2, lossless=True, dtype=np.uint8).start()
    got, timeouts = [], 0
    while True:
        try:
            b = fleet.next_batch(timeout=0.15)
        except TimeoutError:
            timeouts += 1
            continue
        if b is None:
            break
        got.append(b.frames.copy())
    fleet.stop()
    assert timeouts >= 1
    assert len(got) == 5
    for i, fr in enumerate(got):
        np.testing.assert_array_equal(fr[0], clips[0][i])
        np.testing.assert_array_equal(fr[1], clips[1][i])


def test_native_collect_latest_equals_the_python_loop(monkeypatch):
    # The C++ collector and the per-ring Python loop leave the same batch
    # and sequences: rows of rings with nothing new keep their content.
    from respmon_tpu_torch.io.native import FrameRing, collect_latest

    assert native_mod.load_native() is not None, "the host c++ builds it"
    clips = _clips()
    out = {}
    for backend in ("native", "python"):
        if backend == "python":
            monkeypatch.setattr(native_mod, "load_native", lambda: None)
        rings = [FrameRing(3, (H, W), np.uint8) for _ in range(S)]
        assert all((r._lib is not None) == (backend == "native")
                   for r in rings)
        batch = np.full((S, rings[0]._n), 7.0, np.float32)
        seqs = np.empty(S, np.int64)
        trace = []
        for k in range(4):
            for s in range(S):
                if (s + k) % 3:       # some rings get nothing this tick
                    for i in range(k + s % 2 + 1):
                        rings[s].push(clips[s, (k + i) % T])
            before = native_mod.NATIVE_COLLECTS
            collect_latest(rings, batch, seqs)
            assert native_mod.NATIVE_COLLECTS - before == \
                (backend == "native")
            trace.append((batch.copy(), seqs.copy()))
        out[backend] = trace
        monkeypatch.undo()
    for (bn, sn), (bp, sp) in zip(out["native"], out["python"]):
        np.testing.assert_array_equal(sn, sp)
        np.testing.assert_array_equal(bn, bp)
    assert (out["native"][-1][1] == -1).any()
