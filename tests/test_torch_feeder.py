"""The port's frame feeder and native ring (``io/native``, built from
``respmon_tpu_torch/csrc/resp_native.cpp`` into ``build/``): the tests of
``tests/test_feeder_native.py`` and ``tests/test_feeder_monitor.py`` for the
port, and its conversions against the JAX package's."""

import threading
import time

import numpy as np
import pytest
import torch

from respmon_tpu.io import native as jnative
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops.dtype import float_to_uint8 as jfloat_to_uint8
from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io import native as tnative
from respmon_tpu_torch.io.capture import ArrayCapture
from respmon_tpu_torch.io.native import (FrameRing, bgr_to_gray_f32,
                                         load_native)
from respmon_tpu_torch.ops import _build
from respmon_tpu_torch.runtime import RespiratoryMonitor
from respmon_tpu_torch.runtime.feeder import FrameFeeder

torch.set_num_threads(1)

FPS = 10.0
BPM_TRUE = 18.0
H, W = 120, 160
SMALL_CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                              skip_levels_at_top=2)


def test_native_library_builds_from_the_port_copy():
    lib = load_native()
    assert lib is not None, "native library failed to build/load"
    path = _build.library_path("resp_native", ".cpp")
    assert path.is_file() and path.parent == _build.BUILD_DIR
    assert lib._name == str(path)


def test_bgr_to_gray_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    got = bgr_to_gray_f32(bgr)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    want = (gray.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_bgr_to_gray_bit_equals_the_jax_package(backend, monkeypatch):
    # The JAX package's numpy chain, which its native LUT equals bit for
    # bit; its native/ library is not built from here.
    monkeypatch.setattr(jnative, "load_native", lambda: None)
    if backend == "numpy":
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    bgr[0, :8] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                  [0, 0, 255], [1, 2, 3], [254, 254, 254], [128, 64, 32]]
    got = bgr_to_gray_f32(bgr)
    want = jnative.bgr_to_gray_f32(bgr)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_native_byte_conversions_bit_equal_the_canonical_chains():
    lib = load_native()
    b = np.arange(256, dtype=np.uint8)
    out = np.empty(256, np.float32)
    lib.gray_u8_to_f32(b.ctypes.data, out.ctypes.data, 256)
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    assert np.array_equal(out.view(np.uint32), want.view(np.uint32))

    x = np.concatenate([want, np.linspace(-1.5, 2.5, 401,
                                          dtype=np.float32)])
    got = np.empty(x.size, np.uint8)
    lib.f32_to_u8_wrap(x.ctypes.data, got.ctypes.data, x.size)
    np.testing.assert_array_equal(got, np.asarray(jfloat_to_uint8(x)))


def test_ring_fifo_and_latest():
    ring = FrameRing(4, (2, 2))
    for i in range(3):
        ring.push(np.full((2, 2), float(i)))
    f, seq = ring.pop()
    assert seq == 0 and f[0, 0] == 0.0
    f, seq = ring.pop_latest()
    assert seq == 2 and f[0, 0] == 2.0
    assert len(ring) == 0
    f, seq = ring.pop()
    assert f is None and seq == -1


def test_ring_drop_oldest_when_full():
    ring = FrameRing(2, (1,))
    for i in range(5):
        ring.push(np.asarray([float(i)]))
    f, seq = ring.pop()
    assert seq == 3 and f[0] == 3.0
    f, seq = ring.pop()
    assert seq == 4 and f[0] == 4.0


@pytest.mark.parametrize("backend", ["auto", "numpy"])
@pytest.mark.parametrize("dtype,shape", [
    (np.uint8, (3, 5)),     # 15 bytes: exercises the non-multiple-of-4 pad
    (np.uint8, (4, 4)),
    (np.float64, (2, 3)),
])
def test_ring_arbitrary_dtype_roundtrip(backend, dtype, shape, monkeypatch):
    if backend == "numpy":
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    rng = np.random.default_rng(0)
    ring = FrameRing(3, shape, dtype=dtype)
    assert (ring._lib is None) == (backend == "numpy")
    frames = [(rng.random(shape) * 200).astype(dtype) for _ in range(3)]
    for f in frames:
        ring.push(f)
    for i in range(3):
        f, seq = ring.pop()
        assert seq == i
        assert f.dtype == np.dtype(dtype) and f.shape == shape
        np.testing.assert_array_equal(f, frames[i])


def test_feeder_uint8_dtype_end_to_end():
    frames = (np.arange(12, dtype=np.uint8).reshape(3, 2, 2) * 10)
    feeder = FrameFeeder(ArrayCapture(frames.astype(np.float32)),
                         capacity=4, lossless=True, dtype=np.uint8).start()
    got = []
    while True:
        f, _ = feeder.next_frame(latest=False)
        if f is None:
            break
        assert f.dtype == np.uint8
        got.append(f)
    feeder.stop()
    np.testing.assert_array_equal(np.stack(got), frames)


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_ring_dropped_counts(backend, monkeypatch):
    if backend == "numpy":
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    ring = FrameRing(2, (1,))
    assert ring.dropped == 0
    for i in range(5):
        ring.push(np.asarray([float(i)]))
    # pushes 2,3,4 each overwrote an unread slot
    assert ring.dropped == 3
    f, seq = ring.pop_latest()  # delivers 4, skips unread 3
    assert seq == 4
    assert ring.dropped == 4
    ring.push(np.asarray([5.0]))
    f, seq = ring.pop()  # FIFO delivery drops nothing
    assert seq == 5
    assert ring.dropped == 4


def test_ring_concurrent_producer_consumer():
    # SPSC stress: every consumed frame's content must match its sequence
    # stamp (no torn frames), sequences strictly increase.
    ring = FrameRing(8, (64,))
    n = 3000
    errors = []
    consumed = []

    def producer():
        for i in range(n):
            ring.push(np.full(64, float(i), np.float32))

    def consumer():
        last = -1
        idle = 0
        while idle < 2000:
            f, seq = ring.pop()
            if f is None:
                idle += 1
                time.sleep(0.0001)
                continue
            idle = 0
            if not np.all(f == float(seq)):
                errors.append(("torn", seq))
            if seq <= last:
                errors.append(("order", seq, last))
            last = seq
            consumed.append(seq)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tc.start()
    tp.start()
    tp.join(timeout=60)
    tc.join(timeout=60)
    assert not tp.is_alive() and not tc.is_alive()
    assert not errors, errors[:5]
    assert len(consumed) > 0
    assert consumed[-1] == n - 1  # the final frame always arrives
    # Conservation: every pushed frame is delivered, counted dropped, or
    # still resident (every tail step is a pop or a counted drop).
    assert len(consumed) + ring.dropped + len(ring) == n


@pytest.mark.parametrize("cap", [2, 8])
def test_ring_concurrent_pop_latest(cap):
    ring = FrameRing(cap, (64,))
    n = 10000
    errors = []
    consumed = []
    done = threading.Event()

    def producer():
        for i in range(n):
            ring.push(np.full(64, float(i), np.float32))
        done.set()

    def consumer():
        last = -1
        while True:
            f, seq = ring.pop_latest()
            if f is None:
                if done.is_set():
                    f, seq = ring.pop_latest()
                    if f is None:
                        break
                else:
                    continue
            if not np.all(f == float(seq)):
                errors.append(("torn", seq))
            if seq <= last:
                errors.append(("order", seq, last))
            last = seq
            consumed.append(seq)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tc.start()
    tp.start()
    tp.join(timeout=60)
    tc.join(timeout=60)
    assert not tp.is_alive() and not tc.is_alive()
    assert not errors, errors[:5]
    assert consumed and consumed[-1] == n - 1
    assert len(consumed) + ring.dropped + len(ring) == n


def test_feeder_end_to_end():
    frames = np.stack([np.full((4, 6), float(i), np.float32)
                       for i in range(20)])
    feeder = FrameFeeder(ArrayCapture(frames, fps=1000.0)).start()
    seen = []
    while True:
        f, seq = feeder.next_frame(latest=False, timeout=2.0)
        if f is None:
            break
        assert np.all(f == f[0, 0])
        seen.append(int(f[0, 0]))
    feeder.stop()
    assert seen, "no frames delivered"
    assert seen == sorted(seen)
    assert seen[-1] == 19


# -- tests/test_feeder_monitor.py for the port ------------------------------

def _clip(num_frames):
    return breathing_clip(num_frames=num_frames, height=H, width=W, fps=FPS,
                          bpm=BPM_TRUE, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)


def _monitor(frames, **kw):
    cfg = MonitorConfig(calibration=SMALL_CAL)
    return RespiratoryMonitor(
        capture_target="synthetic", save_all_data=False, visualize=None,
        config=cfg, capture=ArrayCapture(frames, fps=FPS), auto_run=False,
        sync_fps=False, device="cpu", **kw)


def test_capture_overlaps_stalled_consumer_and_bpm_survives():
    clip = _clip(64 + 1 + 80)
    mon = _monitor(clip, use_feeder=True, feeder_latest=False,
                   feeder_capacity=16)
    assert mon.step()  # first step starts the feeder thread

    time.sleep(0.45)  # stand-in for a slow device step: no step() calls
    after = mon._feeder.frames_captured
    assert after >= mon.feeder_capacity, \
        "capture thread did not prefetch while the consumer stalled"
    assert after <= mon.feeder_capacity + 2, \
        "lossless producer ran past the ring capacity"

    mon.run()  # drain the rest of the clip through the ring
    assert mon.state == "measure"
    assert mon.frames_dropped == 0
    assert len(mon.freq) > 0, "no BPM estimates produced through the feeder"
    assert abs(mon.freq[-1] - BPM_TRUE) <= 0.5
    # Lossless replay through the ring equals direct replay.
    direct = _monitor(clip)
    direct.run()
    assert (mon.x, mon.y, mon.w, mon.h) == \
        (direct.x, direct.y, direct.w, direct.h)
    assert list(mon.freq) == list(direct.freq)


def test_dropped_frames_surface_on_monitor():
    mon = _monitor(_clip(40), use_feeder=True, feeder_latest=True,
                   feeder_capacity=2)
    assert mon.step()  # start feeder
    time.sleep(1.2)    # producer pushes ~12 frames into a 2-slot ring
    while mon.step():
        pass
    assert mon.frames_dropped > 0, "overwritten frames were not surfaced"
    mon.stop_feeder()


def test_feeder_defaults():
    # Injected array captures default to the direct synchronous path.
    mon = _monitor(_clip(4))
    assert mon.use_feeder is False
    mon.cap.release()
