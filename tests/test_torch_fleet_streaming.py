"""Port parity: the fleet's streaming-ROI re-lock (``MultiStreamMonitor``
with ``streaming_roi=True``) against the JAX package's, and the JAX
package's tests of that mode (``tests/test_parallel.py:145-246``) for the
port.

Both fleets step through the same drifting clips; after every step the
re-lock count and the host's ROI mirror are recorded, and the two trails
must be equal, with the coarse localize and with the full-resolution one.
The trail comes from the frames and the rings only.  The batched localize
and warm start are held to the single-stream functions bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.parallel import streams as jstreams
from respmon_tpu_torch import interop
from respmon_tpu_torch.parallel import streams as tstreams
from respmon_tpu_torch.pipeline import motion as tmotion
from respmon_tpu_torch.pipeline import streaming as tstreaming

torch.set_num_threads(1)

FPS = 10.0
H, W = 60, 80
# tests/test_parallel.py:150's per-stream drifts (the first three).
DRIFTS = [(14.0, 24.0), (12.0, 20.0), (10.0, 26.0)]


def _cfg(t, method="average"):
    cal = CalibrationConfig(buffer_length=t, pyramid_levels=4,
                            skip_levels_at_top=1)
    return MonitorConfig(calibration=cal, streaming_roi=True,
                         streaming_interval=4, streaming_drift_px=2.0,
                         motion_extraction_method=method)


def _drifting_clips(n, method="average"):
    # tests/test_parallel.py:166-173's clips: one background seed, a
    # drift per stream.
    return np.stack([
        breathing_clip(num_frames=n, height=H, width=W, fps=FPS, bpm=37.5,
                       patch_center=(20, 24), patch_size=(14, 18),
                       amplitude=0.3, drift_px=d, noise=0.002,
                       motion_px=1.5 if method == "flow" else 0.0,
                       texture_motion=method == "flow", seed=0)
        for d in DRIFTS])


def _port_fleet(cfg, clips, t, **kw):
    mon = tstreams.MultiStreamMonitor(
        interop.config_from_reference(cfg), None, (H, W), FPS, device="cpu",
        **kw)
    assert mon.calibrate(clips[:, :t]).found.all()
    return mon


@pytest.mark.parametrize("coarse", [True, False])
def test_relock_trail_equals_jax(coarse):
    n, t = 44, 16
    cfg = _cfg(t)
    clips = _drifting_clips(n)
    jmon = jstreams.MultiStreamMonitor(cfg, None, (H, W), FPS,
                                       streaming_coarse=coarse)
    assert bool(np.asarray(jmon.calibrate(clips[:, :t]).found).all())
    tmon = _port_fleet(cfg, clips, t, streaming_coarse=coarse)
    for f in range(t + 1, n):
        jr = jmon.step(clips[:, f])
        tr = tmon.step(clips[:, f])
        assert tmon.relocks == jmon.relocks, f
        np.testing.assert_array_equal(tmon._rois, jmon._rois, err_msg=f)
        np.testing.assert_array_equal(tr.error.numpy(), np.asarray(jr.error))
        np.testing.assert_allclose(tr.samples.numpy(),
                                   np.asarray(jr.samples), rtol=0, atol=1e-5)
    assert tmon.relocks >= 3
    np.testing.assert_array_equal(tmon.states.roi.numpy(), tmon._rois)


def test_fleet_streaming_relock_follows_moving_subjects():
    # tests/test_parallel.py:180 for the port: batched coarse localize and
    # masked re-locks follow every stream's subject, never erring.
    n, t = 72, 16
    clips = _drifting_clips(n)
    mon = _port_fleet(_cfg(t), clips, t)
    errors = 0
    for f in range(t + 1, n):
        errors += int(mon.step(clips[:, f]).error.sum())
    assert errors == 0
    assert mon.relocks >= len(DRIFTS), f"only {mon.relocks} re-locks"
    for i, (dy, dx) in enumerate(DRIFTS):
        ty, tx = 20.0 + dy, 24.0 + dx
        x, y, w, h = mon._rois[i]
        assert x <= tx <= x + w, (i, x, w, tx)
        assert y <= ty <= y + h, (i, y, h, ty)
    np.testing.assert_array_equal(mon.states.roi.numpy(), mon._rois)


def test_fleet_streaming_relock_preserves_flow_tracking():
    # tests/test_parallel.py:206 for the port: re-locks move the tracked
    # points with the window; no sample goes NaN.  (The drift is spread
    # over the clip, so the clip keeps that test's 80 frames, of which
    # the first 48 are stepped: the JAX fleet loses stream 2 at frame 32
    # of a 56-frame clip too.)
    n, t = 80, 16
    clips = _drifting_clips(n, "flow")
    mon = _port_fleet(_cfg(t, "flow"), clips, t)
    samples = []
    for f in range(t + 1, 48):
        res = mon.step(clips[:, f])
        samples.append(res.samples)
        assert not res.error.any()
    assert mon.relocks >= len(DRIFTS)
    assert torch.isfinite(torch.stack(samples)).all(), \
        "tracking lost across a fleet re-lock"


def test_streaming_update_coarse_tracks_exact():
    # tests/test_parallel.py:221 for the port: the coarse localize agrees
    # with the full-resolution one within its granularity.
    cal = interop.config_from_reference(CalibrationConfig(
        buffer_length=16, pyramid_levels=4, skip_levels_at_top=1))
    clip = breathing_clip(num_frames=16, height=H, width=W, fps=FPS,
                          bpm=37.5, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.3, noise=0.0)
    s_exact = tstreaming.init_streaming_state(H, W, cal, device="cpu")
    s_coarse = tstreaming.init_streaming_state(H, W, cal, device="cpu")
    for frame in torch.from_numpy(clip):
        s_exact, r_exact = tstreaming.streaming_update(s_exact, frame, FPS,
                                                       cal)
        s_coarse, r_coarse = tstreaming.streaming_update(
            s_coarse, frame, FPS, cal, coarse=True)
    assert bool(r_exact.found) and bool(r_coarse.found)
    g = 2 ** cal.skip_levels_at_top
    cx_e = float(r_exact.x) + float(r_exact.w) / 2
    cy_e = float(r_exact.y) + float(r_exact.h) / 2
    cx_c = float(r_coarse.x) + float(r_coarse.w) / 2
    cy_c = float(r_coarse.y) + float(r_coarse.h) / 2
    assert abs(cx_e - cx_c) <= 2 * g and abs(cy_e - cy_c) <= 2 * g


@pytest.mark.parametrize("coarse", [True, False])
def test_localize_batch_rows_equal_the_single_stream_localize(coarse):
    # Each stream of one batched localize (one bandpass product and one
    # collapse over all rings) equals the single-stream localize of its
    # rings, bit for bit.
    cal = interop.config_from_reference(_cfg(16).calibration)
    clips = torch.from_numpy(_drifting_clips(24))
    rings = tstreams.init_fleet_streaming_from_buffers(clips[:, :16], cal)
    rings, loc = tstreams.update_streams(rings, clips[:, 16], FPS, cal,
                                         coarse=coarse)
    for i in range(len(DRIFTS)):
        one = tstreaming.StreamingState(
            levels=tuple(lv[i] for lv in rings.levels), count=rings.count[i])
        want = tstreaming._localize_window(one, (H, W), torch.float32, FPS,
                                           cal, coarse)
        for f in want._fields:
            assert torch.equal(getattr(loc, f)[i], getattr(want, f)), (i, f)


def test_fleet_warm_start_in_chunks_gives_the_same_rings(monkeypatch):
    # The flattened (S*T) stack goes through K1 in chunks; K1 works frame
    # by frame, so any chunking gives the bits of one call.
    cal = interop.config_from_reference(_cfg(16).calibration)
    clips = torch.from_numpy(_drifting_clips(20))
    whole = tstreaming.init_streaming_from_buffers_batch(clips, cal)
    frame_bytes = 4 * H * W
    for chunk in (1, 5, 16):
        monkeypatch.setattr(tstreaming, "WARM_START_CHUNK_BYTES",
                            chunk * frame_bytes)
        part = tstreaming.init_streaming_from_buffers_batch(clips, cal)
        assert torch.equal(part.count, whole.count)
        for a, b in zip(part.levels, whole.levels):
            assert torch.equal(a, b), chunk


def test_recalibrated_streams_warm_start_their_rings():
    # recalibrate() rebuilds the rings of the applied streams only.
    n, t = 32, 16
    clips = _drifting_clips(n)
    mon = _port_fleet(_cfg(t), clips, t)
    for f in range(t, t + 3):
        mon.step(clips[:, f])
    before = mon._streaming
    mask = np.asarray([True, False, False])
    mon.recalibrate(clips[:, 8:8 + t], stream_mask=mask)
    fresh = tstreaming.init_streaming_from_buffers_batch(
        torch.from_numpy(clips[:, 8:8 + t]),
        interop.config_from_reference(_cfg(t).calibration))
    for new, old, ref in zip(mon._streaming.levels, before.levels,
                             fresh.levels):
        assert torch.equal(new[0], ref[0])
        assert torch.equal(new[1:], old[1:])
    cfg = dataclasses.replace(_cfg(t), streaming_roi=False)
    plain = _port_fleet(cfg, clips, t)
    assert plain._streaming is None


def test_a_relock_that_drops_every_point_detects_corners_again(monkeypatch):
    # A re-lock that moves a stream's window by more than its width takes
    # every tracked point of that stream out of it: the stream is then
    # uninitialized, and the next step detects its corners (the JAX fleet,
    # respmon_tpu/parallel/streams.py:751-789, keeps the hint and loses
    # the stream for good).  A re-lock that keeps points keeps the hint.
    n, t, hw = 24, 16, (120, 200)
    clips = np.stack([
        breathing_clip(num_frames=n, height=hw[0], width=hw[1], fps=FPS,
                       bpm=37.5, patch_center=(60, 30), patch_size=(24, 30),
                       amplitude=0.3, noise=0.002, motion_px=1.5,
                       texture_motion=True, seed=i) for i in range(3)])
    cal = CalibrationConfig(buffer_length=t, pyramid_levels=5,
                            skip_levels_at_top=1)
    cfg = dataclasses.replace(_cfg(t, "flow"), calibration=cal,
                              streaming_interval=10_000)
    mon = tstreams.MultiStreamMonitor(interop.config_from_reference(cfg),
                                      None, hw, FPS, device="cpu")
    assert mon.calibrate(clips[:, :t]).found.all()
    hints = []
    real = tmotion.measure_step_cached

    def spy(state, cache, frame, spec, initialized_hint=False,
            cache_valid=True):
        hints.append(initialized_hint)
        return real(state, cache, frame, spec, initialized_hint,
                    cache_valid)
    monkeypatch.setattr(tmotion, "measure_step_cached", spy)
    for f in range(t, t + 3):
        mon.step(clips[:, f])
    assert hints == [False, True, True]
    assert bool(mon.states.initialized.all())
    # The leftmost stream seen at the frame's right edge, another stream
    # two pixels right, the third not found.
    rois = mon._rois.copy()
    far, near = np.argsort(rois[:, 0])[:2]
    x = rois[:, 0].astype(np.int64)
    x[far] = hw[1] - rois[far, 2]
    x[near] += 2
    found = np.ones(3, np.int64)
    found[3 - far - near] = 0
    boxes = np.stack([found, x, rois[:, 1], rois[:, 2], rois[:, 3]])
    last = hw[1] - mon.spec.crop_w
    assert min(x[far], last) - min(rois[far, 0], last) >= mon.spec.crop_w
    mon._maybe_relock(boxes.astype(np.int64), mon._ingest(clips[:, t + 2]))
    assert mon.relocks == 2
    init = mon.states.initialized
    assert not bool(init[far]) and int(init.sum()) == 2
    assert not bool(mon.states.pts_valid[far].any())
    res = mon.step(clips[:, t + 3])
    assert hints[-1] is False
    assert bool(mon.states.initialized.all())
    assert bool(mon.states.pts_valid[far].any()) and not bool(res.error[far])
    # A re-lock that leaves points in every window keeps the hint.
    rois = mon._rois.copy()
    boxes = np.stack([np.ones(3), rois[:, 0] + 2, rois[:, 1], rois[:, 2],
                      rois[:, 3]]).astype(np.int64)
    mon._maybe_relock(boxes, mon._ingest(clips[:, t + 3]))
    assert mon.relocks >= 3 and bool(mon.states.initialized.all())
    mon.step(clips[:, t + 4])
    assert hints[-1] is True
