"""Port parity: the streaming localizer (pipeline/streaming), the re-lock
(``motion.relock_state``) and the interop of ``StreamingState`` against
the JAX package, and the JAX package's own streaming tests for the port.

Tolerances.  Run as its functions are (jitted), the JAX package's absorb
compiles its pyramid with XLA's CPU backend, which contracts the stencils'
multiply-adds into fused multiply-adds; the port's plain pyramid (and its
CUDA kernel, built with ``-fmad=false``) rounds each product.  So the rings
agree to 1e-6, while ready, found and every bbox are equal, and so is the
heatmap of a full window, to one code on a few pixels.  (Before the window
fills, the heatmap normalizes a window that is mostly zeros, and there a
pixel may differ by more.)  With JAX's jit disabled its ops run one by
one, unfused, and the rings and heatmaps are equal bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.pipeline import evm as jevm
from respmon_tpu.pipeline import motion as jmotion
from respmon_tpu.pipeline import streaming as jst
from respmon_tpu_torch import interop
from respmon_tpu_torch.pipeline import evm as tevm
from respmon_tpu_torch.pipeline import motion as tmotion
from respmon_tpu_torch.pipeline import streaming as tst

torch.set_num_threads(1)

FPS = 10.0
RING_ATOL = 1e-6
# (name, frame h, w, calibration): the sizes of the JAX streaming tests.
GEOMETRIES = {
    "60x80_L4S1_T16": (60, 80, CalibrationConfig(
        buffer_length=16, pyramid_levels=4, skip_levels_at_top=1)),
    "60x80_L4S1_T32": (60, 80, CalibrationConfig(
        buffer_length=32, pyramid_levels=4, skip_levels_at_top=1)),
    "120x160_L6S2_T64": (120, 160, CalibrationConfig(
        buffer_length=64, pyramid_levels=6, skip_levels_at_top=2)),
}


def _drifting_clip(h, w, n, seed=0, dtype=np.float32):
    """A breathing patch whose centre drifts across the frame."""
    return breathing_clip(num_frames=n, height=h, width=w, fps=FPS,
                          bpm=37.5, patch_center=(0.3 * h, 0.25 * w),
                          patch_size=(h // 6, w // 6), amplitude=0.35,
                          drift_px=(0.25 * h, 0.35 * w), noise=0.002,
                          seed=seed, dtype=dtype)


def _u8(clip):
    return np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)


def _bbox(r):
    return tuple(int(v) for v in (r.x, r.y, r.w, r.h))


def _located(r):
    return (bool(r.ready), bool(r.found)) + _bbox(r)


def _assert_rings_close(tstate, jstate, atol=RING_ATOL):
    assert len(tstate.levels) == len(jstate.levels)
    for t, j in zip(tstate.levels, jstate.levels):
        j = np.asarray(j)
        assert t.shape == j.shape and t.numpy().dtype == j.dtype
        if atol == 0:
            assert np.array_equal(t.numpy(), j)
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol)
    assert np.array_equal(tstate.count.numpy(), np.asarray(jstate.count))


def _assert_heat_close(t_heat, j_heat, exact=False):
    t_heat = t_heat.numpy().astype(np.int32)
    j_heat = np.asarray(j_heat).astype(np.int32)
    if exact:
        assert np.array_equal(t_heat, j_heat)
        return
    diff = np.abs(t_heat - j_heat)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.fixture(scope="module")
def update_runs():
    """Both packages' ``streaming_update`` over a drifting clip, once per
    geometry: every frame's state and result, and the port's rings after
    each ``streaming_absorb`` of the same frames."""
    done = {}

    def get(name):
        if name not in done:
            h, w, cfg = GEOMETRIES[name]
            tcfg = interop.config_from_reference(cfg)
            clip = _drifting_clip(h, w, cfg.buffer_length + 10)
            js = jst.init_streaming_state(h, w, cfg)
            ts = tst.init_streaming_state(h, w, tcfg, device="cpu")
            ta = ts
            steps = []
            for frame in clip:
                js, jr = jst.streaming_update(js, jnp.asarray(frame), FPS,
                                              cfg)
                ts, tr = tst.streaming_update(ts, torch.from_numpy(frame),
                                              FPS, tcfg)
                ta = tst.streaming_absorb(ta, torch.from_numpy(frame), tcfg)
                steps.append((js, jr, ts, tr, ta))
            done[name] = (clip, cfg, tcfg, steps)
        return done[name]
    return get


def test_init_streaming_state_matches_the_jax_package():
    for h, w, cfg in GEOMETRIES.values():
        got = tst.init_streaming_state(h, w, interop.config_from_reference(
            cfg), device="cpu")
        _assert_rings_close(got, jst.init_streaming_state(h, w, cfg), 0)
        assert got.count.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_streaming_update_matches_the_jax_package_every_frame(update_runs,
                                                              name):
    clip, cfg, _, steps = update_runs(name)
    ready = []
    for js, jr, ts, tr, ta in steps:
        _assert_rings_close(ts, js)
        # The absorb half alone leaves the same rings, bit for bit.
        for a, b in zip(ta.levels, ts.levels):
            assert torch.equal(a, b)
        assert torch.equal(ta.count, ts.count)
        assert _located(tr) == _located(jr)
        if bool(tr.ready):
            _assert_heat_close(tr.heatmap_u8, jr.heatmap_u8)
        ready.append(bool(tr.ready))
    t = cfg.buffer_length
    assert ready == [False] * (t - 1) + [True] * (len(clip) - t + 1)
    assert all(bool(r.found) for *_, r, _ in steps[t - 1:])


def test_streaming_update_bit_equals_the_unfused_jax_package():
    # JAX's ops one by one (no jit, no fused multiply-adds): the port's
    # rings and heatmaps equal them bit for bit.
    h, w, cfg = GEOMETRIES["60x80_L4S1_T16"]
    tcfg = interop.config_from_reference(cfg)
    clip = _drifting_clip(h, w, cfg.buffer_length + 3, seed=1)
    ts = tst.init_streaming_state(h, w, tcfg, device="cpu")
    with jax.disable_jit():
        js = jst.init_streaming_state(h, w, cfg)
        for frame in clip:
            js, jr = jst.streaming_update(js, jnp.asarray(frame), FPS, cfg)
            ts, tr = tst.streaming_update(ts, torch.from_numpy(frame), FPS,
                                          tcfg)
            _assert_rings_close(ts, js, atol=0)
            assert _located(tr) == _located(jr)
            _assert_heat_close(tr.heatmap_u8, jr.heatmap_u8, exact=True)


@pytest.mark.parametrize("name", ["60x80_L4S1_T32", "120x160_L6S2_T64"])
def test_coarse_localize_matches_the_jax_package(update_runs, name):
    clip, cfg, tcfg, steps = update_runs(name)
    h, w = clip.shape[1:]
    for js, _, ts, tr, _ in steps[cfg.buffer_length - 1:]:
        got = tst._localize_window(ts, (h, w), torch.float32, FPS, tcfg,
                                   coarse=True)
        want = jst._localize_window(js, (h, w), jnp.float32, FPS, cfg,
                                    coarse=True)
        assert _located(got) == _located(want)
        _assert_heat_close(got.heatmap_u8, want.heatmap_u8)
        s = 1 << cfg.skip_levels_at_top
        assert tuple(got.heatmap_u8.shape) == (-(-h // s), -(-w // s))
        x, y, bw, bh = _bbox(got)
        assert x % s == 0 and y % s == 0 and x + bw <= w and y + bh <= h


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_init_from_buffer_matches_the_jax_package_and_the_absorbs(
        update_runs, name):
    clip, cfg, tcfg, steps = update_runs(name)
    got = tst.init_streaming_from_buffer(torch.from_numpy(clip), tcfg)
    want = jst.init_streaming_from_buffer(jnp.asarray(clip), cfg)
    _assert_rings_close(got, want)
    # One K1 call over the buffer's last T frames equals T absorbs.
    absorbed = steps[-1][4]
    for a, b in zip(got.levels, absorbed.levels):
        assert torch.equal(a, b)
    assert int(got.count) == cfg.buffer_length == int(absorbed.count)


def test_uint8_ingest_equals_float_ingest():
    h, w, cfg = GEOMETRIES["60x80_L4S1_T16"]
    tcfg = interop.config_from_reference(cfg)
    u8 = _u8(_drifting_clip(h, w, 20, seed=2))
    f = (u8.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    s_u8 = tst.init_streaming_from_buffer(torch.from_numpy(u8[:16]), tcfg)
    s_f = tst.init_streaming_from_buffer(torch.from_numpy(f[:16]), tcfg)
    for i in range(16, 20):
        s_u8, r_u8 = tst.streaming_update(s_u8, torch.from_numpy(u8[i]),
                                          FPS, tcfg)
        s_f, r_f = tst.streaming_update(s_f, torch.from_numpy(f[i]), FPS,
                                        tcfg)
        for a, b in zip(s_u8.levels, s_f.levels):
            assert torch.equal(a, b)
        assert _located(r_u8) == _located(r_f)
        assert torch.equal(r_u8.heatmap_u8, r_f.heatmap_u8)
    # And the u8 path matches the JAX package's u8 path.
    js = jst.init_streaming_from_buffer(jnp.asarray(u8[:16]), cfg)
    ts = tst.init_streaming_from_buffer(torch.from_numpy(u8[:16]), tcfg)
    js, jr = jst.streaming_update(js, jnp.asarray(u8[16]), FPS, cfg)
    ts, tr = tst.streaming_update(ts, torch.from_numpy(u8[16]), FPS, tcfg)
    _assert_rings_close(ts, js)
    assert _located(tr) == _located(jr)


def test_batch_absorb_and_warm_start_match_the_jax_package():
    h, w, cfg = GEOMETRIES["60x80_L4S1_T16"]
    tcfg = interop.config_from_reference(cfg)
    s, t = 3, cfg.buffer_length
    clips = np.stack([_drifting_clip(h, w, t + 4, seed=k) for k in range(s)])
    got = tst.init_streaming_from_buffers_batch(
        torch.from_numpy(clips[:, :t + 1]), tcfg)
    want = jst.init_streaming_from_buffers_batch(
        jnp.asarray(clips[:, :t + 1]), cfg)
    _assert_rings_close(got, want)
    assert tuple(got.count.shape) == (s,)
    for i in range(t + 1, t + 4):
        got = tst.streaming_absorb_batch(got, torch.from_numpy(clips[:, i]),
                                         tcfg)
        want = jst.streaming_absorb_batch(want, jnp.asarray(clips[:, i]),
                                          cfg)
        _assert_rings_close(got, want)
    # Each stream's rings equal the single-stream functions' in the port.
    for k in range(s):
        one = tst.init_streaming_from_buffer(
            torch.from_numpy(clips[k, :t + 1]), tcfg)
        for i in range(t + 1, t + 4):
            one = tst.streaming_absorb(one, torch.from_numpy(clips[k, i]),
                                       tcfg)
        for a, b in zip(got.levels, one.levels):
            assert torch.equal(a[k], b)
        assert int(got.count[k]) == int(one.count)


def test_batch_functions_take_uint8_frames():
    h, w, cfg = GEOMETRIES["60x80_L4S1_T16"]
    tcfg = interop.config_from_reference(cfg)
    u8 = np.stack([_u8(_drifting_clip(h, w, 17, seed=k)) for k in range(3)])
    f = (u8.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    a = tst.streaming_absorb_batch(tst.init_streaming_from_buffers_batch(
        torch.from_numpy(u8[:, :16]), tcfg), torch.from_numpy(u8[:, 16]),
        tcfg)
    b = tst.streaming_absorb_batch(tst.init_streaming_from_buffers_batch(
        torch.from_numpy(f[:, :16]), tcfg), torch.from_numpy(f[:, 16]), tcfg)
    for x, y in zip(a.levels, b.levels):
        assert torch.equal(x, y)


# -- the JAX package's streaming tests for the port --------------------------

def test_streaming_matches_batch_locate_on_static_scene():
    cfg = CalibrationConfig(buffer_length=32, pyramid_levels=4,
                            skip_levels_at_top=1)
    tcfg = interop.config_from_reference(cfg)
    clip = breathing_clip(num_frames=32, height=60, width=80, fps=FPS,
                          bpm=18.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25, noise=0.002)
    state = tst.init_streaming_state(60, 80, tcfg, device="cpu")
    for i in range(32):
        state, res = tst.streaming_update(state, torch.from_numpy(clip[i]),
                                          FPS, tcfg)
        if i < 31:
            assert not bool(res.ready)
    assert bool(res.ready) and bool(res.found)
    batch = tevm.locate(torch.from_numpy(clip), FPS, tcfg)
    assert _bbox(res) == _bbox(batch)
    assert torch.equal(res.heatmap_u8, batch.heatmap_u8)
    assert _bbox(res) == _bbox(jevm.locate(jnp.asarray(clip), FPS, cfg))


def test_streaming_tracks_roi_continuously():
    cfg = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1)
    tcfg = interop.config_from_reference(cfg)
    clip = breathing_clip(num_frames=40, height=60, width=80, fps=FPS,
                          bpm=24.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25, noise=0.002)
    state = tst.init_streaming_state(60, 80, tcfg, device="cpu")
    found = 0
    for i in range(40):
        state, res = tst.streaming_update(state, torch.from_numpy(clip[i]),
                                          FPS, tcfg)
        found += int(bool(res.found))
    assert found >= 20


def test_streaming_roi_follows_moving_subject():
    # tests/test_streaming_checkpoint_faults.py:95-156 for the port.
    T = 16
    n = 80
    drift = (16.0, 28.0)   # patch center moves (18,20) -> (34,48)
    cfg = CalibrationConfig(buffer_length=T, pyramid_levels=4,
                            skip_levels_at_top=1)
    tcfg = interop.config_from_reference(cfg)
    clip = breathing_clip(num_frames=n, height=60, width=80, fps=FPS,
                          bpm=37.5, patch_center=(18, 20),
                          patch_size=(10, 12), amplitude=0.35,
                          drift_px=drift, noise=0.0)

    def true_center(i):
        mid = i - (T - 1) / 2.0
        return (18.0 + drift[0] * mid / (n - 1),
                20.0 + drift[1] * mid / (n - 1))

    state = tst.init_streaming_state(60, 80, tcfg, device="cpu")
    errs, centers, first_box, contained = [], [], None, 0
    for i in range(n):
        state, res = tst.streaming_update(state, torch.from_numpy(clip[i]),
                                          FPS, tcfg)
        if i >= T + 2 and bool(res.found):
            x, y, w, h = _bbox(res)
            if first_box is None:
                first_box = (x, y, w, h)
            ty, tx = true_center(i)
            contained += int((x <= tx <= x + w) and (y <= ty <= y + h))
            errs.append(np.hypot(y + h / 2.0 - ty, x + w / 2.0 - tx))
            centers.append((y + h / 2.0, x + w / 2.0))
    assert len(centers) == n - T - 2, "missed localizations while tracking"
    assert contained == len(centers), \
        f"subject escaped the ROI {len(centers) - contained} time(s)"
    assert np.median(errs) <= 4.0, f"median center error {np.median(errs)}"
    moved = np.hypot(centers[-1][0] - centers[0][0],
                     centers[-1][1] - centers[0][1])
    true_moved = np.hypot(*drift) * (len(centers) / n)
    assert moved >= 0.4 * true_moved, (moved, true_moved)
    fx, fy, fw, fh = first_box
    ty_f, tx_f = 18.0 + drift[0], 20.0 + drift[1]
    assert not ((fx <= tx_f <= fx + fw) and (fy <= ty_f <= fy + fh)), \
        "drift too small to demonstrate tracking"


def test_localize_ignores_the_iir_setting_as_the_jax_package_does():
    # The streaming localizer bandpasses with the packed-rfft operator
    # whatever temporal_filter says (respmon_tpu/pipeline/streaming.py:
    # 169-170); the port keeps that.
    h, w, cfg = GEOMETRIES["60x80_L4S1_T16"]
    iir = dataclasses.replace(cfg, temporal_filter="iir")
    clip = _drifting_clip(h, w, 17, seed=3)
    out = []
    for c in (cfg, iir):
        tcfg = interop.config_from_reference(c)
        st = tst.init_streaming_from_buffer(torch.from_numpy(clip[:16]),
                                            tcfg)
        out.append(tst.streaming_update(st, torch.from_numpy(clip[16]),
                                        FPS, tcfg)[1])
    assert _located(out[0]) == _located(out[1])
    assert torch.equal(out[0].heatmap_u8, out[1].heatmap_u8)


# -- relock_state -----------------------------------------------------------

def _flow_state(frames, roi, spec_j, steps=3):
    """The JAX package's flow measure state after a few tracked frames,
    and the same state in the port (float32 tracking drifts apart between
    the packages, so both re-locks start from the same points)."""
    js = jmotion.init_state(spec_j, roi)
    for frame in frames[:steps]:
        js, _ = jmotion.measure_step(js, jnp.asarray(frame), spec_j)
    d = {f: np.asarray(getattr(js, f)) for f in js._fields}
    return js, interop.measure_state_from_numpy(d, device="cpu")


def _assert_states_equal(t, j):
    for f in j._fields:
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f))), f


@pytest.mark.parametrize("ingest", ["float32", "uint8"])
@pytest.mark.parametrize("new_roi", [(44, 26, 40, 30), (30, 22, 40, 30),
                                     (60, 40, 40, 30), (120, 90, 40, 30)])
def test_relock_state_matches_the_jax_package(ingest, new_roi):
    mcfg = MonitorConfig(motion_extraction_method="flow")
    clip = breathing_clip(num_frames=5, height=120, width=160, fps=FPS,
                          bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12, motion_px=2.0,
                          texture_motion=True, seed=1)
    if ingest == "uint8":
        clip = _u8(clip)
    roi = (40, 30, 40, 30)
    spec_j = jmotion.MeasureSpec.for_roi(mcfg, 120, 160, roi[2], roi[3], FPS)
    spec_t = tmotion.MeasureSpec.for_roi(
        interop.config_from_reference(mcfg), 120, 160, roi[2], roi[3], FPS)
    js, ts = _flow_state(clip, roi, spec_j)
    assert int(ts.pts_valid.sum()) > 0
    got = tmotion.relock_state(ts, torch.from_numpy(clip[3]), new_roi,
                               spec_t)
    want = jmotion.relock_state(js, jnp.asarray(clip[3]),
                                jnp.asarray(new_roi), spec_j)
    _assert_states_equal(got, want)
    # The signal ring and the motion ring survive the re-lock, and the
    # points move by the change in window origin.
    assert torch.equal(got.data, ts.data)
    assert torch.equal(got.motion_xy, ts.motion_xy)
    shift = got.pts - ts.pts
    torch.testing.assert_close(shift, shift[:1].expand_as(shift), rtol=0,
                               atol=1e-5)
    if new_roi[0] >= 100:
        # The window left every point behind: corners are detected anew.
        assert int(got.pts_valid.sum()) == 0 and not bool(got.initialized)
    else:
        assert bool(got.initialized)


# -- interop ---------------------------------------------------------------

def test_streaming_state_interop_round_trip(update_runs):
    _, cfg, tcfg, steps = update_runs("60x80_L4S1_T16")
    js, _, ts, _, _ = steps[-1]
    d = interop.streaming_state_to_numpy(ts)
    assert sorted(d) == ["count"] + [f"levels.{k}"
                                     for k in range(len(ts.levels))]
    back = interop.streaming_state_from_numpy(d, device="cpu")
    for a, b in zip(back.levels, ts.levels):
        assert torch.equal(a, b)
    assert torch.equal(back.count, ts.count)
    # The JAX package's rings carried into the port continue there as they
    # do in JAX.
    jd = {"count": np.asarray(js.count)}
    jd.update({f"levels.{k}": np.asarray(r) for k, r in enumerate(js.levels)})
    moved = interop.streaming_state_from_numpy(jd, device="cpu")
    _assert_rings_close(moved, js, atol=0)
    frame = _drifting_clip(60, 80, 1, seed=9)[0]
    jnext, jr = jst.streaming_update(js, jnp.asarray(frame), FPS, cfg)
    tnext, tr = tst.streaming_update(moved, torch.from_numpy(frame), FPS,
                                     tcfg)
    _assert_rings_close(tnext, jnext)
    assert _located(tr) == _located(jr)
    with pytest.raises(KeyError, match="count"):
        interop.streaming_state_from_numpy({"levels.0": d["levels.0"]},
                                           device="cpu")
    with pytest.raises(KeyError, match="levels"):
        interop.streaming_state_from_numpy({"count": d["count"]},
                                           device="cpu")
