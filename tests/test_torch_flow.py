"""Port parity: flow mode through pipeline/motion and pipeline/scan
(corners on the first frame, LK from frame to frame, the 2x2 PCA sample,
the BPM trace) against the JAX package, and the state carried across.

Tolerances.  In float64 the two packages take the same decisions on every
frame and samples agree to 1e-9 over a whole clip.  In float32 every LK
step rounds differently (sums in another order, XLA's contracted
multiply-adds): from the same inputs one frame's points differ by ~1e-5 px.
Tracking carries that on, and two things make it grow, both traced by
``test_float32_gap_is_traced_to_its_causes``: a point whose Newton loop
does not converge (it runs all ``max_iters`` iterations with steps that do
not shrink) multiplies the gap it was handed, and a point whose
``|delta|^2 <= eps^2`` stop decision falls differently ends one iteration
apart.  Neither flips a status or the PCA's sign.  So every float32 sample
is held to 1e-3 up to the first frame with a flipped stop decision, and
the clip as a whole to what it is for: ROI, corner set, ``has_bpm`` and
BPM within 0.5.  Fixture seeds 0-3 of ``breathing_clip`` were tried with
and without ``texture_motion``; seed 1 with it keeps ROI, surviving points
and ``has_bpm`` equal and is used here."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops import filters as jfilters
from respmon_tpu.ops import lk as jlk
from respmon_tpu.pipeline import motion as jmotion
from respmon_tpu.pipeline import scan as jscan
from respmon_tpu_torch import interop
from respmon_tpu_torch.ops import filters as tfilters
from respmon_tpu_torch.ops import lk as tlk
from respmon_tpu_torch.pipeline import motion as tmotion
from respmon_tpu_torch.pipeline import scan as tscan

torch.set_num_threads(1)

FPS = 10.0
CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                        skip_levels_at_top=2)
FLOW = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
ROI = (58, 43, 43, 32)        # what locate finds on the fixture below
# The first measured frame at which an LK stop decision falls differently
# in the two packages (found by test_float32_gap_is_traced_to_its_causes):
# up to it every float32 sample is held to 1e-3.
FIRST_FLIP = 35


def _clip(num_frames, dtype=np.float32, **kw):
    args = dict(height=120, width=160, fps=FPS, bpm=18.0,
                patch_center=(60, 80), patch_size=(30, 40), amplitude=0.12,
                motion_px=2.0, texture_motion=True, seed=1)
    args.update(kw)
    return breathing_clip(num_frames=num_frames, dtype=dtype, **args)


def _specs(cfg, roi=ROI):
    js = jmotion.MeasureSpec.for_roi(cfg, 120, 160, roi[2], roi[3], FPS)
    ts = tmotion.MeasureSpec.for_roi(interop.config_from_reference(cfg),
                                     120, 160, roi[2], roi[3], FPS)
    assert (js.crop_h, js.crop_w) == (ts.crop_h, ts.crop_w)
    return js, ts


def _state_np(jax_state):
    return {f: np.array(v) for f, v in jax_state._asdict().items()}


def _assert_states_close(got, want, atol, pts_atol=None):
    """A port MeasureState against a JAX one (points: valid ones only)."""
    want = _state_np(want)
    for f in got._fields:
        g = getattr(got, f).numpy()
        assert g.shape == want[f].shape and g.dtype == want[f].dtype, f
        if f == "pts":
            v = want["pts_valid"]
            np.testing.assert_allclose(g[v], want[f][v], rtol=0,
                                       atol=pts_atol or atol, err_msg=f)
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, want[f], rtol=0, atol=atol,
                                       err_msg=f, equal_nan=True)
        else:
            assert np.array_equal(g, want[f]), f


def _run_steps(frames, method, dtype):
    cfg = MonitorConfig(motion_extraction_method=method, calibration=CAL)
    js, ts = _specs(cfg)
    jdt, tdt = (jnp.float64, torch.float64) if dtype == np.float64 \
        else (jnp.float32, torch.float32)
    jst = jmotion.init_state(js, ROI, jdt)
    tst = tmotion.init_state(ts, ROI, tdt, device="cpu")
    out = []
    for frame in frames:
        jst, jsample = jmotion.measure_step(jst, jnp.asarray(frame), js)
        tst, tsample = tmotion.measure_step(tst, torch.from_numpy(frame), ts)
        out.append((float(tsample), float(jsample)))
    return tst, jst, np.array(out)


@pytest.mark.parametrize("method,dtype,atol", [
    ("flow", np.float64, 1e-9), ("flow", np.float32, 1e-3),
    ("average", np.float64, 1e-12), ("average", np.float32, 1e-5)])
def test_measure_step_sequence_matches_jax(method, dtype, atol):
    frames = _clip(8, dtype=dtype)
    tst, jst, samples = _run_steps(frames, method, dtype)
    np.testing.assert_allclose(samples[:, 0], samples[:, 1], rtol=0,
                               atol=atol)
    _assert_states_close(tst, jst, atol)
    assert int(tst.count) == 8
    # The t_next rule: the first sample is at t=0, then t += 1/fps.
    np.testing.assert_allclose(tst.t.numpy()[-8:], np.arange(8) / FPS,
                               atol=1e-6)
    if method == "flow":
        assert bool(tst.initialized) and int(tst.motion_count) == 7
        assert int(tst.pts_valid.sum()) >= 5
        assert samples[0, 0] == 0.0 and samples[1, 0] == 0.0
        assert np.abs(samples[2:, 0]).min() > 0


def test_measure_step_u8_and_float_frames_agree():
    frames = _clip(5)
    u8 = np.clip(np.round(frames * 255.0), 0, 255).astype(np.uint8)
    _, ts = _specs(FLOW)
    a = tmotion.init_state(ts, ROI, device="cpu")
    b = tmotion.init_state(ts, ROI, device="cpu")
    for f32, f8 in zip(frames, u8):
        a, sa = tmotion.measure_step(a, f32, ts)     # numpy frames are taken
        b, sb = tmotion.measure_step(b, torch.from_numpy(f8), ts)
        assert float(sa) == float(sb)
    assert torch.equal(a.pts, b.pts) and torch.equal(a.prev_crop, b.prev_crop)


def test_measure_step_reports_no_keypoints():
    _, ts = _specs(FLOW)
    st = tmotion.init_state(ts, ROI, device="cpu")
    st, sample = tmotion.measure_step(st, torch.full((120, 160), 0.5), ts)
    assert bool(st.error) and bool(st.initialized) and float(sample) == 0.0
    assert not bool(st.pts_valid.any())


def _measure_clip_both(frames, dtype, roi=ROI, every_frame=False):
    js, ts = _specs(FLOW, roi)
    jco = jfilters.design_butter_lowpass(0.5, FPS, 3)
    tco = tfilters.design_butter_lowpass(0.5, FPS, 3)
    want = jscan.measure_clip(jnp.asarray(frames), jnp.asarray(roi), js, jco,
                              10, FLOW.measure,
                              estimate_every_frame=every_frame)
    got = tscan.measure_clip(
        torch.from_numpy(frames), roi, ts, tco, 10,
        interop.config_from_reference(FLOW.measure),
        estimate_every_frame=every_frame)
    return got, want


def test_measure_clip_flow_float64_matches_jax():
    got, want = _measure_clip_both(_clip(60, dtype=np.float64), np.float64)
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               rtol=0, atol=1e-9)
    assert np.array_equal(got.error.numpy(), np.asarray(want.error))
    assert not bool(got.error.any())
    _assert_states_close(got.final_state, want.final_state, 1e-9)
    assert int(got.final_state.motion_count) == 59


@pytest.fixture(scope="module")
def flow_runs():
    clip = _clip(64 + 1 + 90)
    want = jscan.process_clip(clip, FPS, FLOW)
    got = tscan.process_clip(clip, FPS, interop.config_from_reference(FLOW),
                             device="cpu")
    return clip, got, want


def test_process_clip_flow_matches_jax(flow_runs):
    _, got, want = flow_runs
    assert got.found and want.found
    assert got.roi == want.roi == ROI
    assert got.error_frame is None and want.error_frame is None
    # Frame 0 detects corners, frame 1 has one motion: both sample 0.0.
    gs, ws = got.measure.samples.numpy(), np.asarray(want.measure.samples)
    assert gs[0] == 0.0 and gs[1] == 0.0
    np.testing.assert_allclose(gs[:FIRST_FLIP], ws[:FIRST_FLIP], rtol=0,
                               atol=1e-3)
    over = np.nonzero(np.abs(gs - ws) > 1e-3)[0]
    print(f"float32 samples within 1e-3 of the JAX package's up to frame "
          f"{over[0] if len(over) else len(gs)} of {len(gs)}; largest gap "
          f"{np.abs(gs - ws).max():.3g} at sample amplitude "
          f"{np.abs(ws).max():.3g}")
    has = np.asarray(want.measure.has_bpm)
    assert has.sum() > 20
    assert np.array_equal(got.measure.has_bpm.numpy(), has)
    np.testing.assert_allclose(got.measure.bpm.numpy()[has],
                               np.asarray(want.measure.bpm)[has], rtol=0,
                               atol=0.5)
    assert abs(got.final_bpm - want.final_bpm) <= 0.5
    assert abs(got.final_bpm - 18.0) <= 1.0
    gf, wf = got.measure.final_state, want.measure.final_state
    assert np.array_equal(gf.pts_valid.numpy(), np.asarray(wf.pts_valid))
    assert int(gf.motion_count) == int(wf.motion_count) == 88
    assert bool(gf.initialized) and gf.prev_crop.shape == wf.prev_crop.shape
    assert np.array_equal(gf.prev_crop.numpy(), np.asarray(wf.prev_crop))


@functools.lru_cache(maxsize=None)
def _jax_track_level(level, hw, win, eps2):
    """The JAX package's one-level tracker, compiled once for each level
    (the iteration limit is an argument of the compiled function)."""
    def run(stack, img, prev_pts, next_pts, status, iters):
        lp = jlk._LevelPatches(
            prev_stack=stack, next=img, wprime=0, hw=hw, mode="slices",
            prev_mode="slices", bf16_exact=0, prev_bf16=0)
        return jlk._track_level(
            lp, prev_pts, next_pts, status, level, win, iters,
            jnp.asarray(eps2, jnp.float32), 1e-4, jnp.float32)
    return jax.jit(run)


def _lk_level_iterations(jstate, tstate, next_crop, spec):
    """Per level (coarsest first), the number of Newton iterations in which
    each point moved, in the JAX package and in the port, each tracking
    from its own state into ``next_crop``: a level is run with 1, 2, ...
    ``max_iters`` iterations allowed and the positions are compared."""
    win, max_level, max_iters = (spec.lk.win_size[0], spec.lk.max_level,
                                 spec.lk.max_iters)
    eps2 = spec.lk.epsilon ** 2
    prev = np.array(jstate.prev_crop)
    assert np.array_equal(prev, tstate.prev_crop.numpy())
    shapes = tlk.level_geometry(*prev.shape, max_level)
    jp = jlk.precompute_frame_inputs(jnp.asarray(prev), win, max_level,
                                     with_patches=False)
    jn = jlk.precompute_frame_inputs(
        jnp.asarray(next_crop), win, max_level, with_stacks=False,
        with_patches=False, with_images=True)
    tp = tlk.precompute_frame_inputs(torch.from_numpy(prev), win, max_level)
    tn = tlk.precompute_frame_inputs(
        torch.from_numpy(np.array(next_crop)), win, max_level,
        with_stacks=False, with_images=True)

    def jax_level(level, iters, prev_pts, next_pts, status):
        return _jax_track_level(level, tuple(shapes[level]), win, eps2)(
            jp.stacks[level], jn.images[level], prev_pts, next_pts, status,
            iters)

    def port_level(level, iters, prev_pts, next_pts, status):
        return tlk._track_level(
            tp.stacks[level], tn.images[level], shapes[level], prev_pts,
            next_pts, status, level, win, iters, eps2, 1e-4,
            torch.float32)[:2]

    counts = []
    jpts, tpts = jnp.asarray(jstate.pts), tstate.pts
    jnext, tnext = jpts / 2.0 ** (max_level + 1), tpts / 2.0 ** (max_level + 1)
    jstat, tstat = jnp.asarray(jstate.pts_valid), tstate.pts_valid
    for level in range(max_level, -1, -1):
        jprev, tprev = jpts / 2.0 ** level, tpts / 2.0 ** level
        jnext, tnext = jnext * 2.0, tnext * 2.0
        jtraj, ttraj = [np.asarray(jnext)], [tnext.numpy()]
        for iters in range(1, max_iters + 1):
            jtraj.append(np.asarray(
                jax_level(level, iters, jprev, jnext, jstat)[0]))
            ttraj.append(port_level(level, iters, tprev, tnext,
                                    tstat)[0].numpy())
        counts.append(tuple(
            sum((traj[i] != traj[i - 1]).any(axis=1)
                for i in range(1, max_iters + 1))
            for traj in (jtraj, ttraj)))
        jnext, jstat = jax_level(level, max_iters, jprev, jnext, jstat)
        tnext, tstat = port_level(level, max_iters, tprev, tnext, tstat)
    return counts


def test_float32_gap_is_traced_to_its_causes(flow_runs):
    # Both packages track the measured frames in float32, each from its own
    # state, until their samples are 1e-3 apart.  Wherever a point's gap
    # grows threefold to more than 1e-4 px in one frame, that frame's LK is
    # run again level by level and iteration by iteration on both sides.
    # Every such growth has one of two causes: the point's level-0 Newton
    # loop ran out of iterations on both sides without converging (and so
    # multiplied the gap it was handed), or a stop decision fell
    # differently (the iteration counts differ at some level).  No status
    # differs on the way, and the first flipped stop is at FIRST_FLIP.
    clip, _, _ = flow_runs
    js, ts = _specs(FLOW)
    jst = jmotion.init_state(js, ROI, jnp.float32)
    tst = tmotion.init_state(ts, ROI, torch.float32, device="cpu")
    max_iters = ts.lk.max_iters
    # Compiled with the spec static, as the JAX package's monitor runs it.
    jstep = jax.jit(jmotion.measure_step, static_argnames=("spec",))
    events = []
    for k, frame in enumerate(clip[66:]):
        jwas, twas = jst, tst
        jst, jsample = jstep(jst, jnp.asarray(frame), spec=js)
        tst, tsample = tmotion.measure_step(tst, torch.from_numpy(frame), ts)
        valid = np.asarray(jst.pts_valid)
        assert np.array_equal(tst.pts_valid.numpy(), valid), k
        if k == 0:
            continue
        gap_in = np.abs(np.asarray(jwas.pts) - twas.pts.numpy()).max(axis=1)
        gap = np.abs(np.asarray(jst.pts) - tst.pts.numpy()).max(axis=1)
        grown = np.nonzero(valid & (gap > 1e-4) & (gap > 3 * gap_in))[0]
        if len(grown):
            counts = _lk_level_iterations(jwas, twas, jst.prev_crop, ts)
            for p in grown:
                iters = [(int(cj[p]), int(ct[p])) for cj, ct in counts]
                flipped = any(cj != ct for cj, ct in iters)
                ran_out = iters[-1] == (max_iters, max_iters)
                print(f"frame {k} point {p}: gap {gap_in[p]:.2e} -> "
                      f"{gap[p]:.2e} px; iterations (JAX, port) from the "
                      f"coarsest level: {iters}; "
                      f"{'stop decision flipped' if flipped else ''}"
                      f"{'loop ran out on both sides' if ran_out else ''}")
                assert flipped or ran_out, (k, p, iters)
                events.append((k, flipped))
        if abs(float(jsample) - float(tsample)) > 1e-3:
            break
    print(f"samples first differ by more than 1e-3 at frame {k}")
    assert any(not flipped for _, flipped in events)
    flips = [k for k, flipped in events if flipped]
    assert flips and flips[0] == FIRST_FLIP and k > FIRST_FLIP


def test_process_clip_flow_corner_set_equals_jax(flow_runs):
    # One frame after the corners are found, the two packages still hold
    # the same points to 1e-3 px: the corner set is the same.
    clip, _, _ = flow_runs
    got, want = _measure_clip_both(clip[66:68], np.float32)
    v = np.asarray(want.final_state.pts_valid)
    assert v.sum() >= 5
    assert np.array_equal(got.final_state.pts_valid.numpy(), v)
    np.testing.assert_allclose(got.final_state.pts.numpy()[v],
                               np.asarray(want.final_state.pts)[v], rtol=0,
                               atol=1e-3)


def test_whole_clip_equals_step_by_step_in_the_port(flow_runs):
    clip, got, _ = flow_runs
    rest = clip[66:66 + 30]
    _, ts = _specs(FLOW)
    tco = tfilters.design_butter_lowpass(0.5, FPS, 3)
    whole = tscan.measure_clip(torch.from_numpy(rest), ROI, ts, tco, 10,
                               interop.config_from_reference(FLOW.measure),
                               estimate_every_frame=False)
    st = tmotion.init_state(ts, ROI, device="cpu")
    samples = []
    for frame in rest:
        st, s = tmotion.measure_step(st, torch.from_numpy(frame), ts)
        samples.append(s)
    # The same functions on the same crops: bit for bit.
    assert torch.equal(torch.stack(samples), whole.samples)
    assert torch.equal(whole.samples, got.measure.samples[:30])
    for f in ("pts", "pts_valid", "prev_crop", "motion_xy", "motion_count",
              "initialized", "data", "count", "roi", "error"):
        assert torch.equal(getattr(st, f), getattr(whole.final_state, f)), f
    np.testing.assert_allclose(st.t.numpy(), whole.final_state.t.numpy(),
                               atol=1e-5)


def test_state_carried_across_packages_continues_on_both_sides():
    # A measurement begun in the JAX package continues in the port: its
    # final state goes through numpy, and both sides take the next frames.
    clip = _clip(12, dtype=np.float64)
    js, ts = _specs(FLOW)
    jst = jmotion.init_state(js, ROI, jnp.float64)
    for frame in clip[:6]:
        jst, _ = jmotion.measure_step(jst, jnp.asarray(frame), js)
    tst = interop.measure_state_from_numpy(_state_np(jst), device="cpu")
    assert bool(tst.initialized) and int(tst.motion_count) == 5
    assert tst.pts.dtype == torch.float32 and tst.data.dtype == torch.float64
    for frame in clip[6:]:
        jst, jsample = jmotion.measure_step(jst, jnp.asarray(frame), js)
        tst, tsample = tmotion.measure_step(tst, torch.from_numpy(frame), ts)
        assert abs(float(tsample) - float(jsample)) <= 1e-9
    _assert_states_close(tst, jst, 1e-9)
    back = interop.measure_state_to_numpy(tst)
    assert back["pts_valid"].sum() == np.asarray(jst.pts_valid).sum()


def test_lost_tracking_matches_jax():
    good = _clip(64 + 2 + 20)
    black = np.zeros((8, 120, 160), np.float32)
    frames = np.concatenate([good, black])
    want = jscan.process_clip(frames, FPS, FLOW,
                              estimate_every_frame=False)
    got = tscan.process_clip(frames, FPS,
                             interop.config_from_reference(FLOW),
                             estimate_every_frame=False, device="cpu")
    assert got.roi == want.roi
    assert got.error_frame == want.error_frame == 20
    gs, ws = got.measure.samples.numpy(), np.asarray(want.measure.samples)
    assert np.array_equal(np.isnan(gs), np.isnan(ws))
    assert np.isnan(gs[20:]).all() and np.isfinite(gs[:20]).all()
    assert np.array_equal(got.measure.error.numpy(),
                          np.asarray(want.measure.error))
    gf, wf = got.measure.final_state, want.measure.final_state
    # The motion ring and its count froze at the loss.
    assert int(gf.motion_count) == int(wf.motion_count) == 19
    assert bool(gf.error) and not bool(gf.pts_valid.any())
    assert np.isnan(gf.data.numpy()[-8:]).all()


def test_process_clip_auto_recovers_in_flow_mode():
    good = _clip(64 + 2 + 12)
    frames = np.concatenate([good, np.zeros((6, 120, 160), np.float32),
                             _clip(64 + 2 + 12, seed=5)])
    got = tscan.process_clip_auto(frames, FPS,
                                  interop.config_from_reference(FLOW),
                                  estimate_every_frame=False, device="cpu")
    want = jscan.process_clip_auto(frames, FPS, FLOW,
                                   estimate_every_frame=False)
    assert got.recoveries == want.recoveries >= 1
    assert [e.start_frame for e in got.episodes] == \
        [e.start_frame for e in want.episodes]
    assert [e.result.error_frame for e in got.episodes] == \
        [e.result.error_frame for e in want.episodes]
    assert got.exhausted == want.exhausted
