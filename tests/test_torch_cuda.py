"""The port on an NVIDIA GPU: CUDA kernels against their plain versions,
and the card's results against the CPU's.  Every test here needs a card
and skips without one.  The file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -o addopts="" --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.ops import _build, pyramid_cuda, pyramid_mm
from respmon_tpu_torch.ops.dtype import uint8_to_float
from respmon_tpu_torch.pipeline import evm, scan

pytestmark = pytest.mark.cuda

CAL = CalibrationConfig(pyramid_levels=6, skip_levels_at_top=2,
                        buffer_length=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _video(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)


def test_uint8_to_float_all_bytes(dev):
    b = np.arange(256, dtype=np.uint8)
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got = uint8_to_float(torch.from_numpy(b).to(dev)).cpu().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape,levels,skip", [((3, 135, 192), 7, 3),
                                               ((2, 5, 7), 3, 0),
                                               ((1, 1, 1), 2, 0),
                                               ((2, 480, 640), 9, 4),
                                               ((2, 481, 643), 9, 4),
                                               ((2, 480, 640), 9, 1),
                                               ((2, 1080, 1920), 9, 4),
                                               ((1, 480, 640), 9, 4),
                                               ((1, 1080, 1920), 9, 4)])
def test_kernels_equal_plain_bit_for_bit(dev, shape, levels, skip):
    v = _video(shape, dev)
    plan = pyramid_cuda.plan(*shape[1:], levels, skip)
    _build.reset_launches()
    got = pyramid_cuda.laplacian_band_levels(v, levels, skip)
    downs = [d for _, d in plan.downs]
    assert _build.LAUNCHES == dict(dict.fromkeys(_build.LAUNCHES, 0),
                                   pyr_down_levels_d1=downs.count(1),
                                   pyr_down_levels_d2=downs.count(2),
                                   pyr_tail=int(plan.tail),
                                   lap_level=len(plan.laps))
    want = pyramid_cuda.laplacian_band_levels_ref(v, levels, skip)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for s1 in (1, 2, 3):
        assert torch.equal(pyramid_cuda.gauss_level(v, s1),
                           pyramid_cuda.gauss_level_ref(v, s1))


@pytest.mark.parametrize("shape,d", [((20, 481, 643), 1), ((20, 481, 643), 2),
                                     ((20, 243, 647), 2), ((9, 480, 640), 2),
                                     ((70_000, 5, 7), 1)])
def test_fused_pyr_down_walks_frames(dev, shape, d):
    # More frames than frame groups (and, last, than a grid's z extent):
    # each block walks several frames through its two stage buffers.
    v = _video(shape, dev)
    assert torch.equal(pyramid_cuda.pyr_down(v, d),
                       pyramid_cuda.gauss_level_ref(v, d))


@pytest.mark.parametrize("shape,levels,first", [((300, 30, 41), 5, 1),
                                                ((3, 119, 161), 8, 0),
                                                ((2, 1, 9), 4, 2)])
def test_tail_kernel_equals_plain(dev, shape, levels, first):
    v = _video(shape, dev)
    got = pyramid_cuda.pyr_tail(v, levels, first)
    want = pyramid_cuda.laplacian_band_levels_ref(v, levels, first)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    v = _video((2, 16, 16), dev)
    with pytest.raises(TypeError):
        pyramid_cuda.pyr_down(v.double())
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_down(v.transpose(1, 2))
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_down(v[0])
    with pytest.raises(ValueError):
        pyramid_cuda.lap_level(v, v[:, :4, :4].contiguous())
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_down(v, pyramid_cuda.MAX_FUSED + 1)
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_tail(v, 3, 2)
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_tail(_video((1, 480, 640), dev), 9, 4)


def test_locate_constant_video_not_found(dev):
    vid = torch.full((32, 48, 64), 0.5, device=dev)
    cfg = CalibrationConfig(pyramid_levels=4, skip_levels_at_top=1,
                            buffer_length=32)
    assert not bool(evm.locate(vid, 10.0, cfg).found)


def test_process_clip_card_matches_cpu(dev):
    clip = breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=10.0, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    cfg = MonitorConfig(calibration=CAL)
    got = scan.process_clip(clip, 10.0, cfg)      # the card is the default
    assert got.measure.samples.device.type == "cuda"
    want = scan.process_clip(clip, 10.0, cfg, device="cpu")
    assert got.found and got.roi == want.roi
    has = want.measure.has_bpm
    assert torch.equal(got.measure.has_bpm.cpu(), has)
    np.testing.assert_allclose(got.measure.bpm.cpu()[has].numpy(),
                               want.measure.bpm[has].numpy(), rtol=1e-5)


@pytest.mark.parametrize("shape,levels,skip", [((3, 135, 192), 7, 3),
                                               ((2, 5, 7), 3, 0),
                                               ((1, 1, 1), 2, 0),
                                               ((2, 480, 640), 9, 4)])
def test_band_kernels_match_matmul_and_the_stencil_kernels(dev, shape, levels,
                                                           skip):
    # Summation order differs from torch.matmul's and from the stencil's:
    # atol 1e-5, the bar of the TPU kernel's own test.
    v = _video(shape, dev)
    _build.reset_launches()
    got = pyramid_mm.laplacian_band_levels_mm(v, levels, skip)
    n = (levels - 1) + (levels - 1 - skip)
    assert _build.LAUNCHES == dict(dict.fromkeys(_build.LAUNCHES, 0),
                                   band_left=n, band_right=n)
    ref = pyramid_mm.laplacian_band_levels_mm_ref(v, levels, skip)
    k1 = pyramid_cuda.laplacian_band_levels(v, levels, skip)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["band_left"] == _build.LAUNCHES["band_right"] == n
    for g, r, k in zip(got, ref, k1):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-5
        assert float((g - k).abs().max()) <= 1e-5


N_BAND_CASES = 16


@pytest.mark.parametrize("index", range(N_BAND_CASES))
def test_band_kernels_corner_cases_match_matmul(dev, index):
    # The cases of chip_smoke.py: dense matrices with and without ranges,
    # an all-zero tile, operands that 16-byte copies cannot take, more
    # frames than a grid's z extent, the minuend form.  rtol 1e-5 of the result's largest magnitude: the
    # kernel sums in another order and adds two TF32 terms per product.
    import chip_smoke

    cases = chip_smoke.band_parity_cases(dev)
    assert len(cases) == N_BAND_CASES
    name, side, (a, b, minuend) = cases[index]
    matrix = a.matrix if isinstance(a, pyramid_mm.BandOperator) else a
    _build.reset_launches()
    if side == "left":
        got, want = pyramid_mm.band_left(a, b), torch.matmul(matrix, b)
    else:
        got = pyramid_mm.band_right(b, a, minuend)
        want = pyramid_mm._matmul_right(b, matrix, minuend)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"band_{side}"] == 1, name
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale, name


def test_band_kernels_with_ranges_equal_the_full_walk(dev):
    # The pyramid's operators: skipping the slabs outside a tile's range
    # leaves out only products with zeros, so the result is the same sum.
    v = _video((3, 480, 640), dev)
    dh, dw_t, _, _ = pyramid_mm._operators(480, 640, 9, 4, v.device)
    half = pyramid_mm.band_left(dh[0], v)
    bare = pyramid_mm.band_left(dataclasses.replace(dh[0], ranges=torch.tensor(
        [[0, 480]] * 4, dtype=torch.int32, device=dev)), v)
    assert float((half - bare).abs().max()) <= 1e-6
    got = pyramid_mm.band_right(half, dw_t[0])
    want = torch.matmul(half, dw_t[0].matrix)
    assert float((got - want).abs().max()) <= 1e-5


def test_band_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = _video((8, 16), dev)
    b = _video((2, 16, 12), dev)
    with pytest.raises(TypeError):
        pyramid_mm.band_left(a.double(), b)
    with pytest.raises(ValueError):
        pyramid_mm.band_left(a, b.transpose(1, 2))
    with pytest.raises(ValueError):
        pyramid_mm.band_left(a[:, :8].contiguous(), b)
    with pytest.raises(ValueError):
        pyramid_mm.band_left(a.cpu(), b)
    with pytest.raises(ValueError):
        pyramid_mm.band_right(b, a)
    with pytest.raises(ValueError):
        pyramid_mm.band_right(b, _video((12, 5), dev), minuend=b)
    op = pyramid_mm.band_operator(a.cpu().numpy(), "left", dev)
    with pytest.raises(ValueError):
        pyramid_mm.band_right(b, op)
    with pytest.raises(ValueError):
        dataclasses.replace(op, ranges=op.ranges.cpu())


def test_flow_process_clip_card_matches_cpu(dev):
    # Float32 tracking amplifies rounding from frame to frame, so the card
    # is held to the CPU by what the samples are for: ROI, surviving
    # points, has_bpm, and BPM within 0.5 (seed 1 of the fixture keeps
    # every decision equal; seeds 0-3 were tried).
    clip = breathing_clip(num_frames=64 + 1 + 90, height=120, width=160,
                          fps=10.0, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12, motion_px=2.0,
                          texture_motion=True, seed=1)
    cfg = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
    got = scan.process_clip(clip, 10.0, cfg)
    want = scan.process_clip(clip, 10.0, cfg, device="cpu")
    assert got.found and got.roi == want.roi
    assert got.error_frame is None and want.error_frame is None
    assert torch.equal(got.measure.final_state.pts_valid.cpu(),
                       want.measure.final_state.pts_valid)
    has = want.measure.has_bpm
    assert torch.equal(got.measure.has_bpm.cpu(), has)
    np.testing.assert_allclose(got.measure.bpm.cpu()[has].numpy(),
                               want.measure.bpm[has].numpy(), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(got.measure.samples.cpu().numpy()[:8],
                               want.measure.samples.numpy()[:8], rtol=0,
                               atol=1e-3)


def test_monitor_card_matches_cpu(dev):
    # The live monitor on the card (its default) against the CPU, frame
    # for frame: the same state after every step, ROI and BPM trace.
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.runtime import RespiratoryMonitor

    clip = breathing_clip(num_frames=64 + 1 + 60, height=120, width=160,
                          fps=10.0, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    runs = []
    for device in (None, "cpu"):
        mon = RespiratoryMonitor(
            capture=ArrayCapture(clip, fps=10.0), visualize=None,
            save_all_data=False, sync_fps=False, auto_run=False,
            config=MonitorConfig(calibration=CAL), device=device)
        trace = []
        while mon.step():
            trace.append(mon.state)
        runs.append((mon, trace))
    (card, card_trace), (cpu, cpu_trace) = runs
    assert card.device.type == "cuda"
    assert card._measure_state.data.device.type == "cuda"
    assert card_trace == cpu_trace and card.state == "measure"
    assert (card.x, card.y, card.w, card.h) == (cpu.x, cpu.y, cpu.w, cpu.h)
    assert len(card.freq) == len(cpu.freq) > 0
    np.testing.assert_allclose(np.asarray(card.freq), np.asarray(cpu.freq),
                               rtol=1e-5)


def test_streaming_absorb_launches_k1_at_t1_and_equals_cpu(dev):
    # Every absorbed frame is one K1 call at T = 1 on the card, and the
    # rings equal the CPU's bit for bit.
    from respmon_tpu_torch.pipeline import streaming

    clip = breathing_clip(num_frames=66, height=120, width=160, fps=10.0,
                          bpm=18.0, patch_center=(50, 60),
                          patch_size=(20, 25), amplitude=0.12,
                          drift_px=(10.0, 20.0))
    u8 = torch.from_numpy(np.clip(np.round(clip * 255.0), 0, 255).astype(
        np.uint8))
    states = {}
    for device in (dev, torch.device("cpu")):
        st = streaming.init_streaming_from_buffer(u8[:64].to(device), CAL)
        _build.reset_launches()
        st = streaming.streaming_absorb(st, u8[64].to(device), CAL)
        st, res = streaming.streaming_update(st, u8[65].to(device), 10.0, CAL)
        states[device.type] = (st, res, dict(_build.LAUNCHES))
    (card, card_res, launches), (cpu, cpu_res, _) = states["cuda"], \
        states["cpu"]
    assert launches["pyr_tail"] == 2
    for a, b in zip(card.levels, cpu.levels):
        assert torch.equal(a.cpu(), b)
    assert bool(card_res.found) == bool(cpu_res.found)
    assert [int(v) for v in (card_res.x, card_res.y, card_res.w,
                             card_res.h)] == \
        [int(v) for v in (cpu_res.x, cpu_res.y, cpu_res.w, cpu_res.h)]
    assert torch.equal(card_res.heatmap_u8.cpu(), cpu_res.heatmap_u8)


def test_locate_iir_card_matches_cpu(dev):
    clip = breathing_clip(num_frames=64, height=120, width=160, fps=10.0,
                          bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    cfg = dataclasses.replace(CAL, temporal_filter="iir")
    vid = torch.from_numpy(clip)
    got = evm.locate(vid.to(dev), 10.0, cfg)
    want = evm.locate(vid, 10.0, cfg)
    assert bool(got.found) and bool(want.found)
    assert [int(v) for v in (got.x, got.y, got.w, got.h)] == \
        [int(v) for v in (want.x, want.y, want.w, want.h)]


def test_streaming_monitor_card_matches_cpu(dev):
    # The streaming-ROI monitor on the card against the CPU, frame for
    # frame: the state, the re-lock count and the ROI after every step.
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.runtime import RespiratoryMonitor

    clip = breathing_clip(num_frames=64 + 1 + 1 + 64, height=120, width=160,
                          fps=10.0, bpm=18.0, patch_center=(50, 60),
                          patch_size=(20, 25), amplitude=0.12,
                          drift_px=(20.0, 40.0))
    runs = []
    for device in (None, "cpu"):
        mon = RespiratoryMonitor(
            capture=ArrayCapture(clip, fps=10.0), visualize=None,
            save_all_data=False, sync_fps=False, auto_run=False,
            config=MonitorConfig(calibration=CAL, streaming_roi=True),
            device=device)
        trail = []
        while mon.step():
            trail.append((mon.state, mon.relocks, (mon.x, mon.y, mon.w,
                                                   mon.h)))
        runs.append((mon, trail))
    (card, card_trail), (cpu, cpu_trail) = runs
    assert card._streaming_state.levels[0].device.type == "cuda"
    assert card_trail == cpu_trail and card.state == "measure"
    assert card.relocks >= 1
    np.testing.assert_allclose(np.asarray(card.freq), np.asarray(cpu.freq),
                               rtol=1e-5)


# -- the multi-stream fleet --------------------------------------------------

def _fleet_clips(n, s=3, method="average"):
    flow = method == "flow"
    return np.stack([breathing_clip(
        num_frames=n, height=60, width=80, fps=10.0, bpm=18.0,
        patch_center=(30, 40), patch_size=(16, 20), amplitude=0.25,
        noise=0.002, motion_px=1.5 if flow else 0.0, texture_motion=flow,
        seed=i) for i in range(s)])


@pytest.mark.parametrize("method", ["average", "flow"])
def test_fleet_card_matches_cpu(dev, method):
    # The fleet's calibration and steps on the card against the CPU: the
    # same boxes and error flags; samples to 1e-5 in average mode, to 1e-3
    # over these few float32 flow steps.
    from respmon_tpu_torch.parallel import streams

    cfg = MonitorConfig(motion_extraction_method=method,
                        calibration=CalibrationConfig(
                            buffer_length=32, pyramid_levels=4,
                            skip_levels_at_top=1))
    clips = _fleet_clips(40, method=method)
    mons = [streams.MultiStreamMonitor(cfg, None, (60, 80), 10.0,
                                       device=d) for d in (None, "cpu")]
    boxes = [m.calibrate(clips[:, :32]).boxes.cpu() for m in mons]
    assert mons[0].device.type == "cuda" and torch.equal(*boxes)
    for f in range(33, 40):
        a, b = (m.step(clips[:, f]) for m in mons)
        assert torch.equal(a.error.cpu(), b.error)
        tol = 1e-5 if method == "average" else 1e-3
        np.testing.assert_allclose(a.samples.cpu().numpy(),
                                   b.samples.numpy(), rtol=0, atol=tol)


def test_fleet_absorb_and_warm_start_launch_k1_and_equal_plain(dev):
    # K1 at (S, H, W) (one absorb) and at (S * T, H, W) (the warm start)
    # launches its plan once per call and equals the plain pyramid.
    from respmon_tpu_torch.pipeline import streaming

    cal = CalibrationConfig()
    clips = torch.from_numpy(np.stack([
        breathing_clip(num_frames=129, height=480, width=640, seed=i)
        for i in range(2)])).to(dev)
    _build.reset_launches()
    rings = streaming.init_streaming_from_buffers_batch(clips[:, :128], cal)
    rings = streaming.streaming_absorb_batch(rings, clips[:, 128], cal)
    assert _build.LAUNCHES["pyr_tail"] == 2
    assert _build.LAUNCHES["pyr_down_levels_d2"] == 2
    saved = pyramid_cuda.laplacian_band_levels
    pyramid_cuda.laplacian_band_levels = \
        pyramid_cuda.laplacian_band_levels_ref
    try:
        ref = streaming.init_streaming_from_buffers_batch(clips[:, :128],
                                                          cal)
        ref = streaming.streaming_absorb_batch(ref, clips[:, 128], cal)
    finally:
        pyramid_cuda.laplacian_band_levels = saved
    assert all(torch.equal(a, b) for a, b in zip(rings.levels, ref.levels))


def test_batched_corners_equal_per_image_on_the_card(dev):
    from respmon_tpu_torch.ops import corners

    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(np.trunc(rng.random((3, 48, 64)) * 255.0)
                            .astype(np.float32)).to(dev)
    mask = torch.zeros((3, 48, 64), dtype=torch.bool, device=dev)
    mask[0, 4:40, 6:60] = True
    mask[1, 10:48, 0:50] = True
    mask[2] = True
    got = corners.good_features_to_track_batch(imgs, roi_mask=mask)
    for i in range(3):
        one = corners.good_features_to_track(imgs[i], roi_mask=mask[i])
        assert torch.equal(got.valid[i], one.valid)
        assert torch.equal(got.pts[i], one.pts)
