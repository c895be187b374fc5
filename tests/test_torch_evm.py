"""Port parity: ops/ccl and pipeline/evm against the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops import ccl as jccl
from respmon_tpu.pipeline import evm as jevm
from respmon_tpu_torch.ops import ccl as tccl
from respmon_tpu_torch.pipeline import evm as tevm

torch.set_num_threads(1)

CFG = CalibrationConfig(pyramid_levels=6, skip_levels_at_top=2,
                        buffer_length=64)


@pytest.fixture(scope="module")
def clip():
    return breathing_clip(num_frames=64, height=120, width=160, fps=10.0,
                          bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          dtype=np.float32)


def _bbox(r):
    return tuple(int(v) for v in (r.x, r.y, r.w, r.h))


def _blobby(seed, h=60, w=80, nblobs=4):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(nblobs):
        cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
        ry, rx = rng.integers(2, 12), rng.integers(2, 12)
        img |= (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
    return img


def _thin_l():
    img = np.zeros((40, 50), bool)
    img[5, 5:30] = True
    img[5:20, 5] = True
    img[30:34, 40:44] = True
    return img


def _donut():
    img = np.zeros((40, 60), bool)
    img[5:25, 5:25] = True
    img[8:22, 8:22] = False
    img[10:26, 35:51] = True
    return img


def _staircase():
    img = np.zeros((40, 50), bool)
    for i in range(30):
        img[i, i] = True
    img[33:38, 10:15] = True
    return img


def _nested():
    img = np.zeros((30, 30), bool)
    img[2:28, 2:28] = True
    img[5:25, 5:25] = False
    img[10:20, 10:20] = True
    return img


def _noise(seed):
    return np.random.default_rng(200 + seed).random((36, 44)) < 0.25


CASES = ([(f"blobby{s}", lambda s=s: _blobby(s)) for s in range(4)]
         + [(f"noise{s}", lambda s=s: _noise(s)) for s in range(2)]
         + [("thin_l", _thin_l), ("donut", _donut),
            ("staircase", _staircase), ("nested", _nested),
            ("empty", lambda: np.zeros((16, 16), bool)),
            ("full", lambda: np.ones((8, 12), bool)),
            ("single", lambda: np.arange(100).reshape(10, 10) == 23)])


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_largest_component_bbox_matches_jax(name, make):
    img = make()
    got = tccl.largest_component_bbox(torch.from_numpy(img))
    want = jccl.largest_component_bbox(jnp.asarray(img))
    assert bool(got.found) == bool(want.found)
    if bool(want.found):
        assert _bbox(got) == _bbox(want)
        assert float(got.area) == float(want.area)


@pytest.mark.parametrize("make", [_donut, _nested, lambda: _noise(5)])
def test_labels_and_holes_match_jax(make):
    img = make()
    got = tccl.label_components(torch.from_numpy(img)).numpy()
    want = np.asarray(jccl.label_components(jnp.asarray(img)))
    assert np.array_equal(got, want)
    got_f = tccl.fill_holes(torch.from_numpy(img)).numpy()
    want_f = np.asarray(jccl.fill_holes(jnp.asarray(img)))
    assert np.array_equal(got_f, want_f)


def test_locate_bbox_and_heatmap_match_jax(clip):
    got = tevm.locate(torch.from_numpy(clip), 10.0, CFG)
    want = jevm.locate(jnp.asarray(clip), 10.0, CFG)
    assert bool(got.found) and bool(want.found)
    assert _bbox(got) == _bbox(want)
    assert np.array_equal(got.heatmap_u8.numpy(), np.asarray(want.heatmap_u8))
    assert np.array_equal(got.thresh.numpy(), np.asarray(want.thresh))
    # raw_heat_u8 is the normalised T-mean of a bandpassed video (a
    # rounding-noise image, diagnostic only): shape and type only.
    assert got.raw_heat_u8.shape == want.raw_heat_u8.shape
    assert got.raw_heat_u8.dtype == torch.uint8


def test_locate_u8_equals_float_ingest(clip):
    u8 = np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)
    f = (u8.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got_u8 = tevm.locate(torch.from_numpy(u8), 10.0, CFG)
    got_f = tevm.locate(torch.from_numpy(f), 10.0, CFG)
    assert _bbox(got_u8) == _bbox(got_f)
    assert torch.equal(got_u8.heatmap_u8, got_f.heatmap_u8)


def test_evm_bandpass_matches_jax(clip):
    got = tevm.eulerian_magnification_bandpass(torch.from_numpy(clip), 10.0,
                                               CFG)
    want = jax.jit(jevm.eulerian_magnification_bandpass,
                   static_argnames=("fps", "cfg"))(jnp.asarray(clip), fps=10.0,
                                                   cfg=CFG)
    scale = np.abs(np.asarray(want.raw)).max()
    for g, w in ((got.raw, want.raw), (got.masked, want.masked)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)


def _constant_case():
    vid = np.full((32, 48, 64), 0.5, np.float32)
    cfg = CalibrationConfig(pyramid_levels=4, skip_levels_at_top=1,
                            buffer_length=32)
    return vid, cfg


def test_locate_not_found_on_constant_video():
    # Zero bandpass energy: min-max normalisation gives NaN, the NaN -> int
    # cast is platform-defined, and the heatmap must still fail the
    # threshold (the reference's None/retry path).
    vid, cfg = _constant_case()
    got = tevm.locate(torch.from_numpy(vid), 10.0, cfg)
    assert not bool(got.found)
    assert not bool(jevm.locate(jnp.asarray(vid), 10.0, cfg).found)


def test_locate_verbose_equals_locate_and_the_jax_verbose(clip, caplog):
    # The per-stage timed variant (reference transforms.py verbose=True):
    # the port's locate bit for bit, the JAX package's verbose locate in
    # bbox, heatmap and threshold, and one log line per stage.
    import logging

    vid = torch.from_numpy(clip)
    with caplog.at_level(logging.INFO,
                         logger="respmon_tpu_torch.pipeline.evm"):
        got = tevm.locate_verbose(vid, 10.0, CFG)
    want = tevm.locate(vid, 10.0, CFG)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    jax_got = jevm.locate_verbose(jnp.asarray(clip), 10.0, CFG)
    assert bool(got.found) and bool(jax_got.found)
    assert _bbox(got) == _bbox(jax_got)
    assert np.array_equal(got.heatmap_u8.numpy(),
                          np.asarray(jax_got.heatmap_u8))
    assert np.array_equal(got.thresh.numpy(), np.asarray(jax_got.thresh))
    text = caplog.text
    kept = CFG.pyramid_levels - 1 - CFG.skip_levels_at_top
    assert text.count("create_laplacian_video_pyramid") == 1
    assert text.count("temporal_bandpass_filter") == kept
    assert text.count("collapse_laplacian_video_pyramid") == 1
    assert text.count("Frame Average") == kept + 2
    evm_v = tevm.eulerian_magnification_bandpass_verbose(vid, 10.0, CFG)
    evm_p = tevm.eulerian_magnification_bandpass(vid, 10.0, CFG)
    assert torch.equal(evm_v.raw, evm_p.raw)
    assert torch.equal(evm_v.masked, evm_p.masked)
