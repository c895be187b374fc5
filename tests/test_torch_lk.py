"""Port parity: ops/lk (pyramidal Lucas-Kanade, the "slices" semantics)
against respmon_tpu.ops.lk run with ``sample="slices"``.

Both sides get the same images and the same start points (the corner set
of the JAX package).  Tolerances: helpers (Scharr maps, pads, pyramids,
geometry) are exact; tracked points agree to 1e-3 px in float32 (the
window sums run in another order and XLA contracts multiply-adds, and a
flipped ``|delta|^2 <= eps^2`` decision costs one more Newton step of at
most 0.03 px; seeds 1, 2 and 7 of the fixture were tried and agree on
every status decision) and to 1e-9 px in float64, where the two packages
take the same decisions throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.ndimage import gaussian_filter, shift as ndshift

from respmon_tpu.ops import corners as jcorners
from respmon_tpu.ops import lk as jlk
from respmon_tpu_torch.ops import lk as tlk

torch.set_num_threads(1)


def _pair(shift, seed=1, h=64, w=80, dtype=np.float32):
    """Two u8-lattice frames, the second the first moved by ``shift``."""
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.random((h + 16, w + 16)) * 0.5 + 0.25, 1.0)
    img0 = base[8:8 + h, 8:8 + w]
    img1 = ndshift(base, shift, order=3)[8:8 + h, 8:8 + w]
    u0 = np.clip(img0 * 255, 0, 255).astype(np.uint8).astype(dtype)
    u1 = np.clip(img1 * 255, 0, 255).astype(np.uint8).astype(dtype)
    return u0, u1


def _corners(u0):
    cs = jcorners.good_features_to_track(jnp.asarray(u0, jnp.float32))
    return np.array(cs.pts), np.array(cs.valid)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(64, 80), (33, 47), (2, 3)])
def test_scharr_and_pads_equal_jax(shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.float32)
    for got, want in zip(tlk._scharr_derivs(_t(img)),
                         jlk._scharr_derivs(jnp.asarray(img))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for border in ("reflect101", "zero"):
        for win in (5, 15):
            got = tlk._pad_for_windows(_t(img), win, border)
            want = jlk._pad_for_windows(jnp.asarray(img), win, border)
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_batched_helpers_equal_per_frame():
    clip = np.random.default_rng(1).integers(
        0, 256, (3, 20, 26)).astype(np.float32)
    dx, dy = tlk._scharr_derivs(_t(clip))
    pad = tlk._pad_for_windows(_t(clip), 7, "reflect101")
    for i in range(3):
        dxi, dyi = tlk._scharr_derivs(_t(clip[i]))
        assert torch.equal(dx[i], dxi) and torch.equal(dy[i], dyi)
        assert torch.equal(pad[i],
                           tlk._pad_for_windows(_t(clip[i]), 7, "reflect101"))


@pytest.mark.parametrize("hw,win,max_level", [((64, 80), 15, 2),
                                              ((33, 47), 9, 3),
                                              ((128, 160), 15, 2)])
def test_level_geometry_equals_jax(hw, win, max_level):
    # The port keeps the per-level shapes only (the JAX package's second
    # value sizes a TPU gather layout the port does not have).
    assert tlk.level_geometry(*hw, max_level) == \
        jlk.level_geometry(*hw, win, max_level)[0]


def test_precompute_frame_inputs_equals_jax():
    u0, _ = _pair((0.6, -0.4))
    got = tlk.precompute_frame_inputs(_t(u0), 15, 2, with_images=True)
    want = jlk.precompute_frame_inputs(jnp.asarray(u0), 15, 2,
                                       with_patches=False, with_images=True)
    assert len(got.stacks) == len(want.stacks) == 3
    for g, w in zip(got.stacks + got.images, want.stacks + want.images):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # A batch of frames carries the frame axis through every array, and
    # the next-role image is channel 0 of the prev-role stack.
    both = tlk.precompute_frame_inputs(_t(np.stack([u0, u0 + 1.0])), 15, 2,
                                       with_images=True)
    for lvl in range(3):
        assert torch.equal(both.stacks[lvl][0], got.stacks[lvl])
        assert torch.equal(both.stacks[lvl][:, 0], both.images[lvl])
    only_next = tlk.precompute_frame_inputs(_t(u0), 15, 2, with_stacks=False,
                                            with_images=True)
    assert only_next.stacks == () and len(only_next.images) == 3


@pytest.mark.parametrize("shift", [(0.6, -0.4), (2.3, 1.7), (-3.1, 0.9)])
@pytest.mark.parametrize("seed", [1, 2, 7])
def test_lk_matches_jax_on_subpixel_shifts(shift, seed):
    u0, u1 = _pair(shift, seed)
    pts, valid = _corners(u0)
    assert valid.sum() > 5
    got = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(u1), _t(pts), _t(valid))
    want = jlk.calc_optical_flow_pyr_lk(
        jnp.asarray(u0), jnp.asarray(u1), jnp.asarray(pts),
        jnp.asarray(valid), sample="slices")
    st = np.asarray(want.status)
    assert np.array_equal(got.status.numpy(), st)
    assert st.sum() > 5 and got.pts.dtype == torch.float32
    np.testing.assert_allclose(got.pts.numpy()[st], np.asarray(want.pts)[st],
                               rtol=0, atol=1e-3)
    # The flow is the shift that was applied (x is the second axis).
    flow = (got.pts.numpy() - pts)[st].mean(axis=0)
    np.testing.assert_allclose(flow, [shift[1], shift[0]], atol=0.2)


@pytest.mark.parametrize("shift", [(0.6, -0.4), (-3.1, 0.9)])
def test_lk_float64_matches_jax_tightly(shift):
    u0, u1 = _pair(shift, dtype=np.float64)
    pts, valid = _corners(u0)
    got = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(u1), _t(pts), _t(valid))
    want = jlk.calc_optical_flow_pyr_lk(
        jnp.asarray(u0), jnp.asarray(u1), jnp.asarray(pts),
        jnp.asarray(valid), sample="slices")
    assert np.array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(want.pts),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("params", [
    dict(win=9, max_level=1, max_iters=5, eps=0.01),
    dict(win=21, max_level=3, max_iters=20, eps=0.1),
    dict(win=15, max_level=0, max_iters=10, eps=0.03, min_eig_thresh=1e-2),
])
def test_lk_parameters_match_jax(params):
    u0, u1 = _pair((1.2, -0.8), dtype=np.float64)
    pts, valid = _corners(u0)
    got = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(u1), _t(pts), _t(valid),
                                       **params)
    want = jlk.calc_optical_flow_pyr_lk(
        jnp.asarray(u0), jnp.asarray(u1), jnp.asarray(pts),
        jnp.asarray(valid), sample="slices", **params)
    assert np.array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(want.pts),
                               rtol=0, atol=1e-9)


def test_lk_lost_points_match_jax():
    # Tracking into an uncorrelated frame, and from points at and beyond
    # the border: windows leave the image, status drops, and the clamped
    # gathers of such points never reach the output.
    u0, _ = _pair((0.0, 0.0), dtype=np.float64)
    rng = np.random.default_rng(3)
    u1 = rng.integers(0, 256, u0.shape).astype(np.float64)
    pts, valid = _corners(u0)
    extra = np.array([[0.0, 0.0], [79.0, 63.0], [-30.0, 10.0], [200.0, 5.0],
                      [40.0, 400.0], [-5.0, -5.0]], np.float32)
    pts = np.concatenate([extra, pts[:40]])
    valid = np.concatenate([np.ones(len(extra), bool), valid[:40]])
    for nxt in (u1, np.roll(u0, 25, axis=1)):
        got = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(nxt), _t(pts),
                                           _t(valid))
        want = jlk.calc_optical_flow_pyr_lk(
            jnp.asarray(u0), jnp.asarray(nxt), jnp.asarray(pts),
            jnp.asarray(valid), sample="slices")
        st = np.asarray(want.status)
        assert np.array_equal(got.status.numpy(), st)
        assert not st[2:5].any()          # windows wholly outside
        assert (~st & valid).sum() > 3
        np.testing.assert_allclose(got.pts.numpy()[st],
                                   np.asarray(want.pts)[st], rtol=0,
                                   atol=1e-9)


def test_lk_invalid_inputs_stay_invalid():
    u0, u1 = _pair((0.6, -0.4))
    pts = torch.zeros((10, 2))
    valid = torch.zeros((10,), dtype=torch.bool)
    got = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(u1), pts, valid)
    assert not bool(got.status.any()) and got.pts.shape == (10, 2)


def test_early_exit_equals_running_every_iteration(monkeypatch):
    u0, u1 = _pair((2.3, 1.7))
    pts, valid = _corners(u0)
    got = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(u1), _t(pts), _t(valid))
    assert 3 <= got.iterations < 30

    # The same call with the "any point active" stop disabled.
    monkeypatch.setattr(torch.Tensor, "any", lambda self, *a, **k:
                        torch.ones((), dtype=torch.bool))
    full = tlk.calc_optical_flow_pyr_lk(_t(u0), _t(u1), _t(pts), _t(valid))
    monkeypatch.undo()
    assert full.iterations == 30
    assert torch.equal(full.pts, got.pts)
    assert torch.equal(full.status, got.status)
