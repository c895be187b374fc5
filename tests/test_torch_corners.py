"""Port parity: ops/corners (Shi-Tomasi) against respmon_tpu.ops.corners.

The response map is held to 1e-5 of its largest value (float32 sums of
49-pixel boxes in another order, with XLA's contracted multiply-adds); the
selected corner sets must be identical.  Fixture seeds 0-5 of ``_texture``
were tried and agree on every decision."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.ops import corners as jcorners
from respmon_tpu_torch.ops import corners as tcorners

torch.set_num_threads(1)


def _texture(seed, h=64, w=80):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)) * 0.3 + 0.3
    yy, xx = np.mgrid[0:h, 0:w]
    img += 0.2 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    return np.clip(img * 255, 0, 255).astype(np.uint8).astype(np.float32)


def _assert_same_set(got, want):
    assert int(got.count) == int(want.count)
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert np.array_equal(got.pts.numpy(), np.asarray(want.pts))
    assert got.pts.dtype == torch.float32 and got.count.dtype == torch.int32


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("block_size", [3, 7])
def test_min_eigenval_map_matches_jax(seed, block_size):
    img = _texture(seed)
    got = tcorners.min_eigenval_map(torch.from_numpy(img), block_size)
    want = np.asarray(jcorners.min_eigenval_map(jnp.asarray(img),
                                                block_size))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_min_eigenval_map_remap_matches_jax():
    img = _texture(3)
    rows = np.clip(np.arange(64), 5, 44)
    cols = np.clip(np.arange(80), 3, 50)
    got = tcorners.min_eigenval_map(
        torch.from_numpy(img), 7,
        remap=(torch.from_numpy(rows), torch.from_numpy(cols)))
    want = np.asarray(jcorners.min_eigenval_map(
        jnp.asarray(img), 7, remap=(jnp.asarray(rows), jnp.asarray(cols))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 5, 40])
def test_reflect101_idx_matches_jax(n):
    i = np.arange(-12, 60)
    got = tcorners._reflect101_idx(torch.from_numpy(i), n)
    want = jcorners._reflect101_idx(jnp.asarray(i), jnp.asarray(n))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_dilate3_matches_jax():
    img = _texture(4, 9, 11)
    assert np.array_equal(tcorners._dilate3(torch.from_numpy(img)).numpy(),
                          np.asarray(jcorners._dilate3(jnp.asarray(img))))


@pytest.mark.parametrize("seed", range(6))
def test_corner_sets_match_jax(seed):
    img = _texture(seed)
    got = tcorners.good_features_to_track(torch.from_numpy(img))
    want = jcorners.good_features_to_track(jnp.asarray(img))
    assert int(want.count) > 5
    _assert_same_set(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(max_corners=5), dict(max_corners=200, quality_level=0.05),
    dict(min_distance=3.0, block_size=3), dict(min_distance=15.0),
])
def test_corner_parameters_match_jax(kwargs):
    img = _texture(2)
    got = tcorners.good_features_to_track(torch.from_numpy(img), **kwargs)
    want = jcorners.good_features_to_track(jnp.asarray(img), **kwargs)
    _assert_same_set(got, want)
    assert got.pts.shape == (kwargs.get("max_corners", 100), 2)


@pytest.mark.parametrize("offset", [(0, 0), (5, 3), (13, 9), (0, 17),
                                    (24, 0)])
def test_masked_roi_corners_match_jax(offset):
    # The production geometry: a bucketed window in which the real ROI
    # sits at an offset and the pixels outside it are zeroed.
    dy, dx = offset
    crop_h, crop_w, roi_h, roi_w = 64, 80, 40, 48
    img = _texture(7, crop_h, crop_w)
    rows = np.arange(crop_h)[:, None]
    cols = np.arange(crop_w)[None, :]
    mask = ((rows >= dy) & (rows < dy + roi_h) &
            (cols >= dx) & (cols < dx + roi_w))
    window = np.where(mask, img, 0.0).astype(np.float32)
    got = tcorners.good_features_to_track(
        torch.from_numpy(window), roi_mask=torch.from_numpy(mask))
    want = jcorners.good_features_to_track(
        jnp.asarray(window), roi_mask=jnp.asarray(mask))
    assert int(want.count) > 0
    _assert_same_set(got, want)
    pts = got.pts.numpy()[got.valid.numpy()]
    assert (pts[:, 0] >= dx + 1).all() and (pts[:, 0] < dx + roi_w - 1).all()
    assert (pts[:, 1] >= dy + 1).all() and (pts[:, 1] < dy + roi_h - 1).all()


def test_ties_resolve_to_the_smallest_flat_index():
    # Two identical blobs give exactly equal responses: the one that comes
    # first in row-major order is picked first, as in the JAX package.
    img = np.zeros((40, 60), np.float32)
    for cx in (15, 45):
        img[18:22, cx - 2:cx + 2] = 200.0
    got = tcorners.good_features_to_track(torch.from_numpy(img),
                                          max_corners=4)
    want = jcorners.good_features_to_track(jnp.asarray(img), max_corners=4)
    assert int(want.count) >= 2
    _assert_same_set(got, want)
    first = got.pts.numpy()[0]
    assert first[0] < 30


@pytest.mark.parametrize("value", [0.0, 128.0])
def test_flat_image_gives_no_corner(value):
    img = torch.full((32, 32), value)
    got = tcorners.good_features_to_track(img)
    assert int(got.count) == 0 and not bool(got.valid.any())
    mask = torch.zeros((32, 32), dtype=torch.bool)
    mask[4:20, 6:30] = True
    got = tcorners.good_features_to_track(img, roi_mask=mask)
    assert int(got.count) == 0
