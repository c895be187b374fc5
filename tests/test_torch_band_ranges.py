"""What the host reads from a band operator's values for the band-product
kernels of ``respmon_tpu_torch/csrc/band_mm.cu``: the slab ranges of its
tiles and whether it is exact in TF32.  The kernels run only on the card
(tests/test_torch_cuda.py); here their walk (per tile, only the inner
indices of the tile's range) and their split of a float32 into two TF32
numbers are emulated in plain PyTorch on the CPU and held to the dense
``torch.matmul``.

Tolerance 1e-6 where sums run in another order; exact equality where the
values are chosen so that every product and sum is exact in float32."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from respmon_tpu_torch.ops import pyramid_mm
from respmon_tpu_torch.ops.pyramid_mm import BAND_TILE, RANGE_ALIGN

torch.set_num_threads(1)

CPU = torch.device("cpu")
SLAB = 32   # kSlab of band_mm.cu
GEOMETRIES = [(480, 640, 9, 4), (1080, 1920, 9, 4), (5, 7, 3, 0),
              (45, 77, 5, 1), (1, 1, 1, 0)]
KINDS = ["dh", "dw_t", "uh", "uw_t"]


def _ops(geometry, kind):
    return pyramid_mm._operators(*geometry, CPU)[KINDS.index(kind)]


def _walk(matrix, ranges, video, side, minuend=None):
    """The kernel's walk in plain PyTorch: per tile of BAND_TILE rows
    (left) or columns (right) of the matrix, the product over the tile's
    range of inner indices only."""
    if side == "left":
        out = torch.zeros(video.shape[0], matrix.shape[0], video.shape[2])
        for i, (lo, hi) in enumerate(ranges.tolist()):
            rows = slice(i * BAND_TILE, (i + 1) * BAND_TILE)
            out[:, rows] = torch.matmul(matrix[rows, lo:hi], video[:, lo:hi])
    else:
        out = torch.zeros(video.shape[0], video.shape[1], matrix.shape[1])
        for i, (lo, hi) in enumerate(ranges.tolist()):
            cols = slice(i * BAND_TILE, (i + 1) * BAND_TILE)
            out[:, :, cols] = torch.matmul(video[:, :, lo:hi],
                                           matrix[lo:hi, cols])
    return out if minuend is None else minuend - out


def _video_for(matrix, side, t_len, other, rng):
    k = matrix.shape[1 if side == "left" else 0]
    shape = (t_len, k, other) if side == "left" else (t_len, other, k)
    return torch.from_numpy(rng.random(shape).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_ranges_cover_every_nonzero_of_the_pyramid_operators(geometry, kind):
    for op in _ops(geometry, kind):
        a = op.matrix.numpy()
        by_tile = a if op.side == "left" else a.T
        k = by_tile.shape[1]
        ranges = op.ranges.numpy()
        assert ranges.shape == (-(-by_tile.shape[0] // BAND_TILE), 2)
        for i, (lo, hi) in enumerate(ranges):
            tile = by_tile[i * BAND_TILE:(i + 1) * BAND_TILE]
            assert 0 <= lo <= hi <= k
            assert lo % RANGE_ALIGN == 0
            assert hi % RANGE_ALIGN == 0 or hi == k
            assert not tile[:, :lo].any() and not tile[:, hi:].any()
            # Tight: the nearest nonzero is less than RANGE_ALIGN away.
            assert tile[:, lo:lo + RANGE_ALIGN].any()
            assert tile[:, max(hi - RANGE_ALIGN, 0):hi].any()


def test_the_first_640x480_operators_walk_a_third_of_their_slabs_or_less():
    dh, dw_t, _, _ = pyramid_mm._operators(480, 640, 9, 4, CPU)
    for op, k in ((dh[0], 480), (dw_t[0], 640)):
        width = op.ranges[:, 1] - op.ranges[:, 0]
        assert int(width.max()) <= 2 * BAND_TILE + 2 * RANGE_ALIGN
        slabs = -(-width // SLAB)
        assert int(slabs.max()) <= 5 and k // SLAB in (15, 20)


@pytest.mark.parametrize("side", ["left", "right"])
def test_dense_matrix_gets_the_full_range_and_a_zero_tile_an_empty_one(side):
    rng = np.random.default_rng(0)
    a = rng.random((200, 150)).astype(np.float32) + 0.5
    k = a.shape[1 if side == "left" else 0]
    n_tiles = -(-a.shape[0 if side == "left" else 1] // BAND_TILE)
    assert pyramid_mm.slab_ranges(a, side).tolist() == [[0, k]] * n_tiles
    if side == "left":
        a[64:128] = 0.0
    else:
        a[:, 64:128] = 0.0
    ranges = pyramid_mm.slab_ranges(a, side).tolist()
    assert ranges[1] == [0, 0]
    assert ranges[0] == [0, k] and ranges[2:] == [[0, k]] * (n_tiles - 2)
    assert pyramid_mm.slab_ranges(np.zeros((3, 5), np.float32),
                                  side).tolist() == [[0, 0]]
    with pytest.raises(ValueError):
        pyramid_mm.slab_ranges(a, "up")
    with pytest.raises(ValueError):
        pyramid_mm.slab_ranges(a[0], side)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry", [(480, 640, 9, 4), (45, 77, 5, 1),
                                      (5, 7, 3, 0)])
def test_walking_only_the_ranges_equals_the_dense_product(geometry, kind):
    rng = np.random.default_rng(1)
    for op in _ops(geometry, kind):
        video = _video_for(op.matrix, op.side, 2, 24, rng)
        want = (torch.matmul(op.matrix, video) if op.side == "left"
                else torch.matmul(video, op.matrix))
        got = _walk(op.matrix, op.ranges, video, op.side)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        minuend = torch.from_numpy(
            rng.random(tuple(want.shape)).astype(np.float32))
        np.testing.assert_allclose(
            _walk(op.matrix, op.ranges, video, op.side, minuend).numpy(),
            (minuend - want).numpy(), rtol=0, atol=1e-6)


@settings(max_examples=60, deadline=None, database=None)
@given(m=st.integers(1, 150), k=st.integers(1, 90), other=st.integers(1, 9),
       t_len=st.integers(1, 3), density=st.floats(0.0, 1.0),
       side=st.sampled_from(["left", "right"]), with_minuend=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_walk_equals_dense_on_random_zero_patterns(m, k, other, t_len,
                                                   density, side,
                                                   with_minuend, seed):
    # Multiples of 1/8 up to 2 in magnitude: every product and every sum of
    # at most 90 of them is exact in float32, so the two results are equal
    # whatever the order of summation.
    rng = np.random.default_rng(seed)

    def eighths(*shape):
        return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)

    a = eighths(m, k) * (rng.random((m, k)) < density)
    # Whole tiles, rows and columns of zeros, as a band matrix has.
    a[rng.random(m) < 0.3] = 0.0
    a[:, rng.random(k) < 0.3] = 0.0
    if m > BAND_TILE and rng.random() < 0.5:
        a[:BAND_TILE] = 0.0
    if side == "right":
        a = np.ascontiguousarray(a.T)
    op = pyramid_mm.band_operator(a, side, CPU)
    video = torch.from_numpy(
        eighths(t_len, k, other) if side == "left"
        else eighths(t_len, other, k))
    out_shape = (t_len, m, other) if side == "left" else (t_len, other, m)
    minuend = (torch.from_numpy(eighths(*out_shape)) if with_minuend
               and side == "right" else None)
    want = (torch.matmul(op.matrix, video) if side == "left"
            else pyramid_mm._matmul_right(video, op.matrix, minuend))
    got = _walk(op.matrix, op.ranges, video, side, minuend)
    assert torch.equal(got, want)
    # On the CPU the wrappers are the dense product, with or without ranges.
    if side == "left":
        assert torch.equal(pyramid_mm.band_left(op, video), want)
        assert torch.equal(pyramid_mm.band_left(op.matrix, video), want)
    else:
        assert torch.equal(pyramid_mm.band_right(video, op, minuend), want)


def test_wrappers_reject_an_operator_of_the_other_side_or_foreign_ranges():
    a = np.eye(70, dtype=np.float32)
    video = torch.zeros((1, 70, 70))
    left = pyramid_mm.band_operator(a, "left", CPU)
    right = pyramid_mm.band_operator(a, "right", CPU)
    with pytest.raises(ValueError, match="left product"):
        pyramid_mm.band_right(video, left)
    with pytest.raises(ValueError, match="right product"):
        pyramid_mm.band_left(right, video)
    with pytest.raises(ValueError, match="ranges"):
        dataclasses.replace(left, ranges=left.ranges[:1])
    with pytest.raises(ValueError, match="ranges"):
        dataclasses.replace(left, ranges=left.ranges.long())


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("bad", [[[0, 72], [0, 70]], [[4, 70], [0, 70]],
                                 [[0, 70], [-8, 70]], [[16, 8], [0, 70]],
                                 [[0, 70], [0, 60]]])
def test_an_operator_takes_only_ranges_the_kernel_can_walk(side, bad):
    # The kernel reads [k_lo, k_hi) of the inner dimension in 16-byte
    # pieces and checks nothing: an end beyond k, a start off a multiple of
    # RANGE_ALIGN, or an inverted pair never gets as far as a launch.
    a = np.eye(70, dtype=np.float32)
    op = pyramid_mm.band_operator(a, side, CPU)
    assert op.ranges.tolist() == [[0, 64], [64, 70]]
    dataclasses.replace(op, ranges=torch.tensor([[0, 70], [0, 70]],
                                                dtype=torch.int32))
    with pytest.raises(ValueError, match="ranges"):
        dataclasses.replace(op, ranges=torch.tensor(bad, dtype=torch.int32))


# -- the split of a float32 into two TF32 numbers --------------------------

def _to_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the CPU: round the significand to 10 bits, to
    nearest with ties away from zero, through an integer view."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x: np.ndarray):
    hi = _to_tf32(x)
    return hi, _to_tf32(x - hi)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_every_pyramid_operator_is_exact_in_tf32(geometry, kind):
    for op in _ops(geometry, kind):
        assert op.tf32_exact
        assert pyramid_mm.is_tf32_exact(op.matrix.numpy())
        assert np.array_equal(_to_tf32(op.matrix.numpy()), op.matrix.numpy())


def test_a_matrix_holding_a_tenth_is_not_exact_in_tf32():
    a = pyramid_mm._np_down_matrix(16)
    assert pyramid_mm.is_tf32_exact(a)
    a[3, 5] = 0.1
    assert not pyramid_mm.is_tf32_exact(a)
    assert not pyramid_mm.band_operator(a, "left", CPU).tf32_exact
    # The smallest step TF32 cannot hold.
    assert pyramid_mm.is_tf32_exact(np.float32([1 + 2.0**-10]))
    assert not pyramid_mm.is_tf32_exact(np.float32([1 + 2.0**-11]))


@pytest.mark.parametrize("scale", [1.0, 255.0, 1e-3])
def test_hi_plus_lo_is_the_float32_to_two_to_the_minus_21(scale):
    rng = np.random.default_rng(3)
    x = (rng.random(100_000) * scale).astype(np.float32)
    hi, lo = _split(x)
    assert pyramid_mm.is_tf32_exact(hi) and pyramid_mm.is_tf32_exact(lo)
    gap = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo)
    assert (gap <= 2.0**-21 * np.abs(x)).all()
    # One TF32 number alone is what the bar of 1e-5 rules out.
    assert np.abs(x - hi).max() > 1e-4 * scale


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry", [(480, 640, 9, 4), (45, 77, 5, 1)])
def test_two_tf32_terms_give_the_float32_product_on_the_pyramid(geometry,
                                                                kind):
    rng = np.random.default_rng(4)
    for op in _ops(geometry, kind):
        video = _video_for(op.matrix, op.side, 2, 24, rng)
        hi, lo = (torch.from_numpy(part) for part in _split(video.numpy()))
        if op.side == "left":
            got = torch.matmul(op.matrix, lo) + torch.matmul(op.matrix, hi)
            want = torch.matmul(op.matrix, video)
        else:
            got = torch.matmul(lo, op.matrix) + torch.matmul(hi, op.matrix)
            want = torch.matmul(video, op.matrix)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
