"""Port parity: ops/pyramid_mm, the band-matrix formulation of the
Laplacian levels (K3), against the Pallas kernel
``laplacian_band_levels_mm`` in interpret mode and against the stencil
pyramid.  On the CPU the port's wrappers run their plain version
(``torch.matmul``); the CUDA kernels are held to it on the card
(tests/test_torch_cuda.py).

Tolerance atol 1e-5, the JAX package's own for this kernel: a product
sums a row's (at most 5) nonzero terms in another order than the stencil
adds its taps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.ops import pyramid as jpyr
from respmon_tpu.ops import pyramid_pallas as jpallas
from respmon_tpu_torch.ops import pyramid as tpyr
from respmon_tpu_torch.ops import _build, pyramid_cuda, pyramid_mm

torch.set_num_threads(1)

ATOL = 1e-5


def _video(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 15, 30, 120, 135])
def test_operator_matrices_equal_jax(n):
    assert np.array_equal(pyramid_mm._np_down_matrix(n),
                          jpallas._np_down_matrix(n))
    for dst in (2 * n, 2 * n - 1):
        if dst < 1:
            continue
        assert np.array_equal(pyramid_mm._np_up_matrix(n, dst),
                              jpallas._np_up_matrix(n, dst))


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_operator_matrices_are_the_stencils(n):
    x = torch.from_numpy(_video((1, n, 1), n))
    down = torch.from_numpy(pyramid_mm._np_down_matrix(n))
    np.testing.assert_allclose((down @ x[0]).numpy(),
                               tpyr._down_axis(x, 1)[0].numpy(), atol=1e-6)
    for dst in (2 * n, max(2 * n - 1, 1)):
        up = torch.from_numpy(pyramid_mm._np_up_matrix(n, dst))
        np.testing.assert_allclose((up @ x[0]).numpy(),
                                   tpyr._up_axis(x, 1, dst)[0].numpy(),
                                   atol=1e-6)
    assert int((down != 0).sum(dim=1).max()) <= 5


@pytest.mark.parametrize("shape,levels,skip", [((2, 120, 160), 6, 2),
                                               ((2, 45, 77), 5, 1),
                                               ((1, 5, 7), 3, 0)])
def test_band_levels_mm_match_the_pallas_kernel_and_the_stencil(shape, levels,
                                                                skip):
    v = _video(shape)
    tv = torch.from_numpy(v)
    got = pyramid_mm.laplacian_band_levels_mm(tv, levels, skip)
    ref = pyramid_mm.laplacian_band_levels_mm_ref(tv, levels, skip)
    want = jpallas.laplacian_band_levels_mm(jnp.asarray(v), levels, skip,
                                            interpret=True)
    lap = jpyr.laplacian_pyramid(jnp.asarray(v), levels)[skip:levels - 1]
    k1 = pyramid_cuda.laplacian_band_levels(tv, levels, skip)
    assert len(got) == len(want) == levels - 1 - skip
    for g, r, w, l, k in zip(got, ref, want, lap, k1):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        # On the CPU the wrapper IS the plain version.
        assert torch.equal(g, r)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(l), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), k.numpy(), rtol=0, atol=ATOL)


def test_band_products_on_the_cpu_are_matmul():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.random((5, 9)).astype(np.float32))
    b = torch.from_numpy(rng.random((3, 9, 4)).astype(np.float32))
    c = torch.from_numpy(rng.random((4, 6)).astype(np.float32))
    m = torch.from_numpy(rng.random((3, 5, 6)).astype(np.float32))
    _build.reset_launches()
    left = pyramid_mm.band_left(a, b)
    assert torch.equal(left, torch.matmul(a, b))
    assert torch.equal(pyramid_mm.band_right(left, c), torch.matmul(left, c))
    assert torch.equal(pyramid_mm.band_right(left, c, m),
                       m - torch.matmul(left, c))
    # No kernel ran: nothing was counted.
    assert {k: _build.LAUNCHES[k] for k in pyramid_mm.KERNELS.counted} \
        == {"band_left": 0, "band_right": 0}


def test_operator_cache_is_keyed_by_geometry():
    pyramid_mm._operators.cache_clear()
    dev = torch.device("cpu")
    first = pyramid_mm._operators(20, 30, 4, 1, dev)
    assert pyramid_mm._operators(20, 30, 4, 1, dev) is first
    other = pyramid_mm._operators(20, 30, 4, 0, dev)
    assert other is not first
    dh, dw_t, uh, uw_t = other
    assert [tuple(m.matrix.shape) for m in dh] == [(10, 20), (5, 10), (3, 5)]
    assert [tuple(m.matrix.shape) for m in dw_t] == [(30, 15), (15, 8),
                                                     (8, 4)]
    assert [tuple(m.matrix.shape) for m in uh] == [(20, 10), (10, 5), (5, 3)]
    assert [tuple(m.matrix.shape) for m in uw_t] == [(15, 30), (8, 15),
                                                     (4, 8)]
    assert len(first[2]) == 2
    # Each matrix travels with what the host read from its values.
    for ops, side in ((dh, "left"), (dw_t, "right"), (uh, "left"),
                      (uw_t, "right")):
        for op in ops:
            assert op.side == side and op.tf32_exact
            assert op.ranges.dtype == torch.int32
            assert op.ranges.tolist() == pyramid_mm.slab_ranges(
                op.matrix.numpy(), side).tolist()


def test_band_levels_mm_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match=r"\(T, H, W\)"):
        pyramid_mm.laplacian_band_levels_mm(torch.zeros((4, 4)), 2, 0)
