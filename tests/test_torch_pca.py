"""Port parity: ops/pca (masked covariance, closed-form 2x2 eig, the
row-unpack projection) against respmon_tpu.ops.pca.

Tolerance rtol 1e-5 (float32): the two packages sum in another order and
XLA contracts multiply-adds; the inputs are kept well conditioned."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.ops import pca as jpca
from respmon_tpu_torch.ops import pca as tpca

torch.set_num_threads(1)

RTOL = 1e-5


def _motion(seed, n=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 10.0
    base = np.sin(2 * np.pi * 0.3 * t)
    xy = np.stack([0.3 * base, 1.0 * base], axis=1)
    xy += 0.1 * rng.standard_normal((n, 2))
    mask = np.arange(n) >= rng.integers(0, n - 8)
    return xy.astype(dtype), mask


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cov_eig_and_projection_match_jax(seed, dtype):
    xy, mask = _motion(seed, dtype=dtype)
    rtol = RTOL if dtype == np.float32 else 1e-12
    cov_t = tpca.masked_cov2(torch.from_numpy(xy), torch.from_numpy(mask))
    cov_j = jpca.masked_cov2(jnp.asarray(xy), jnp.asarray(mask))
    assert cov_t.dtype == torch.from_numpy(xy).dtype
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=rtol)
    np.testing.assert_allclose(cov_t.numpy(),
                               np.cov(xy[mask].astype(np.float64).T),
                               rtol=1e-4 if dtype == np.float32 else 1e-10)

    vals_t, vecs_t = tpca.eigh2_desc(torch.from_numpy(np.array(cov_j)))
    vals_j, vecs_j = jpca.eigh2_desc(cov_j)
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), rtol=rtol)
    np.testing.assert_allclose(vecs_t.numpy(), np.asarray(vecs_j), rtol=rtol,
                               atol=rtol)
    assert float(vals_t[0]) >= float(vals_t[1])

    got = tpca.pca_project_last(torch.from_numpy(xy), torch.from_numpy(mask))
    want = jpca.pca_project_last(jnp.asarray(xy), jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=10 * rtol,
                               atol=rtol)


def test_projection_uses_the_row_unpack_quirk():
    xy, mask = _motion(5, dtype=np.float64)
    _, vecs = tpca.eigh2_desc(tpca.masked_cov2(torch.from_numpy(xy),
                                               torch.from_numpy(mask)))
    got = float(tpca.pca_project_last(torch.from_numpy(xy),
                                      torch.from_numpy(mask)))
    # [e1_x, e2_x]: row 0 of the column-sorted matrix, i.e. the
    # x-components of both eigenvectors (for an orthonormal 2x2 basis that
    # is e1 up to the sign of its second component).
    quirk = xy[-1] @ np.array([float(vecs[0, 0]), float(vecs[0, 1])])
    assert abs(got - quirk) < 1e-12
    assert abs(abs(float(vecs[0, 1])) - abs(float(vecs[1, 0]))) < 1e-12


@pytest.mark.parametrize("cov", [
    [[4.0, 0.0], [0.0, 1.0]],      # diagonal, x dominant
    [[1.0, 0.0], [0.0, 4.0]],      # diagonal, y dominant
    [[2.0, 0.0], [0.0, 2.0]],      # isotropic
    [[0.0, 0.0], [0.0, 0.0]],      # no motion at all
    [[1.0, 2.0], [2.0, 4.0]],      # rank 1
    [[1.0, -2.0], [-2.0, 4.0]],    # rank 1, negative slope
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigh2_degenerate_cases_match_jax(cov, dtype):
    c = np.asarray(cov, dtype)
    vals_t, vecs_t = tpca.eigh2_desc(torch.from_numpy(c))
    vals_j, vecs_j = jpca.eigh2_desc(jnp.asarray(c))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(vecs_t.numpy(), np.asarray(vecs_j),
                               rtol=RTOL, atol=1e-7)
    assert np.isfinite(vecs_t.numpy()).all()
    # Each column's largest-|.| component is positive.
    v = vecs_t.numpy()
    for col in range(2):
        assert v[np.argmax(np.abs(v[:, col])), col] > 0


def test_masked_cov_with_one_or_no_sample_is_finite():
    xy = np.ones((8, 2), np.float32)
    for count in (0, 1):
        mask = np.arange(8) >= 8 - count
        got = tpca.masked_cov2(torch.from_numpy(xy), torch.from_numpy(mask))
        want = jpca.masked_cov2(jnp.asarray(xy), jnp.asarray(mask))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.isfinite(float(tpca.pca_project_last(
            torch.from_numpy(xy), torch.from_numpy(mask))))
