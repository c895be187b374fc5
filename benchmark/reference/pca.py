# Frozen copy of respmon_tpu_torch/ops/pca.py:1-88 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package).
"""Closed-form 2x2 PCA projection for the flow motion signal.

Port of ``respmon_tpu/ops/pca.py``.  The reference (base.py:396-405) runs,
every frame, over the full motion buffer: ``cov = np.cov(coords)`` (ddof=1)
-> ``np.linalg.eig`` -> column-sort by eigenvalue descending ->
``evec1, evec2 = eig_vecs[:, sort_indices]``.  That unpacks the *rows* of
the column-sorted eigenvector matrix, so the projection vector is
``[e1_x, e2_x]`` (the x-components of both eigenvectors): a reference quirk,
reproduced here.  Then it projects the buffer and takes the last element.

The eigendecomposition is the closed form of a symmetric 2x2 matrix (no
LAPACK call, no host sync).  Sign convention: each eigenvector's
largest-|.| component is made positive, so a projected signal can differ
from numpy's by a global sign, which leaves peak-to-peak BPM unchanged.

The 2x2 covariance is a ``torch.matmul`` in full float32: the package's
precision policy (``respmon_tpu_torch/__init__.py``) keeps TF32 off, and
the eigenvector (so the projection's sign and scale) depends on it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_cov2(xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """np.cov (rowvar per-coordinate, ddof=1) of masked (..., N, 2)
    samples: (..., 2, 2)."""
    w = mask.to(xy.dtype)
    n = w.sum(dim=-1)
    mean = (xy * w[..., None]).sum(dim=-2) / torch.clamp(n, min=1.0)[..., None]
    d = (xy - mean[..., None, :]) * w[..., None]
    return torch.matmul(d.mT, d) / torch.clamp(n - 1.0, min=1.0)[..., None,
                                                                  None]


def eigh2_desc(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 2x2 eigendecomposition of (..., 2, 2) matrices,
    eigenvalues descending.

    Returns (vals (..., 2), vecs (..., 2, 2) with eigenvectors as
    columns), each column's largest-|.| component made positive.
    """
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    lam1 = half_tr + disc
    lam2 = half_tr - disc
    e_x = torch.tensor([1.0, 0.0], dtype=cov.dtype, device=cov.device)
    e_y = torch.tensor([0.0, 1.0], dtype=cov.dtype, device=cov.device)

    def unit_vec(lam):
        # [b, lam-a] is an eigenvector when b != 0; fall back to the axis
        # basis for (near-)diagonal matrices.
        v = torch.stack([b, lam - a], dim=-1)
        nrm = torch.sqrt((v * v).sum(dim=-1))
        diag_vec = torch.where(
            ((lam - a) * (lam - a) <= (lam - c) * (lam - c))[..., None],
            e_x, e_y)
        v = torch.where(
            (nrm > 1e-30 * (a.abs() + c.abs() + 1e-300))[..., None],
            v / torch.clamp(nrm, min=1e-300)[..., None], diag_vec)
        # Deterministic sign: largest-|.| component positive.
        pick = torch.where(v[..., 0].abs() >= v[..., 1].abs(), v[..., 0],
                           v[..., 1])
        return torch.where((pick < 0)[..., None], -v, v)

    vals = torch.stack([lam1, lam2], dim=-1)
    vecs = torch.stack([unit_vec(lam1), unit_vec(lam2)], dim=-1)
    return vals, vecs


def pca_project_last(motion_xy: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The reference's per-frame PCA step (base.py:396-405): covariance of
    the masked motion buffer, first-eigenvector row-quirk projection of the
    *newest* sample.

    motion_xy: (..., N, 2) right-aligned ring buffers (a leading stream
    axis for the fleet); mask: validity.  Returns the projected value of
    each ring's last (newest) sample.
    """
    cov = masked_cov2(motion_xy, mask)
    _, vecs = eigh2_desc(cov)
    evec1_row = vecs[..., 0, :]   # row 0 of the column-sorted matrix (quirk)
    return (motion_xy[..., -1, :] * evec1_row).sum(dim=-1)
