# Frozen copy of respmon_tpu_torch/ops/filters.py:1-244 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package; the IIR bandpass, sosfilt and the sequential lfilter left out).
"""Butterworth lowpass filtfilt on right-aligned masked signals, batched.

Port of ``respmon_tpu/ops/filters.py`` (reference transforms.py:58-69,
base.py:342).  Signals are stored right-aligned in a fixed (..., N) buffer
with a valid ``count`` per row; under ``lfilter_zi`` steady-state initial
conditions a constant prefix leaves the real outputs as if the unpadded
signal had been filtered.  The default IIR is ``lfilter_assoc``, the
parallel-prefix form of the DF2T recurrence, rounded as the JAX default
(``associative=True``) is: same doubling steps, and its 3x3 products
accumulated in fused multiply-adds (``ops/fma``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from benchmark.reference.fma import dot_fma, fma


# Copied from respmon_tpu/ops/filters.py:33-48 (that module imports jax).
@dataclasses.dataclass(frozen=True)
class FilterCoeffs:
    """Hashable IIR filter coefficients (normalized, a[0] == 1)."""

    b: Tuple[float, ...]
    a: Tuple[float, ...]
    zi: Tuple[float, ...]  # scipy.signal.lfilter_zi steady-state

    @property
    def order(self) -> int:
        return len(self.a) - 1

    @property
    def padlen(self) -> int:
        """scipy.filtfilt default padlen = 3 * max(len(a), len(b))."""
        return 3 * max(len(self.a), len(self.b))


# Copied from respmon_tpu/ops/filters.py:51-58.
def design_butter_lowpass(cutoff: float, fs: float,
                          order: int) -> FilterCoeffs:
    """Host-side Butterworth lowpass design (reference transforms.py:58-63)."""
    from scipy.signal import butter, lfilter_zi

    b, a = butter(order, cutoff / (0.5 * fs), btype="low", analog=False)
    zi = lfilter_zi(b, a)
    return FilterCoeffs(b=tuple(b.tolist()), a=tuple(a.tolist()),
                        zi=tuple(zi.tolist()))


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _matmul3(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(..., p, p) @ (..., p, p), rounded as XLA's dot (``ops/fma``)."""
    return dot_fma(m[..., :, :, None], n[..., None, :, :], dim=-2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., p, p) @ (..., p), rounded as XLA's dot."""
    return dot_fma(m, v[..., None, :], dim=-1)


def lfilter_assoc(coeffs: FilterCoeffs, x: torch.Tensor,
                  zi: torch.Tensor | None = None) -> torch.Tensor:
    """``lfilter`` along the last axis by parallel prefix: the DF2T state
    update d_{k+1} = A d_k + c x_k is affine with a constant companion A,
    so the states compose by Hillis-Steele doubling in O(log T) steps
    (the same grouping as the JAX package's ``lfilter_assoc``)."""
    p = coeffs.order
    n = x.shape[-1]
    b = _vec(coeffs.b, x)
    a = _vec(coeffs.a, x)

    A = torch.zeros((p, p), dtype=x.dtype, device=x.device)
    A[:, 0] = -a[1:]
    A[torch.arange(p - 1), torch.arange(1, p)] = 1.0
    c = b[1:] - a[1:] * b[0]

    v = c * x[..., None]                               # (..., T, p)
    M = A.expand(n, p, p)                              # batch-independent
    eye = torch.eye(p, dtype=x.dtype, device=x.device).expand(1, p, p)
    d = 1
    while d < n:
        ms = torch.cat([eye.expand(d, p, p), M[:-d]], dim=0)
        vs = torch.cat([torch.zeros_like(v[..., :d, :]), v[..., :-d, :]],
                       dim=-2)
        M, v = _matmul3(M, ms), _matvec(M, vs) + v
        d *= 2
    d0 = torch.zeros(x.shape[:-1] + (p,), dtype=x.dtype, device=x.device) \
        if zi is None else zi.to(x.dtype).expand(x.shape[:-1] + (p,))
    d_incl = _matvec(M, d0[..., None, :]) + v
    d_at = torch.cat([d0[..., None, :], d_incl[..., :-1, :]], dim=-2)
    return b[0] * x + d_at[..., 0]


def _odd_ext_masked(x_padded: torch.Tensor, count: torch.Tensor,
                    padlen: int) -> torch.Tensor:
    """scipy-filtfilt's odd extension of right-aligned masked signals.

    ``x_padded`` is (..., N) with row r valid on [N-count[r], N).  Returns
    (..., N + 2*padlen) with the real extension (front odd-ext, signal,
    back odd-ext) right-aligned at N + padlen, and the front extension's
    first value repeated before it."""
    n = x_padded.shape[-1]
    p = padlen
    m = n + 2 * p
    dev = x_padded.device
    start = (n - count)[..., None]                          # (..., 1)
    j = torch.arange(p, device=dev)
    x0 = torch.gather(x_padded, -1, start)
    xlast = x_padded[..., n - 1:n]
    src = (start + (p - j)).clamp(0, n - 1)
    front = 2.0 * x0 - torch.gather(x_padded, -1, src)
    back = 2.0 * xlast - x_padded[..., n - 2 - j]

    idx = torch.arange(m, device=dev)
    body = torch.gather(x_padded, -1, (idx - p).clamp(0, n - 1)
                        .expand(x_padded.shape[:-1] + (m,)))
    ext = torch.where((idx >= p) & (idx < p + n), body, 0.0)
    rel = idx - start                                        # (..., m)
    f_at = torch.gather(front, -1, rel.clamp(0, p - 1))
    ext = torch.where((rel >= 0) & (rel < p), f_at, ext)
    b_at = back[..., (idx - (m - p)).clamp(0, p - 1)]
    ext = torch.where(idx >= m - p, b_at, ext)
    return torch.where(idx < start, front[..., :1], ext)


def filtfilt_masked(coeffs: FilterCoeffs, x_padded: torch.Tensor,
                    count: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward IIR (scipy.signal.filtfilt, method='pad',
    padtype='odd', default padlen) of right-aligned masked rows.

    ``x_padded`` is (..., N), ``count`` (...,) with count > padlen.  Returns
    (..., N): positions [N-count, N) hold the filtered signal, positions
    before are unspecified."""
    n = x_padded.shape[-1]
    p = coeffs.padlen
    count = torch.as_tensor(count, device=x_padded.device)
    ext = _odd_ext_masked(x_padded, count, p)
    zi = _vec(coeffs.zi, x_padded)
    y1 = lfilter_assoc(coeffs, ext, zi=zi * ext[..., :1])
    y1r = torch.flip(y1, dims=[-1])
    y2r = lfilter_assoc(coeffs, y1r, zi=zi * y1r[..., :1])
    y2 = torch.flip(y2r, dims=[-1])
    return y2[..., p:p + n]
