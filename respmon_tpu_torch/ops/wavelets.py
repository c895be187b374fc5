# Port of respmon_tpu/ops/wavelets.py.
"""Daubechies wavelet smoothing (reference C15: transforms.py:121-141).

The reference's experimental ``wavelet_filter`` runs ``iterations`` levels of
db4 DWT (pywt, smooth-padding mode) and reconstructs from the deepest
approximation only: a lowpass smoother.  pywt is not a dependency, so the
transform is written here in torch, as the JAX package writes it in JAX:
analysis/synthesis filter banks with the standard db4 coefficients,
linear-extrapolation ("smooth") signal extension, and pywt's length
conventions (out = floor((n + L - 1) / 2), reconstruction trims L - 2).

The windowed products are ``Tensor.unfold`` and a matrix-vector product;
the port's no-TF32 policy (``respmon_tpu_torch/__init__.py``) keeps them
in full float32 where the JAX package asks for ``Precision.HIGHEST``.
Results keep the input's dtype and device.  Off the production path (like
the reference's), but part of the component inventory.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# Standard db4 analysis lowpass (pywt Wavelet('db4').dec_lo), copied from
# respmon_tpu/ops/wavelets.py:24-27.
_DB4_DEC_LO = np.array([
    -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
    -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
    0.7148465705525415, 0.23037781330885523])


def _filters(dec_lo: np.ndarray):
    L = len(dec_lo)
    dec_hi = np.array([(-1) ** k * dec_lo[L - 1 - k] for k in range(L)])
    rec_lo = dec_lo[::-1].copy()
    rec_hi = dec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


def _taps(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A filter's taps reversed (correlation == convolution with the
    flipped filter), in ``like``'s dtype and on its device."""
    return torch.tensor(values[::-1].copy(), dtype=like.dtype,
                        device=like.device)


def _smooth_ext(x: torch.Tensor, pad: int) -> torch.Tensor:
    """pywt Modes.smooth: linear extrapolation from the edge slope."""
    k = torch.arange(1, pad + 1, dtype=x.dtype, device=x.device)
    left_slope = x[0] - x[1]
    right_slope = x[-1] - x[-2]
    left = x[0] + k.flip(0) * left_slope
    right = x[-1] + k * right_slope
    return torch.cat([left, x, right])


def dwt_db4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level db4 DWT with smooth extension.

    Returns (cA, cD), each of length floor((n + L - 1) / 2).
    """
    dec_lo, dec_hi, _, _ = _filters(_DB4_DEC_LO)
    L = len(dec_lo)
    n = x.shape[0]
    windows = _smooth_ext(x, L - 1).unfold(0, L, 1)
    a_full = windows @ _taps(dec_lo, x)
    d_full = windows @ _taps(dec_hi, x)
    # pywt keeps outputs at odd phases: positions 1, 3, 5, ... of the full
    # convolution over the extended signal.
    n_out = (n + L - 1) // 2
    return a_full[1::2][:n_out], d_full[1::2][:n_out]


def idwt_db4(cA: torch.Tensor, cD: torch.Tensor | None,
             out_len: int) -> torch.Tensor:
    """Single-level inverse db4 DWT (cD=None means zero details)."""
    _, _, rec_lo, rec_hi = _filters(_DB4_DEC_LO)
    L = len(rec_lo)
    if cD is None:
        cD = torch.zeros_like(cA)
    pad = L - 1

    # Upsample (zero-stuff), pad L - 1 zeros on both ends, then filter;
    # sum both branches; trim L - 2 from the front (pywt convention).
    def windows(c):
        u = torch.zeros(2 * c.shape[0] + 2 * pad, dtype=c.dtype,
                        device=c.device)
        u[pad:pad + 2 * c.shape[0]:2] = c
        return u.unfold(0, L, 1)

    full = windows(cA) @ _taps(rec_lo, cA) + windows(cD) @ _taps(rec_hi, cA)
    return full[L - 2:][:out_len]


def wavelet_decompose(x: torch.Tensor, iterations: int = 5):
    """Iterated analysis: returns (approximations, details) per level
    (reference transforms.py:126-134)."""
    ca: List[torch.Tensor] = []
    cd: List[torch.Tensor] = []
    a = x
    for _ in range(iterations):
        a, d = dwt_db4(a)
        ca.append(a)
        cd.append(d)
    return ca, cd


def wavelet_filter(x: torch.Tensor, iterations: int = 5) -> torch.Tensor:
    """db4 smoothing: keep only the deepest approximation and reconstruct
    (reference transforms.py:126-141 ``rec_a[-1]``)."""
    ca, _ = wavelet_decompose(x, iterations)
    lengths = [x.shape[0]] + [a.shape[0] for a in ca[:-1]]
    rec = ca[-1]
    for lvl in range(iterations - 1, -1, -1):
        rec = idwt_db4(rec, None, lengths[lvl])
    return rec
