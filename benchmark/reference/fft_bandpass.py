# Frozen copy of respmon_tpu_torch/ops/fft_bandpass.py:1-91 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package; temporal_bandpass_iir left out).
"""Temporal bandpass with the reference's packed-rfft semantics, as one
(T, T) x (T, pixels) matrix product.

Port of ``respmon_tpu/ops/fft_bandpass.py``.  The reference
(transforms.py:82-102) zeroes slots of scipy's *packed* rfft layout and
takes the real part of an ifft of the still-real packed array; every step
is linear in T with static coefficients, so the chain is one real (T, T)
operator built on the host in float64 and applied on the device in full
float32 (TF32 is off: see ``respmon_tpu_torch/__init__.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch



# Copied from respmon_tpu/ops/fft_bandpass.py:39-53 (that module imports jax).
@lru_cache(maxsize=64)
def packed_bandpass_mask(n: int, fps: float, freq_min: float,
                         freq_max: float) -> tuple:
    """The reference's packed-slot zeroing mask (transforms.py:88-94)."""
    frequencies = np.fft.fftfreq(n, d=1.0 / fps)
    bound_low = int(np.abs(frequencies - freq_min).argmin())
    bound_high = int(np.abs(frequencies - freq_max).argmin())
    mask = np.ones(n)
    mask[bound_high:-bound_high] = 0
    if bound_low != 0:
        mask[:bound_low] = 0
        mask[-bound_low:] = 0
    return tuple(mask.tolist())


# Copied from respmon_tpu/ops/fft_bandpass.py:56-77.
@lru_cache(maxsize=64)
def packed_bandpass_operator(n: int, fps: float, freq_min: float,
                             freq_max: float,
                             amplification: float) -> np.ndarray:
    """(T, T) float64 operator: amp * Re(ifft(mask * packed_rfft(x)))."""
    t = np.arange(n)
    k = np.arange(n)
    P = np.zeros((n, n))
    P[0] = 1.0
    half = (n - 1) // 2
    for j in range(1, half + 1):
        P[2 * j - 1] = np.cos(2.0 * np.pi * j * t / n)
        P[2 * j] = -np.sin(2.0 * np.pi * j * t / n)
    if n % 2 == 0:
        P[n - 1] = np.cos(np.pi * t)
    mask = np.asarray(packed_bandpass_mask(n, fps, freq_min, freq_max))
    C = np.cos(2.0 * np.pi * np.outer(t, k) / n) / n
    return amplification * (C @ (mask[:, None] * P))


def temporal_bandpass_fft(vid: torch.Tensor, fps: float, freq_min: float,
                          freq_max: float,
                          amplification: float) -> torch.Tensor:
    """Apply the packed-rfft bandpass along axis 0 of ``vid`` (T, ...)."""
    n = vid.shape[0]
    op = packed_bandpass_operator(n, float(fps), float(freq_min),
                                  float(freq_max), float(amplification))
    m = torch.as_tensor(op, dtype=vid.dtype, device=vid.device)
    return torch.matmul(m, vid.reshape(n, -1)).reshape(vid.shape)
