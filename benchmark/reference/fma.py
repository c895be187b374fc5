# Frozen copy of respmon_tpu_torch/ops/fma.py:1-38 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package).
"""Float32 fused multiply-adds, rounded as the JAX package's are.

XLA's CPU backend contracts multiply-adds into fused multiply-adds in two
places the port's DSP meets: dot products (``acc = fma(a_j, b_j, acc)``
for j ascending) and the body of the ``lax.scan`` IIR recurrence.  PyTorch
has no fused multiply-add op, so these emulate one: the product of two
float32 values is exact in float64, and one float64 add followed by the
cast to float32 rounds as the fused operation does (barring a rare double
rounding).  The IIR filters cancel heavily: with plain products the
port's float32 ``lfilter``/``lfilter_assoc`` differ from the JAX
package's by up to ~1e-5, with these they equal them bit for bit on the
tests' inputs, and ``filtfilt_masked`` agrees to ~1e-6.  Inputs of other
dtypes compute plainly.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding (float32) or plainly."""
    if torch.result_type(a, b) != torch.float32:
        return a * b + c
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def dot_fma(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``(a * b).sum(dim)`` accumulated left to right in fused
    multiply-adds (float32) or plainly (other dtypes)."""
    a, b = torch.broadcast_tensors(a, b)
    if a.dtype != torch.float32:
        return (a * b).sum(dim)
    acc = a.select(dim, 0) * b.select(dim, 0)
    for j in range(1, a.shape[dim]):
        acc = fma(a.select(dim, j), b.select(dim, j), acc)
    return acc
