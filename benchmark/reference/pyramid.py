# Frozen copy of respmon_tpu_torch/ops/pyramid.py:1-128 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package; laplacian_pyramid and collapse_laplacian_pyramid left out).
"""Gaussian/Laplacian pyramids with cv2.pyrDown/pyrUp numerics.

Port of ``respmon_tpu/ops/pyramid.py``, and the plain version of the CUDA
kernels in ``ops/pyramid_cuda.py``.  The operation order is the JAX
package's, so that every intermediate rounds at the same place:

  - pyrDown: H axis first, then W; each a 5-tap [1,4,6,4,1]/16 sum with a
    reflect-101 border, accumulated as ``acc = acc + x*w`` in tap order,
    then a stride-2 pick (output length ceil(n/2));
  - pyrUp: H axis first, then W; even outputs ``((a + 6b) + c) * 0.125``,
    odd outputs ``(b + c) * 0.5``; the front border reflect-101 and the
    back border replicate (cv2 reflects on the zero-stuffed grid).

Functions take (..., H, W) tensors; leading axes batch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


# Copied from respmon_tpu/ops/pyramid.py:35-43 (that module imports jax).
def _reflect101_indices(n: int, pad: int) -> np.ndarray:
    """Source indices for BORDER_REFLECT_101 padding of a length-n axis
    (edge sample not repeated; periodic for tiny n, matching OpenCV)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    return np.where(m < n, m, period - m)


# Copied from respmon_tpu/ops/pyramid.py:107-113.
def pyramid_shapes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """Per-level (h, w) shapes of a Gaussian pyramid."""
    shapes = [(h, w)]
    for _ in range(1, levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


def _take(x: torch.Tensor, idx, axis: int) -> torch.Tensor:
    return torch.index_select(
        x, axis, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                 device=x.device))


def _slice(x: torch.Tensor, axis: int, start, stop, step=1) -> torch.Tensor:
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(start, stop, step)
    return x[tuple(sl)]


def _down_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """5-tap blur + stride-2 subsample along ``axis`` (cv2.pyrDown, 1 axis)."""
    n = x.shape[axis]
    out_n = (n + 1) // 2
    xp = _take(x, _reflect101_indices(n, 2), axis)
    acc = None
    for k, w in enumerate(_K5):
        term = _slice(xp, axis, k, k + 2 * out_n, 2) * w
        acc = term if acc is None else acc + term
    return acc


def _up_axis(x: torch.Tensor, axis: int, dst: int) -> torch.Tensor:
    """Dual-phase 2x upsample along ``axis`` (cv2.pyrUp, 1 axis): front
    reflect-101 (s[-1] -> s[1]), back replicate (s[n] -> s[n-1])."""
    axis = axis % x.ndim
    n = x.shape[axis]
    front_idx = 1 if n > 1 else 0
    idx = np.concatenate([[front_idx], np.arange(n), [n - 1]])
    xp = _take(x, idx, axis)
    a = _slice(xp, axis, 0, n)
    b = _slice(xp, axis, 1, n + 1)
    c = _slice(xp, axis, 2, n + 2)
    even = (a + 6.0 * b + c) * (1.0 / 8.0)
    odd = (b + c) * 0.5
    inter = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return _slice(inter.reshape(shape), axis, 0, dst)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown over the last two axes; leading axes batch."""
    return _down_axis(_down_axis(x, x.ndim - 2), x.ndim - 1)


def pyr_up(x: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.pyrUp with explicit dstsize (h, w) over the last two axes."""
    h, w = dst_hw
    return _up_axis(_up_axis(x, x.ndim - 2, h), x.ndim - 1, w)


def gaussian_pyramid(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """Repeated pyrDown (reference pyramid.py:9-17)."""
    out = [x]
    for _ in range(1, levels):
        out.append(pyr_down(out[-1]))
    return tuple(out)
