"""The Laplacian band levels as dense products with band matrices: CUDA on
the GPU, plain PyTorch on the CPU.

Counterpart of ``laplacian_band_levels_mm`` in
``respmon_tpu/ops/pyramid_pallas.py`` (its K3), a second implementation of
the function ``ops/pyramid_cuda.laplacian_band_levels`` computes.  pyrDown
along H is the linear map ``D_h`` (h2 x h) and along W the map ``D_w``;
pyrUp likewise ``U_h``/``U_w``, so

    gauss[i+1] = D_h @ gauss[i] @ D_w^T
    out[l]     = gauss[l] - U_h @ gauss[l+1] @ U_w^T

The operator matrices are built on the host by the same numpy code as the
JAX package's, so the linear maps are exact.  The products are the
kernels of ``csrc/band_mm.cu``: ``band_left`` (``A @ B[t]``) and
``band_right`` (``B[t] @ A``, optionally subtracted from a minuend in the
same pass) are the wrappers.  For CPU tensors they are ``torch.matmul``;
for CUDA tensors they launch the kernel or raise (``ops/_build.LAUNCHES``
counts the launches per kernel).  ``laplacian_band_levels_mm_ref`` is the plain
version: the same chain through dense ``torch.matmul`` in full float32
(the package keeps TF32 off), on any device.

The matrices have at most 5 nonzeros a row.  A ``BandOperator`` carries,
beside the matrix, what the host read from its values once
(``band_operator``): for every ``BAND_TILE`` rows (left product) or
columns (right product) the range of inner indices outside which the
tile is all zero (``slab_ranges``), and whether every entry is exact in
TF32 (``is_tf32_exact``).  The kernel walks only a tile's range, so a
banded matrix costs the work its band needs and a dense one the dense
product; a bare tensor in place of an operator walks everything.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from respmon_tpu_torch.ops import _build
from respmon_tpu_torch.ops.pyramid import _K5, pyramid_shapes

KERNELS = _build.Kernels("band_mm", {"band_left_f32": "pppiiiipii",
                                     "band_right_f32": "ppppiiiipii"},
                         counted=("band_left", "band_right"))

# Rows (left product) or columns (right product) of the shared matrix that
# one thread block of csrc/band_mm.cu owns (kBandTile there), and the
# multiple the ends of a tile's range are rounded to: one MMA step, and a
# start the kernel's 16-byte copies can take.
BAND_TILE = 64
RANGE_ALIGN = 8


# Copied from respmon_tpu/ops/pyramid_pallas.py:113-127.
def _np_down_matrix(n: int) -> np.ndarray:
    out = (n + 1) // 2
    period = 2 * (n - 1) if n > 1 else 1

    def r101(i):
        m = i % period
        return m if m < n else period - m

    D = np.zeros((out, n), np.float32)
    for i in range(out):
        for k, w in enumerate(_K5):
            D[i, r101(2 * i + k - 2)] += w
    return D


# Copied from respmon_tpu/ops/pyramid_pallas.py:130-154.
def _np_up_matrix(n: int, dst: int) -> np.ndarray:
    U = np.zeros((dst, n), np.float32)
    front = 1 if n > 1 else 0   # s[-1] -> s[1] (reflect101)
    back = n - 1                # s[n] -> s[n-1] (replicate)

    def src(i):
        if i < 0:
            return front
        if i >= n:
            return back
        return i

    for i in range(dst):
        if i % 2 == 0:
            s = i // 2
            U[i, src(s - 1)] += 1.0 / 8.0
            U[i, src(s)] += 6.0 / 8.0
            U[i, src(s + 1)] += 1.0 / 8.0
        else:
            s = i // 2
            U[i, src(s)] += 0.5
            U[i, src(s + 1)] += 0.5
    return U


def slab_ranges(matrix: np.ndarray, side: str) -> np.ndarray:
    """For every ``BAND_TILE`` rows (``side="left"``: the matrix is (m, k)
    and multiplies from the left) or columns (``"right"``: (k, n)) of a
    shared matrix, the range ``[k_lo, k_hi)`` of inner indices outside
    which the tile is all zero, as an int32 array (tiles, 2).  The ends are
    rounded outwards to multiples of ``RANGE_ALIGN`` (``k_hi`` at most to
    ``k``), so no nonzero is cut; an all-zero tile gets the empty range
    (0, 0) and a dense matrix (0, k).  Read from the matrix's values,
    whatever made it."""
    tile, align = BAND_TILE, RANGE_ALIGN
    if side not in ("left", "right"):
        raise ValueError(f"side is 'left' or 'right', got {side!r}")
    if matrix.ndim != 2:
        raise ValueError(f"expected a matrix, got {matrix.shape}")
    by_tile = matrix != 0 if side == "left" else (matrix != 0).T
    k = by_tile.shape[1]
    n_tiles = -(-by_tile.shape[0] // tile)
    out = np.zeros((n_tiles, 2), np.int32)
    for i in range(n_tiles):
        used = np.flatnonzero(by_tile[i * tile:(i + 1) * tile].any(axis=0))
        if len(used):
            out[i] = (used[0] // align * align,
                      min(-(-(used[-1] + 1) // align) * align, k))
    return out


def is_tf32_exact(matrix: np.ndarray) -> bool:
    """True if every float32 entry is a TF32 number (the low 13 bits of its
    significand are zero): such a matrix goes through the tensor cores
    unrounded."""
    bits = np.ascontiguousarray(matrix, np.float32).view(np.uint32)
    return not bool((bits & 0x1FFF).any())


@dataclasses.dataclass(frozen=True, eq=False)
class BandOperator:
    """A shared matrix on its device, with what the host read from its
    values: the slab ranges of its tiles (int32 (tiles, 2), on the same
    device) and whether its entries are exact in TF32.  The kernel trusts
    the ranges, so they are checked here, once, where an operator is made
    (this reads them back from the device): a launch checks nothing of
    them and waits for nothing."""
    matrix: torch.Tensor
    side: str
    ranges: torch.Tensor
    tf32_exact: bool

    def __post_init__(self):
        if self.side not in ("left", "right"):
            raise ValueError(f"side is 'left' or 'right', got {self.side!r}")
        if self.matrix.ndim != 2:
            raise ValueError(f"expected a matrix, got "
                             f"{tuple(self.matrix.shape)}")
        tiled, k = (self.matrix.shape if self.side == "left"
                    else self.matrix.shape[::-1])
        tiles = -(-tiled // BAND_TILE)
        r = self.ranges
        if (r.device != self.matrix.device or r.dtype != torch.int32
                or tuple(r.shape) != (tiles, 2) or not r.is_contiguous()):
            raise ValueError(f"ranges are not int32 ({tiles}, 2) beside the "
                             f"matrix")
        lo, hi = r.cpu().numpy().T
        if not ((0 <= lo) & (lo <= hi) & (hi <= k)
                & (lo % RANGE_ALIGN == 0)
                & ((hi % RANGE_ALIGN == 0) | (hi == k))).all():
            raise ValueError(f"ranges are not [k_lo, k_hi) within [0, {k}] "
                             f"with ends on multiples of {RANGE_ALIGN} (or "
                             f"k_hi == {k}): {r.tolist()}")


def band_operator(matrix: np.ndarray, side: str,
                  device: torch.device) -> BandOperator:
    """Upload a host matrix for ``band_left`` (``side="left"``) or
    ``band_right`` (``"right"``) with its ranges and its TF32 verdict."""
    matrix = np.ascontiguousarray(matrix, np.float32)
    return BandOperator(torch.from_numpy(matrix).to(device), side,
                        torch.from_numpy(slab_ranges(matrix, side)).to(device),
                        is_tf32_exact(matrix))


@functools.lru_cache(maxsize=8)
def _operators(h: int, w: int, levels: int, skip_top: int,
               device: torch.device):
    """(dh, dw_t, uh, uw_t) tuples of ``BandOperator``s for one geometry;
    the W matrices are stored transposed, ready to multiply from the right.
    Cached: the same few geometries come back with every calibration."""
    shapes = pyramid_shapes(h, w, levels)
    kept = range(skip_top, levels - 1)

    dh = tuple(band_operator(_np_down_matrix(shapes[i][0]), "left", device)
               for i in range(levels - 1))
    dw_t = tuple(band_operator(_np_down_matrix(shapes[i][1]).T, "right",
                               device) for i in range(levels - 1))
    uh = tuple(band_operator(_np_up_matrix(shapes[lvl + 1][0],
                                           shapes[lvl][0]), "left", device)
               for lvl in kept)
    uw_t = tuple(band_operator(_np_up_matrix(shapes[lvl + 1][1],
                                             shapes[lvl][1]).T, "right",
                               device) for lvl in kept)
    return dh, dw_t, uh, uw_t


def _check(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected all tensors on one CUDA device "
                         f"or all on the CPU, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _unpack(a: Union[torch.Tensor, BandOperator], side: str, name: str):
    """(matrix, ranges pointer or None, number of ranges, exact flag) of a
    bare matrix (no ranges: the kernel walks the whole inner dimension and
    takes the matrix as inexact) or of a ``BandOperator`` for ``side``."""
    if not isinstance(a, BandOperator):
        return a, None, 0, 0
    if a.side != side:
        raise ValueError(f"{name}: operator was made for the {a.side} "
                         f"product")
    return (a.matrix, a.ranges.data_ptr(), a.ranges.shape[0],
            int(a.tf32_exact))


def band_left(a: Union[torch.Tensor, BandOperator],
              b: torch.Tensor) -> torch.Tensor:
    """``C[t] = a @ b[t]`` for a (m, k) matrix and a (T, k, n) f32 video
    (the ``band_left_f32`` kernel).  ``a`` is a ``BandOperator`` (the
    kernel walks only each row tile's range) or a bare tensor (it walks
    everything).  Terms of a skipped range are left out, not multiplied by
    zero, so ``b`` is expected finite (frames are): a dense product would
    turn an Inf or NaN there into NaN."""
    a, ranges, n_ranges, exact = _unpack(a, "left", "band_left")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return torch.matmul(a, b)
    _check(a, 2, "band_left")
    _check(b, 3, "band_left")
    if a.device != b.device:
        raise ValueError("band_left: a and b on different devices")
    (m, k), (t_len, kb, n) = a.shape, b.shape
    if k != kb:
        raise ValueError(f"band_left: {tuple(a.shape)} does not multiply "
                         f"{tuple(b.shape)}")
    out = torch.empty((t_len, m, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    KERNELS.launch("band_left_f32", b.device, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), t_len, m, k, n, ranges, n_ranges, exact,
                   count="band_left")
    return out


def band_right(b: torch.Tensor, a: Union[torch.Tensor, BandOperator],
               minuend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C[t] = b[t] @ a`` for a (T, m, k) f32 video and a (k, n) matrix,
    or ``minuend[t] - b[t] @ a`` (the ``band_right_f32`` kernel).  ``a`` is
    a ``BandOperator`` (the kernel walks only each column tile's range) or
    a bare tensor; ``b`` is expected finite, as for ``band_left``."""
    a, ranges, n_ranges, exact = _unpack(a, "right", "band_right")
    tensors = (b, a) if minuend is None else (b, a, minuend)
    if all(x.device.type == "cpu" for x in tensors):
        return _matmul_right(b, a, minuend)
    _check(b, 3, "band_right")
    _check(a, 2, "band_right")
    (t_len, m, k), (ka, n) = b.shape, a.shape
    if minuend is not None:
        _check(minuend, 3, "band_right")
        if tuple(minuend.shape) != (t_len, m, n):
            raise ValueError(f"band_right: minuend {tuple(minuend.shape)} "
                             f"is not {(t_len, m, n)}")
    if any(x.device != b.device for x in tensors):
        raise ValueError("band_right: tensors on different devices")
    if k != ka:
        raise ValueError(f"band_right: {tuple(b.shape)} does not multiply "
                         f"{tuple(a.shape)}")
    out = torch.empty((t_len, m, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    KERNELS.launch("band_right_f32", b.device, b.data_ptr(), a.data_ptr(),
                   None if minuend is None else minuend.data_ptr(),
                   out.data_ptr(), t_len, m, k, n, ranges, n_ranges, exact,
                   count="band_right")
    return out


def _chain(vid: torch.Tensor, levels: int, skip_top: int, left, right):
    """The band-matrix chain with the given product functions."""
    if vid.ndim != 3:
        raise ValueError(f"expected (T, H, W), got {tuple(vid.shape)}")
    dh, dw_t, uh, uw_t = _operators(vid.shape[1], vid.shape[2], levels,
                                    skip_top, vid.device)
    gauss = [vid]
    for i in range(levels - 1):
        gauss.append(right(left(dh[i], gauss[-1]), dw_t[i], None))
    return tuple(
        right(left(uh[slot], gauss[lvl + 1]), uw_t[slot], gauss[lvl])
        for slot, lvl in enumerate(range(skip_top, levels - 1)))


def laplacian_band_levels_mm(vid: torch.Tensor, levels: int,
                             skip_top: int) -> Tuple[torch.Tensor, ...]:
    """Laplacian levels [skip_top, levels-2] of a (T, H, W) f32 video by
    band-matrix products (K3): ``2 (levels - 1) + 2 kept`` kernel launches
    on a CUDA tensor, the plain version on a CPU tensor."""
    return _chain(vid, levels, skip_top, band_left, band_right)


def _matmul_right(b, a, minuend):
    prod = torch.matmul(b, a)
    return prod if minuend is None else minuend - prod


def laplacian_band_levels_mm_ref(vid: torch.Tensor, levels: int,
                                 skip_top: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``laplacian_band_levels_mm`` on any device: the
    same chain on the same matrices through dense ``torch.matmul``."""
    return _chain(vid, levels, skip_top,
                  lambda op, b: torch.matmul(op.matrix, b),
                  lambda b, op, minuend: _matmul_right(b, op.matrix, minuend))
