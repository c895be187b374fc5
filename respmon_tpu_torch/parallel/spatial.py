"""Spatial parallelism: the width-sharded EVM with halo exchange.

Port of ``respmon_tpu/parallel/spatial.py``.  For single very large frames
(4K monitoring, or 1080p calibration buffers too big for one device) the
frame's W axis is sharded over the ranks of ``mesh[axis]``.  The 5-tap
pyrDown and pyrUp stencils then need one or two columns from each
neighbour: ``Mesh.exchange`` (a ``batch_isend_irecv`` with each
neighbour, where the JAX package runs a ``ppermute`` ring), with the
global border rules rebuilt at the outer edges (reflect-101 for pyrDown;
cv2 pyrUp's reflect at the front and replicate at the back), so that the
sharded result is bit-identical to the single-device stencils.

``locate_wsharded`` runs the whole EVM calibration W-sharded: the
O(T·H·W) stages (Laplacian pyramid, packed-rfft bandpass, collapse,
suppress-top mean) run on W-shards while a level's width still shards;
the first narrower Gaussian level is all-gathered once and the deep rest
runs on every rank; the O(H·W) finish runs on every rank from one
all-gathered pair of heatmaps.  Every cross-shard reduction is a min, a
max or a concatenation, so the result is bit-identical to ``evm.locate``.
These stencils are plain torch ops: the JAX package writes them in jnp,
with no Pallas kernel.

A sharded level's local width must be even and >= 4, so that output
phases line up across shards (global output 2j is local output j).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.ops.dtype import uint8_to_float
from respmon_tpu_torch.ops.fft_bandpass import temporal_bandpass_fft
from respmon_tpu_torch.ops.pyramid import (_K5, _down_axis, _up_axis,
                                           pyr_down, pyr_up, pyramid_shapes)
from respmon_tpu_torch.parallel.mesh import Mesh
from respmon_tpu_torch.pipeline import evm


def _local_down_w(xp: torch.Tensor) -> torch.Tensor:
    """Stride-2 5-tap sum along the last axis of a block padded by 2 on
    each side (width wl + 4), giving wl // 2 outputs; the arithmetic of
    ``pyramid._down_axis``."""
    out_n = (xp.shape[-1] - 4) // 2
    acc = None
    for k, w in enumerate(_K5):
        term = xp[..., k:k + 2 * out_n:2] * w
        acc = term if acc is None else acc + term
    return acc


def _halo_w(mesh: Mesh, xl: torch.Tensor, k: int, axis: str,
            front: Optional[torch.Tensor],
            back: Optional[torch.Tensor]) -> torch.Tensor:
    """``xl`` with k neighbour columns on each side, and the given
    global-border columns at the outer edges of the first and last
    shard."""
    from_left, from_right = mesh.exchange(xl[..., :k], xl[..., -k:], axis)
    left = front if from_left is None else from_left
    right = back if from_right is None else from_right
    return torch.cat([left, xl, right], dim=-1)


def _local_up_w(xp: torch.Tensor) -> torch.Tensor:
    """Dual-phase 2x upsample along the last axis of a block padded by 1
    on each side (width wl + 2), giving 2 * wl outputs; the arithmetic of
    ``pyramid._up_axis``."""
    even = (xp[..., :-2] + 6.0 * xp[..., 1:-1] + xp[..., 2:]) * (1.0 / 8.0)
    odd = (xp[..., 1:-1] + xp[..., 2:]) * 0.5
    inter = torch.stack([even, odd], dim=-1)
    return inter.reshape(tuple(xp.shape[:-1]) + (2 * (xp.shape[-1] - 2),))


def _down_w_sharded(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sharded cv2 pyrDown: rows local, W halo-exchanged, reflect-101 at
    the outer edges (columns 2, 1 in front; -2, -3 at the back)."""
    xp = _halo_w(mesh, x, 2, axis, x[..., 1:3].flip(-1),
                 x[..., -3:-1].flip(-1))
    return _local_down_w(_down_axis(xp, x.ndim - 2))


def _up_w_sharded(mesh: Mesh, x: torch.Tensor, dst_h: int,
                  axis: str) -> torch.Tensor:
    """Sharded cv2 pyrUp to (dst_h, 2 * local width): rows local and
    trimmed to ``dst_h``, W halo-exchanged, cv2's border at the outer
    edges (reflect-101 in front, replicate at the back)."""
    r = _up_axis(x, x.ndim - 2, dst_h)
    rp = _halo_w(mesh, r, 1, axis, r[..., 1:2], r[..., -1:])
    return _local_up_w(rp)


def _up_w_from_replicated(mesh: Mesh, g: torch.Tensor, dst_h: int,
                          axis: str) -> torch.Tensor:
    """pyrUp from a source every rank holds whole to a W-sharded output:
    each rank cuts its window (with its halo) out of the whole padded row,
    with no communication."""
    wl = g.shape[-1] // mesh.shape[axis]
    r = _up_axis(g, g.ndim - 2, dst_h)
    padded = torch.cat([r[..., 1:2], r, r[..., -1:]], dim=-1)
    start = mesh.index(axis) * wl
    return _local_up_w(padded[..., start:start + wl + 2])


def _own_columns(x, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's block of the last axis of a global array (numpy or a
    tensor), on the mesh's device."""
    wl = x.shape[-1] // mesh.shape[axis]
    start = mesh.index(axis) * wl
    cols = x[..., start:start + wl]
    if isinstance(cols, np.ndarray):
        cols = torch.from_numpy(np.ascontiguousarray(cols))
    return cols.to(mesh.device).contiguous()


def pyr_down_w_sharded(x, mesh: Mesh, axis: str = "space") -> torch.Tensor:
    """cv2-exact pyrDown of a global (..., H, W) array (the same on every
    rank) with W sharded over ``mesh[axis]``; every rank returns the whole
    result.  W must be divisible by 2 * n, with at least 4 columns a
    rank."""
    n = mesh.shape[axis]
    w = x.shape[-1]
    if w % (2 * n) or w // n < 4:
        raise ValueError(f"width {w} over {n} shards: each needs an even "
                         "width of at least 4")
    out = _down_w_sharded(mesh, _own_columns(x, mesh, axis), axis)
    return mesh.all_gather(out, axis, dim=-1)


def _split_level(shapes, last: int, n: int) -> int:
    """The first level that stays whole: levels [0, split) are W-sharded,
    each with an even local width of at least 4."""
    def shardable(lvl):
        wl = shapes[lvl][1]
        return wl % n == 0 and (wl // n) % 2 == 0 and wl // n >= 4

    split = 0
    while split <= last and shardable(split):
        split += 1
    return split


def make_wsharded_locate(mesh: Mesh, fps: float, cfg: CalibrationConfig,
                         t_len: int, h: int, w: int, axis: str = "space"):
    """A W-sharded ``evm.locate`` over ``mesh[axis]``: a function of this
    rank's (T, H, W / n) columns.  Levels stay sharded while their local
    width is even and >= 4; the first narrower level is all-gathered and
    the rest runs on every rank.  Every rank returns the same
    ``LocateResult``, bit-identical to ``evm.locate``."""
    n = mesh.shape[axis]
    if w % n:
        raise ValueError(f"width {w} does not divide over {n} shards")
    if cfg.temporal_filter != "fft":
        raise ValueError("W-sharded locate supports the fft temporal filter")
    first = cfg.skip_levels_at_top
    last = cfg.pyramid_levels - 2
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    split = _split_level(shapes, last, n)
    if split < 1:
        raise ValueError(f"width {w} over {n} shards leaves no shardable "
                         "level")

    def bandpass(lvl_vid):
        return temporal_bandpass_fft(lvl_vid, fps, cfg.freq_min,
                                     cfg.freq_max, cfg.amplification)

    def collapse(levels, t, like):
        """The collapse: on every rank from the deepest level up to
        ``split``, then sharded (the boundary cut from the whole level)
        and halo-pyrUp'd up to level 0."""
        img = torch.zeros((t,) + tuple(shapes[last + 1]), dtype=like.dtype,
                          device=like.device)
        for lvl in range(last, split - 1, -1):
            img = pyr_up(img, shapes[lvl])
            if lvl in levels:
                img = img + levels[lvl]
        img = _up_w_from_replicated(mesh, img, shapes[split - 1][0], axis)
        if split - 1 in levels:
            img = img + levels[split - 1]
        for lvl in range(split - 2, -1, -1):
            img = _up_w_sharded(mesh, img, shapes[lvl][0], axis)
            if lvl in levels:
                img = img + levels[lvl]
        return img

    def local(vid_local: torch.Tensor) -> evm.LocateResult:
        # Camera-native uint8 frames widen on each rank's device.
        if vid_local.dtype == torch.uint8:
            vid_local = uint8_to_float(vid_local)
        # The sharded Gaussian chain [0, split], then level `split` whole.
        gauss = [vid_local]
        for _ in range(split):
            gauss.append(_down_w_sharded(mesh, gauss[-1], axis))
        whole = {split: mesh.all_gather(gauss[split], axis, dim=-1)}
        for lvl in range(split + 1, last + 2):
            whole[lvl] = pyr_down(whole[lvl - 1])

        # The bandpassed Laplacian levels [first, last]: a level's is
        # sharded where the level is; its pyrUp source one level down may
        # be sharded, or whole at the split.
        band = {}
        for lvl in range(first, last + 1):
            if lvl < split:
                if lvl + 1 < split:
                    up = _up_w_sharded(mesh, gauss[lvl + 1], shapes[lvl][0],
                                       axis)
                else:
                    up = _up_w_from_replicated(mesh, whole[lvl + 1],
                                               shapes[lvl][0], axis)
                band[lvl] = bandpass(gauss[lvl] - up)
            else:
                band[lvl] = bandpass(
                    whole[lvl] - pyr_up(whole[lvl + 1], shapes[lvl]))

        img = collapse(band, t_len, vid_local)
        # Suppress-top with the global extrema; the T-means are per pixel.
        lo = mesh.all_reduce(img.min(), "min", axis)
        hi = mesh.all_reduce(img.max(), "max", axis)
        top = hi - (hi - lo) * cfg.temporal_threshold
        avg = evm._tmean(torch.where(img >= top, lo, img))
        # The raw heatmap as one collapse of the levels' T-means, the
        # formulation (and rounding) of evm.locate.
        mean_band = {i: evm._tmean(lvl, keepdim=True)
                     for i, lvl in band.items()}
        raw_avg = collapse(mean_band, 1, vid_local)[0]
        avg_full, raw_full = mesh.all_gather(torch.stack([avg, raw_avg]),
                                             axis, dim=-1)
        return evm._finish_locate(avg_full, raw_full, cfg)

    return local


def locate_wsharded(vid, mesh: Mesh, fps: float, cfg: CalibrationConfig,
                    axis: str = "space") -> evm.LocateResult:
    """W-sharded EVM calibration of a (T, H, W) buffer (numpy or a tensor,
    the same on every rank; see the module doc)."""
    t_len, h, w = vid.shape
    fn = make_wsharded_locate(mesh, float(fps), cfg, t_len, h, w, axis)
    return fn(_own_columns(vid, mesh, axis))
