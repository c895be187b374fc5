"""Sequence parallelism: the EVM calibration buffer sharded along T.

Port of ``respmon_tpu/parallel/temporal.py``.  A long calibration buffer
(BASELINE config 3 uses 300 frames; at 4K that is ~10 GB of float32
frames) shards along the time axis over the ranks of ``mesh[axis]``: every
stage of the EVM chain but the temporal bandpass works frame by frame.

- Each rank holds T / n frames and builds their kept Laplacian levels with
  the port's ``evm._band_laplacian_levels`` (on the card, K1).
- The packed-rfft bandpass, a static (T, T) operator, becomes a
  distributed product: each rank multiplies the operator's columns of its
  own frames into them (a plain ``torch.matmul``, as the JAX package left
  it to XLA), and one ``reduce_scatter`` returns each rank its rows.
- The collapse is per frame again.  The suppress-top window needs the
  global minimum and maximum (``all_reduce`` MIN and MAX of one scalar)
  and the heatmaps are T-means (one SUM ``all_reduce`` of the two (H, W)
  partial sums).
- The finish (normalize, threshold, largest component) runs on every rank
  from identical inputs: ``evm._finish_locate``.

The result matches ``evm.locate`` on the whole buffer to float tolerance:
the sums over T reassociate across ranks.  A T not divisible by the axis
size is zero-padded at the end and the pad frames are masked out of every
temporal statistic.
"""

from __future__ import annotations

import numpy as np
import torch

from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.ops.dtype import uint8_to_float
from respmon_tpu_torch.ops.fft_bandpass import packed_bandpass_operator
from respmon_tpu_torch.ops.pyramid import pyramid_shapes
from respmon_tpu_torch.parallel.mesh import Mesh
from respmon_tpu_torch.pipeline import evm


def _bandpass_tsharded(lvl_local: torch.Tensor, op_full: torch.Tensor,
                       mesh: Mesh, axis: str) -> torch.Tensor:
    """(T, T) @ (T, hw) with the video and the result both T-sharded.

    ``lvl_local`` is this rank's (T / n, h, w) frames, ``op_full`` the
    whole (T, T) operator: the rank multiplies the operator's columns of
    its frames into them, a (T, hw) partial product, and the
    reduce-scatter sums the ranks' partials and hands each its rows."""
    t_local = lvl_local.shape[0]
    start = mesh.index(axis) * t_local
    cols = op_full[:, start:start + t_local]
    partial = torch.matmul(cols, lvl_local.reshape(t_local, -1))
    return mesh.reduce_scatter(partial, axis).reshape(lvl_local.shape)


def make_tsharded_locate(mesh: Mesh, fps: float, cfg: CalibrationConfig,
                         t_total: int, axis: str = "time"):
    """A T-sharded ``evm.locate`` over ``mesh[axis]``: a function of this
    rank's (T_pad / n, H, W) frames, ``T_pad = ceil(t_total / n) * n``, the
    pad frames (zeros) at the end of the last ranks.  The bandpass operator
    is built for the true ``t_total`` and zero-extended, so pad frames add
    nothing to any output row.  Every rank returns the same
    ``LocateResult``."""
    if cfg.temporal_filter != "fft":
        raise ValueError("T-sharded locate supports the fft temporal filter")
    n = mesh.shape[axis]
    t_pad = -(-t_total // n) * n
    op = np.zeros((t_pad, t_pad))
    op[:t_total, :t_total] = packed_bandpass_operator(
        t_total, float(fps), float(cfg.freq_min), float(cfg.freq_max),
        float(cfg.amplification))

    def local(vid_local: torch.Tensor) -> evm.LocateResult:
        # Camera-native uint8 frames widen on each rank's device.
        if vid_local.dtype == torch.uint8:
            vid_local = uint8_to_float(vid_local)
        t_local, h, w = vid_local.shape
        shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
        dev = vid_local.device
        # A frame is valid where its global index is below the true T.
        valid = mesh.index(axis) * t_local + torch.arange(
            t_local, device=dev) < t_total
        op_dev = torch.as_tensor(op, dtype=vid_local.dtype, device=dev)
        band = {i: _bandpass_tsharded(lvl, op_dev, mesh, axis)
                for i, lvl in evm._band_laplacian_levels(vid_local,
                                                         cfg).items()}
        img = evm._collapse(band, shapes, t_local, vid_local)

        vmask = valid[:, None, None]
        inf = torch.tensor(float("inf"), dtype=img.dtype, device=dev)
        lo = mesh.all_reduce(torch.where(vmask, img, inf).min(), "min", axis)
        hi = mesh.all_reduce(torch.where(vmask, img, -inf).max(), "max",
                             axis)
        top = hi - (hi - lo) * cfg.temporal_threshold
        masked = torch.where(img >= top, lo, img)
        sums = mesh.all_reduce(torch.stack([
            torch.where(vmask, masked, 0.0).sum(dim=0),
            torch.where(vmask, img, 0.0).sum(dim=0)]), "sum", axis)
        avg, raw_avg = sums / t_total
        return evm._finish_locate(avg, raw_avg, cfg)

    return local


def locate_tsharded(vid, mesh: Mesh, fps: float, cfg: CalibrationConfig,
                    axis: str = "time") -> evm.LocateResult:
    """T-sharded EVM calibration of a (T, H, W) buffer (numpy or a tensor,
    the same on every rank; any T >= 1, see the module doc): each rank
    takes its frames onto its device, zero-padded past T."""
    t_total = vid.shape[0]
    n = mesh.shape[axis]
    per = -(-t_total // n)
    start = min(mesh.index(axis) * per, t_total)
    stop = min(start + per, t_total)
    rows = vid[start:stop]
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    rows = rows.to(mesh.device)
    if rows.shape[0] < per:
        rows = torch.cat([rows, rows.new_zeros(
            (per - rows.shape[0],) + tuple(rows.shape[1:]))])
    return make_tsharded_locate(mesh, fps, cfg, t_total, axis)(rows)
