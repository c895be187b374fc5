"""Eulerian video magnification calibration: locate the breathing ROI.

Port of ``respmon_tpu/pipeline/evm.py`` (reference transforms.py:144-198 +
base.py:547-601): the kept Laplacian levels of the (T, H, W) buffer, the
packed-rfft temporal bandpass per level, the collapse, suppress-top
windowing, the heatmap, the threshold and the largest component's bbox.

The Laplacian levels come from ``ops/pyramid_cuda``: on a CUDA tensor its
hand-written kernels (every frame size, no VMEM plan), on a CPU tensor the
plain version.  The ``*_verbose`` variants are not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.ops import ccl, pyramid_cuda
from respmon_tpu_torch.ops.dtype import float_to_uint8, uint8_to_float
from respmon_tpu_torch.ops.fft_bandpass import temporal_bandpass_fft
from respmon_tpu_torch.ops.pyramid import pyr_up, pyramid_shapes


class EVMResult(NamedTuple):
    masked: torch.Tensor   # (T, H, W) suppress-top-masked bandpassed video
    raw: torch.Tensor      # (T, H, W) raw collapsed bandpassed video


class LocateResult(NamedTuple):
    found: torch.Tensor       # bool — False mirrors locate() returning None
    x: torch.Tensor           # int32 bbox (cv2 convention)
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    heatmap_u8: torch.Tensor  # (H, W) uint8 normalized average frame
    thresh: torch.Tensor      # (H, W) uint8 binary threshold image
    raw_heat_u8: torch.Tensor  # (H, W) uint8 of the unmasked heatmap


def _band_laplacian_levels(vid: torch.Tensor, cfg: CalibrationConfig) \
        -> Dict[int, torch.Tensor]:
    """Laplacian levels [skip_top, levels-2] of the video, by level."""
    first = cfg.skip_levels_at_top
    levels = pyramid_cuda.laplacian_band_levels(vid, cfg.pyramid_levels,
                                                first)
    return dict(zip(range(first, cfg.pyramid_levels - 1), levels))


def _bandpassed_levels(vid: torch.Tensor, fps: float,
                       cfg: CalibrationConfig) -> Dict[int, torch.Tensor]:
    if cfg.temporal_filter != "fft":
        raise NotImplementedError(
            f"temporal_filter={cfg.temporal_filter!r}: only 'fft' is ported")
    return {i: temporal_bandpass_fft(lvl, fps, cfg.freq_min, cfg.freq_max,
                                     cfg.amplification)
            for i, lvl in _band_laplacian_levels(vid, cfg).items()}


def _collapse(band: Dict[int, torch.Tensor], shapes, t_len: int,
              like: torch.Tensor) -> torch.Tensor:
    """Collapse the implicitly zero-padded bandpassed pyramid: start at the
    deepest filtered level and pyrUp-add up through level 0."""
    last = len(shapes) - 2
    img = torch.zeros((t_len,) + tuple(shapes[last + 1]), dtype=like.dtype,
                      device=like.device)
    for lvl in range(last, -1, -1):
        img = pyr_up(img, shapes[lvl])
        if lvl in band:
            img = img + band[lvl]
    return img


def _suppress_top(raw: torch.Tensor, cfg: CalibrationConfig):
    lo = raw.min()
    hi = raw.max()
    top = hi - (hi - lo) * cfg.temporal_threshold
    return torch.where(raw >= top, lo, raw)


def eulerian_magnification_bandpass(vid: torch.Tensor, fps: float,
                                    cfg: CalibrationConfig) -> EVMResult:
    """transforms.py:144-198: (T, H, W) float frames in [0, 1] or uint8."""
    if vid.dtype == torch.uint8:
        vid = uint8_to_float(vid)
    t_len, h, w = vid.shape
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    raw = _collapse(_bandpassed_levels(vid, fps, cfg), shapes, t_len, vid)
    return EVMResult(masked=_suppress_top(raw, cfg), raw=raw)


def locate(vid: torch.Tensor, fps: float, cfg: CalibrationConfig) \
        -> LocateResult:
    """base.py:547-601: EVM heatmap -> normalize -> threshold -> largest
    8-connected region -> bounding box.  found=False when the threshold
    image has no foreground (the reference's retry path).

    ``vid`` is (T, H, W) float frames in [0, 1] or camera-native uint8,
    widened on the device bit-equal to the host reference chain."""
    if vid.dtype == torch.uint8:
        vid = uint8_to_float(vid)
    t_len, h, w = vid.shape
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    band = _bandpassed_levels(vid, fps, cfg)
    raw = _collapse(band, shapes, t_len, vid)
    avg = _suppress_top(raw, cfg).mean(dim=0)
    del raw
    # pyrUp is linear, so the raw heatmap is one single-frame collapse of
    # the T-means of the band levels — the JAX package's formulation.
    mean_band = {i: lvl.mean(dim=0, keepdim=True) for i, lvl in band.items()}
    raw_avg = _collapse(mean_band, shapes, 1, vid)[0]
    return _finish_locate(avg, raw_avg, cfg)


def _finish_locate(avg: torch.Tensor, raw_avg: torch.Tensor,
                   cfg: CalibrationConfig) -> LocateResult:
    """Normalize -> threshold -> largest component (base.py:560-575)."""
    avg_norm = (avg - avg.min()) / (avg.max() - avg.min())
    heat_u8 = float_to_uint8(avg_norm)

    threshold = int(round(cfg.threshold * 255.0))
    fg = heat_u8.to(torch.int32) > threshold   # cv2.THRESH_BINARY strict >
    thresh_img = fg.to(torch.uint8) * 255

    box = ccl.largest_component_bbox(fg)

    raw_norm = (raw_avg - raw_avg.min()) / (raw_avg.max() - raw_avg.min())
    return LocateResult(found=box.found, x=box.x, y=box.y, w=box.w, h=box.h,
                        heatmap_u8=heat_u8, thresh=thresh_img,
                        raw_heat_u8=float_to_uint8(raw_norm))
