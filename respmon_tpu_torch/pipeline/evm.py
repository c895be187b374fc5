"""Eulerian video magnification calibration: locate the breathing ROI.

Port of ``respmon_tpu/pipeline/evm.py`` (reference transforms.py:144-198 +
base.py:547-601): the kept Laplacian levels of the (T, H, W) buffer, the
temporal bandpass per level (the packed-rfft operator, or with
``temporal_filter="iir"`` the order-6 Butterworth), the collapse, suppress-top
windowing, the heatmap, the threshold and the largest component's bbox.

The Laplacian levels come from ``ops/pyramid_cuda``: on a CUDA tensor its
hand-written kernels (every frame size, no VMEM plan), on a CPU tensor the
plain version.  The ``*_verbose`` variants log each stage's time.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, NamedTuple

import torch

from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.ops import ccl, pyramid_cuda
from respmon_tpu_torch.ops.dtype import float_to_uint8, uint8_to_float
from respmon_tpu_torch.ops.fft_bandpass import (temporal_bandpass_fft,
                                                temporal_bandpass_iir)
from respmon_tpu_torch.ops.pyramid import pyr_up, pyramid_shapes
from respmon_tpu_torch.utils.bench import span, wait_for

logger = logging.getLogger(__name__)


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


def _call(name, fn, *args):
    """Run one EVM stage (``_evm_stages``'s plain ``stage``)."""
    return fn(*args)


# ``locate``'s span of each EVM stage.
_STAGE_SPANS = {"create_laplacian_video_pyramid": "locate.pyramid",
                "temporal_bandpass_filter": "locate.bandpass",
                "collapse_laplacian_video_pyramid": "locate.collapse"}


def _traced(name, fn, *args):
    """A ``stage`` for ``_evm_stages`` (``locate``'s) that runs each stage
    in its ``locate.*`` span."""
    with span(_STAGE_SPANS[name]):
        return fn(*args)


def _timed(t_len: int):
    """A ``stage`` for ``_evm_stages`` that logs each stage's dt and the
    per-frame average (reference transforms.py:153-155, 166-168, 194-197
    ``verbose=True``).  The clock stops after the stage's CUDA device is
    synchronised, so a dt is the stage's device time, not its launch."""
    def stage(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        wait_for(out)
        dt = time.time() - t0
        logger.info("%s (t=%s, dt=%s)", name, t0, dt)
        logger.info("Frame Average (t=n/a, dt=%s)", dt / float(t_len))
        return out
    return stage


def _evm_stages(vid: torch.Tensor, fps: float, cfg: CalibrationConfig,
                stage=_call):
    """The EVM's three stages on float frames: the kept Laplacian levels,
    each level's temporal bandpass, the collapse.  Returns (band levels by
    level, raw collapsed video, pyramid shapes).  Each stage runs through
    ``stage(name, fn, *args)``."""
    if cfg.temporal_filter not in ("fft", "iir"):
        raise ValueError("temporal_filter must be 'fft' or 'iir', got "
                         f"{cfg.temporal_filter!r}")
    t_len, h, w = vid.shape
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    lap = stage("create_laplacian_video_pyramid", _band_laplacian_levels,
                vid, cfg)
    if cfg.temporal_filter == "fft":
        band = {i: stage("temporal_bandpass_filter", temporal_bandpass_fft,
                         lvl, fps, cfg.freq_min, cfg.freq_max,
                         cfg.amplification)
                for i, lvl in lap.items()}
    else:
        band = stage("temporal_bandpass_filter", _bandpass_iir_levels, lap,
                     fps, cfg)
    raw = stage("collapse_laplacian_video_pyramid", _collapse, band, shapes,
                t_len, vid)
    return band, raw, shapes


def _bandpass_iir_levels(lap: Dict[int, torch.Tensor], fps: float,
                         cfg: CalibrationConfig) -> Dict[int, torch.Tensor]:
    """The IIR bandpass of every level in one recurrence: each pixel's
    filter runs on its own, so the levels' (T, pixels) columns side by side
    give each level what filtering it alone gives, in one launch chain
    instead of one per level."""
    t_len = next(iter(lap.values())).shape[0]
    flat = torch.cat([lvl.reshape(t_len, -1) for lvl in lap.values()], dim=1)
    out = temporal_bandpass_iir(flat, fps, cfg.freq_min, cfg.freq_max,
                                cfg.amplification)
    sizes = [lvl[0].numel() for lvl in lap.values()]
    return {i: part.reshape(lvl.shape) for (i, lvl), part in
            zip(lap.items(), out.split(sizes, dim=1))}


def _collapse(band: Dict[int, torch.Tensor], shapes, t_len: int,
              like: torch.Tensor, stop: int = 0) -> torch.Tensor:
    """Collapse the implicitly zero-padded bandpassed pyramid: start at the
    deepest filtered level and pyrUp-add up through level ``stop``."""
    last = len(shapes) - 2
    img = torch.zeros((t_len,) + tuple(shapes[last + 1]), dtype=like.dtype,
                      device=like.device)
    for lvl in range(last, stop - 1, -1):
        img = pyr_up(img, shapes[lvl])
        if lvl in band:
            img = img + band[lvl]
    return img


def _tmean(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over axis 0 (T) as a pairwise sum of whole frames, then
    / T.  Every pixel's sum runs in the same order whatever the other
    axes hold, so a W-shard of the frames or one stream of a batch gets
    the bits of the whole (``Tensor.mean`` picks its summation order by
    shape, on the CPU and on the card)."""
    t_len = x.shape[0]
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pairs = x[:half] + x[half:2 * half]
        x = torch.cat([pairs, x[2 * half:]]) if x.shape[0] % 2 else pairs
    out = x / t_len
    return out if keepdim else out[0]


def _suppress_top(raw: torch.Tensor, cfg: CalibrationConfig):
    lo = raw.min()
    hi = raw.max()
    top = hi - (hi - lo) * cfg.temporal_threshold
    return torch.where(raw >= top, lo, raw)


def _bandpass(vid: torch.Tensor, fps: float, cfg: CalibrationConfig,
              stage=_call) -> EVMResult:
    if vid.dtype == torch.uint8:
        vid = uint8_to_float(vid)
    _, raw, _ = _evm_stages(vid, fps, cfg, stage)
    return EVMResult(masked=_suppress_top(raw, cfg), raw=raw)


def eulerian_magnification_bandpass(vid: torch.Tensor, fps: float,
                                    cfg: CalibrationConfig) -> EVMResult:
    """transforms.py:144-198: (T, H, W) float frames in [0, 1] or uint8."""
    return _bandpass(vid, fps, cfg)


def eulerian_magnification_bandpass_verbose(vid: torch.Tensor, fps: float,
                                            cfg: CalibrationConfig) \
        -> EVMResult:
    """``eulerian_magnification_bandpass`` with the reference's per-stage
    timing logs (transforms.py ``verbose=True``): each stage's dt, device
    time included, and the per-frame average."""
    return _bandpass(vid, fps, cfg, _timed(vid.shape[0]))


def _locate(vid: torch.Tensor, fps: float, cfg: CalibrationConfig,
            stage=_traced) -> LocateResult:
    if vid.dtype == torch.uint8:
        vid = uint8_to_float(vid)
    band, raw, shapes = _evm_stages(vid, fps, cfg, stage)
    return _locate_from_evm(band, raw, shapes, cfg)


def locate(vid: torch.Tensor, fps: float, cfg: CalibrationConfig) \
        -> LocateResult:
    """base.py:547-601: EVM heatmap -> normalize -> threshold -> largest
    8-connected region -> bounding box.  found=False when the threshold
    image has no foreground (the reference's retry path).

    ``vid`` is (T, H, W) float frames in [0, 1] or camera-native uint8,
    widened on the device bit-equal to the host reference chain."""
    return _locate(vid, fps, cfg)


def locate_verbose(vid: torch.Tensor, fps: float, cfg: CalibrationConfig) \
        -> LocateResult:
    """``locate`` with the reference's per-stage timing logs
    (transforms.py ``verbose=True``); the same result."""
    return _locate(vid, fps, cfg, _timed(vid.shape[0]))


def _locate_from_evm(band: Dict[int, torch.Tensor], raw: torch.Tensor,
                     shapes, cfg: CalibrationConfig) -> LocateResult:
    """The heatmaps of the EVM's output, then ``_finish_locate``."""
    avg = _tmean(_suppress_top(raw, cfg))
    # pyrUp is linear, so the raw heatmap is one single-frame collapse of
    # the T-means of the band levels — the JAX package's formulation.
    mean_band = {i: _tmean(lvl, keepdim=True) for i, lvl in band.items()}
    raw_avg = _collapse(mean_band, shapes, 1, raw)[0]
    return _finish_locate(avg, raw_avg, cfg)


def _heat_and_box(avg: torch.Tensor, cfg: CalibrationConfig):
    """(uint8 heatmap, foreground mask, largest component) of an average
    frame: min-max normalize, threshold strictly above, label."""
    avg_norm = (avg - avg.min()) / (avg.max() - avg.min())
    heat_u8 = float_to_uint8(avg_norm)
    threshold = int(round(cfg.threshold * 255.0))
    fg = heat_u8.to(torch.int32) > threshold   # cv2.THRESH_BINARY strict >
    return heat_u8, fg, ccl.largest_component_bbox(fg)


def _finish_locate(avg: torch.Tensor, raw_avg: torch.Tensor,
                   cfg: CalibrationConfig) -> LocateResult:
    """Normalize -> threshold -> largest component (base.py:560-575)."""
    heat_u8, fg, box = _heat_and_box(avg, cfg)
    thresh_img = fg.to(torch.uint8) * 255

    raw_norm = (raw_avg - raw_avg.min()) / (raw_avg.max() - raw_avg.min())
    return LocateResult(found=box.found, x=box.x, y=box.y, w=box.w, h=box.h,
                        heatmap_u8=heat_u8, thresh=thresh_img,
                        raw_heat_u8=float_to_uint8(raw_norm))
