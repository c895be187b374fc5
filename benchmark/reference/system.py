"""The benchmark's plain reference of what the timed path produces.

Built only from the frozen copies beside this file, so it imports nothing
of the program.  From the frames the benchmark handed to the program it
works out again the calibration box, one flow measure step (the first
frame's corners, or LK, the motion ring and its PCA sample), the signal
ring's push and the BPM estimate of a signal ring.  Each function with
matrix products takes ``tf32``: True runs its float32 matrix products in
TF32, the control that has to come out as not correct.

The pieces copied here from the program carry their source and lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import bpm, ccl, corners, filters, lk, pca
from benchmark.reference.bbox import reduce_bounding_box
from benchmark.reference.config import (CalibrationConfig, FeatureParams,
                                        LKParams, MeasureConfig)
from benchmark.reference.fft_bandpass import temporal_bandpass_fft
from benchmark.reference.pyramid import (gaussian_pyramid, pyr_up,
                                         pyramid_shapes)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products in full float32, or in TF32 (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# Copied from respmon_tpu_torch/ops/dtype.py:18-33 and :36-46.
def uint8_to_float(img: torch.Tensor) -> torch.Tensor:
    x = img.to(torch.float32)
    return x / torch.tensor(255.0, dtype=torch.float32, device=x.device)


def float_to_uint8(img: torch.Tensor) -> torch.Tensor:
    scaled = torch.trunc(img.to(torch.float32) * 255.0)
    return torch.remainder(scaled.to(torch.int32), 256).to(torch.uint8)


# Copied from respmon_tpu_torch/pipeline/evm.py:109-119 (_collapse),
# :122-136 (_tmean) and :139-143 (_suppress_top).
def _collapse(band, shapes, t_len, like):
    last = len(shapes) - 2
    img = torch.zeros((t_len,) + tuple(shapes[last + 1]), dtype=like.dtype,
                      device=like.device)
    for lvl in range(last, -1, -1):
        img = pyr_up(img, shapes[lvl])
        if lvl in band:
            img = img + band[lvl]
    return img


def _tmean(x: torch.Tensor) -> torch.Tensor:
    t_len = x.shape[0]
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pairs = x[:half] + x[half:2 * half]
        x = torch.cat([pairs, x[2 * half:]]) if x.shape[0] % 2 else pairs
    return (x / t_len)[0]


def _suppress_top(raw: torch.Tensor, cal: CalibrationConfig):
    lo, hi = raw.min(), raw.max()
    top = hi - (hi - lo) * cal.temporal_threshold
    return torch.where(raw >= top, lo, raw)


def locate(frames_u8: torch.Tensor, fps: float, cal: CalibrationConfig,
           tf32: bool = False):
    """((found, x, y, w, h), heatmap) of a (T, H, W) uint8 calibration
    buffer: the box as Python values after ``reduce_bounding_box`` (the
    monitor's calibration), the (H, W) uint8 heatmap it was thresholded
    from.  The plain pyramid, the packed-rfft bandpass, the collapse,
    suppress-top, the heatmap, the threshold and the largest 8-connected
    region (respmon_tpu_torch/pipeline/evm.py:203-235)."""
    with precision(tf32):
        vid = uint8_to_float(frames_u8)
        t_len, h, w = vid.shape
        levels, first = cal.pyramid_levels, cal.skip_levels_at_top
        shapes = pyramid_shapes(h, w, levels)
        gauss = gaussian_pyramid(vid, levels)
        band = {}
        for lvl in range(first, levels - 1):
            lap = gauss[lvl] - pyr_up(gauss[lvl + 1],
                                      tuple(gauss[lvl].shape[-2:]))
            band[lvl] = temporal_bandpass_fft(lap, fps, cal.freq_min,
                                              cal.freq_max,
                                              cal.amplification)
        del gauss
        raw = _collapse(band, shapes, t_len, vid)
        avg = _tmean(_suppress_top(raw, cal))
        del raw, band
        norm = (avg - avg.min()) / (avg.max() - avg.min())
        heat = float_to_uint8(norm)
        fg = heat.to(torch.int32) > int(round(cal.threshold * 255.0))
        box = ccl.largest_component_bbox(fg)
        found, x, y, bw, bh = (int(v) for v in torch.stack(
            [box.found.to(torch.int32), box.x, box.y, box.w, box.h]).cpu())
    if not found:
        return (False, 0, 0, 0, 0), heat
    return (True,) + tuple(reduce_bounding_box(
        x, y, bw, bh, cal.maximum_bounding_box_area)), heat


def crop_size(box_w: int, box_h: int, frame_h: int, frame_w: int,
              roi_bucket: int):
    """(crop_h, crop_w): the ROI rounded up to ``roi_bucket``, capped at
    the frame (respmon_tpu_torch/pipeline/motion.py:61-64)."""
    def bucket(dim, cap):
        return min(-(-dim // roi_bucket) * roi_bucket, cap)
    return bucket(box_h, frame_h), bucket(box_w, frame_w)


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """What one flow step depends on besides its inputs."""

    frame_h: int
    frame_w: int
    crop_h: int
    crop_w: int
    buffer_length: int
    features: FeatureParams = FeatureParams()
    lk: LKParams = LKParams()


class FlowState(NamedTuple):
    """A measure state's fields that a flow step reads, batched (S, ...)."""

    roi: torch.Tensor           # (S, 4) int32
    initialized: torch.Tensor   # (S,) bool
    pts: torch.Tensor           # (S, M, 2)
    pts_valid: torch.Tensor     # (S, M)
    motion_xy: torch.Tensor     # (S, N, 2)
    motion_count: torch.Tensor  # (S,)


class FlowStep(NamedTuple):
    sample: torch.Tensor        # (S,)
    error: torch.Tensor         # (S,) bool
    state: FlowState            # the state after the step


# Copied from respmon_tpu_torch/pipeline/motion.py:289-312 (_window_starts,
# _crop_batch).
def _crop(frames: torch.Tensor, roi: torch.Tensor, spec: FlowSpec):
    dev = frames.device
    sx = roi[:, 0].clamp(0, spec.frame_w - spec.crop_w)
    sy = roi[:, 1].clamp(0, spec.frame_h - spec.crop_h)
    dx = (roi[:, 0] - sx)[:, None, None]
    dy = (roi[:, 1] - sy)[:, None, None]
    w = roi[:, 2][:, None, None]
    h = roi[:, 3][:, None, None]
    rr = torch.arange(spec.crop_h, device=dev)
    cc = torch.arange(spec.crop_w, device=dev)
    mask = ((rr[None, :, None] >= dy) & (rr[None, :, None] < dy + h)
            & (cc[None, None, :] >= dx) & (cc[None, None, :] < dx + w))
    sidx = torch.arange(frames.shape[0], device=dev)[:, None, None]
    crops = frames[sidx, (sy[:, None] + rr)[:, :, None],
                   (sx[:, None] + cc)[:, None, :]]
    return torch.where(mask, crops.to(torch.float32), 0.0), mask


# Copied from respmon_tpu_torch/pipeline/motion.py:194-229 (flow_update).
def _flow_update(fr, pts, valid, motion_xy, motion_count, buffer_length):
    good = fr.status & valid
    n_good = good.sum(dim=-1)
    lost = n_good == 0
    disp = pts - fr.pts
    gw = good.to(torch.float32)[..., None]
    mean_disp = (disp * gw).sum(dim=-2) / \
        torch.clamp(n_good, min=1).to(torch.float32)[..., None]
    motion_xy = torch.where(
        lost[..., None, None], motion_xy,
        torch.cat([motion_xy[..., 1:, :],
                   mean_disp[..., None, :].to(motion_xy.dtype)], dim=-2))
    motion_count = torch.where(
        lost, motion_count,
        torch.clamp(motion_count + 1, max=buffer_length))
    mmask = torch.arange(buffer_length, device=motion_xy.device) >= \
        (buffer_length - motion_count)[..., None]
    proj = pca.pca_project_last(motion_xy, mmask)
    sample = torch.where(motion_count >= 2, proj, 0.0)
    sample = torch.where(lost, float("nan"), sample).to(torch.float32)
    return sample, good, lost, motion_xy, motion_count


def flow_step(prev_frames: Optional[torch.Tensor], frames: torch.Tensor,
              state: FlowState, spec: FlowSpec, tf32: bool = False
              ) -> FlowStep:
    """One flow measure step of S streams from ``state``: for a stream not
    initialized yet, the corners of its crop of ``frames`` (sample 0, an
    error when none is found); else pyramidal LK from its crop of
    ``prev_frames`` at the same ROI, the motion ring push and the PCA
    sample (respmon_tpu_torch/pipeline/motion.py:337-393).  Frames are
    (S, H, W) uint8."""
    with precision(tf32):
        crop, mask = _crop(frames, state.roi, spec)
        win, max_level = spec.lk.win_size[0], spec.lk.max_level
        shapes = lk.level_geometry(spec.crop_h, spec.crop_w, max_level)
        init = state.initialized
        if bool(init.any()):
            prev_crop, _ = _crop(prev_frames, state.roi, spec)
            fr = lk.lk_track_precomputed(
                lk.LKFrameInputs(stacks=lk.precompute_frame_inputs(
                    prev_crop, win, max_level).stacks),
                lk.LKFrameInputs(stacks=(), images=lk.precompute_frame_inputs(
                    crop, win, max_level, with_stacks=False,
                    with_images=True).images),
                state.pts, state.pts_valid, shapes, win, max_level,
                spec.lk.max_iters, spec.lk.epsilon)
            sample, good, lost, motion_xy, motion_count = _flow_update(
                fr, state.pts, state.pts_valid, state.motion_xy,
                state.motion_count, spec.buffer_length)
            pts = fr.pts
        else:
            sample = torch.zeros_like(init, dtype=torch.float32)
            good, pts = state.pts_valid, state.pts
            lost = torch.zeros_like(init)
            motion_xy, motion_count = state.motion_xy, state.motion_count
        if not bool(init.all()):
            f = spec.features
            cs = corners.good_features_to_track_batch(
                crop, max_corners=f.max_corners,
                quality_level=f.quality_level, min_distance=f.min_distance,
                block_size=f.block_size, roi_mask=mask)
            sample = torch.where(init, sample, 0.0)
            lost = torch.where(init, lost, cs.count < 1)
            pts = torch.where(init[:, None, None], pts, cs.pts)
            good = torch.where(init[:, None], good, cs.valid)
            motion_xy = torch.where(init[:, None, None], motion_xy,
                                    state.motion_xy)
            motion_count = torch.where(init, motion_count,
                                       state.motion_count)
    return FlowStep(sample=sample, error=lost, state=FlowState(
        roi=state.roi, initialized=torch.ones_like(init), pts=pts,
        pts_valid=good, motion_xy=motion_xy, motion_count=motion_count))


# After respmon_tpu_torch/pipeline/motion.py:332-334 (_push_rows) and
# :417-422.
def push_ring(data: torch.Tensor, t: torch.Tensor, count: torch.Tensor,
              sample: torch.Tensor, fps: float, buffer_length: int):
    """The (S, N) signal rings ``data`` and ``t`` with (S,) ``count`` after
    one measured step: the oldest sample dropped, ``sample`` appended at
    the next time (0 for a ring's first sample, else the last time plus
    1 / fps, in the rings' float type)."""
    t_next = torch.where(count == 0, 0.0, t[:, -1] + 1.0 / fps)
    return (torch.cat([data[:, 1:], sample.to(data.dtype)[:, None]], dim=1),
            torch.cat([t[:, 1:], t_next.to(t.dtype)[:, None]], dim=1),
            torch.clamp(count + 1, max=buffer_length))


def lowpass(fps: float, cal: CalibrationConfig, measure: MeasureConfig):
    """The BPM estimate's lowpass, at half the calibration's freq_max."""
    return filters.design_butter_lowpass(cal.freq_max * 0.5, float(fps),
                                         measure.filter_order)


def min_distance(fps: float, cal: CalibrationConfig) -> int:
    return max(int(math.floor(fps / cal.freq_max)), 1)


def estimate(data: torch.Tensor, t: torch.Tensor, count: torch.Tensor,
             fps: float, cal: CalibrationConfig, measure: MeasureConfig,
             tf32: bool = False):
    """(has_bpm, bpm) of (S, N) right-aligned rings with (S,) ``count``
    valid samples: the filtfilt lowpass, the peaks, the Gaussian LM fits
    and the mean peak-to-peak interval (reference/bpm.py)."""
    with precision(tf32):
        res = bpm.estimate_bpm(data, t, count, lowpass(fps, cal, measure),
                               min_distance(fps, cal), measure)
        return res.has_bpm, res.bpm


def as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
