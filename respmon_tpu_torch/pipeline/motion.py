"""Per-clip motion extraction state and the ROI crop.

Port of the average-mode part of ``respmon_tpu/pipeline/motion.py``
(reference base.py:354-358, 464-494): the bucketed ROI crop with its
validity mask, and the measurement state whose rings the whole-clip path
returns.  Flow mode (corners, LK, PCA) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from respmon_tpu.config import FeatureParams, LKParams, MonitorConfig


# Copied from respmon_tpu/pipeline/motion.py:37-84 (that module imports
# jax), without its LK sampling-mode fields: those select TPU gather
# strategies, and the port will have one LK path.
@dataclasses.dataclass(frozen=True)
class MeasureSpec:
    """Static (hashable) parameters of the measurement program."""

    frame_h: int
    frame_w: int
    crop_h: int                 # bucketed ROI height
    crop_w: int                 # bucketed ROI width
    buffer_length: int          # signal ring capacity (reference 128)
    method: str                 # 'average' | 'flow'
    fps: float
    features: FeatureParams = FeatureParams()
    lk: LKParams = LKParams()

    @staticmethod
    def bucket(dim: int, bucket: int, cap: int) -> int:
        return min(-(-dim // bucket) * bucket, cap)

    @classmethod
    def for_roi(cls, cfg: MonitorConfig, frame_h: int, frame_w: int,
                roi_w: int, roi_h: int, fps: float) -> "MeasureSpec":
        return cls(frame_h=frame_h, frame_w=frame_w,
                   crop_h=cls.bucket(roi_h, cfg.roi_bucket, frame_h),
                   crop_w=cls.bucket(roi_w, cfg.roi_bucket, frame_w),
                   buffer_length=cfg.measure.buffer_length,
                   method=cfg.motion_extraction_method, fps=fps,
                   features=cfg.features, lk=cfg.lk)


class MeasureState(NamedTuple):
    """Measurement state, field for field the JAX package's."""

    data: torch.Tensor          # (N,) signal ring, right-aligned
    t: torch.Tensor             # (N,)
    count: torch.Tensor         # int32 valid samples
    roi: torch.Tensor           # (4,) int32: x, y, w, h
    initialized: torch.Tensor   # bool — corners detected yet (flow)
    prev_crop: torch.Tensor     # (crop_h, crop_w) uint8-scale float
    pts: torch.Tensor           # (max_corners, 2) float32 crop coords
    pts_valid: torch.Tensor     # (max_corners,) bool
    motion_xy: torch.Tensor     # (N, 2) mean-displacement ring
    motion_count: torch.Tensor  # int32
    error: torch.Tensor         # bool — tracking lost / no keypoints


def init_state(spec: MeasureSpec, roi: Sequence[int],
               dtype=torch.float32, device=None) -> MeasureState:
    n = spec.buffer_length
    m = spec.features.max_corners

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return MeasureState(
        data=zeros((n,)), t=zeros((n,)),
        count=zeros((), torch.int32),
        roi=torch.as_tensor(roi, dtype=torch.int32, device=device),
        initialized=zeros((), torch.bool),
        prev_crop=zeros((spec.crop_h, spec.crop_w)),
        pts=zeros((m, 2), torch.float32),
        pts_valid=zeros((m,), torch.bool),
        motion_xy=zeros((n, 2)),
        motion_count=zeros((), torch.int32),
        error=zeros((), torch.bool),
    )


def _roi_window_mask(roi: Sequence[int], spec: MeasureSpec, device=None):
    """Clamped window start + validity mask of a bucketed ROI crop: the
    window start clamps to fit the frame, so the ROI may sit at an offset
    inside the window; the mask accounts for it."""
    x, y, w, h = (int(v) for v in roi)
    sx = min(max(x, 0), spec.frame_w - spec.crop_w)
    sy = min(max(y, 0), spec.frame_h - spec.crop_h)
    dx, dy = x - sx, y - sy
    rows = torch.arange(spec.crop_h, device=device)[:, None]
    cols = torch.arange(spec.crop_w, device=device)[None, :]
    mask = (rows >= dy) & (rows < dy + h) & (cols >= dx) & (cols < dx + w)
    return (sy, sx), mask


def crop_clip_and_mask(frames: torch.Tensor, roi: Sequence[int],
                       spec: MeasureSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketed ROI crop of a whole (T, H, W) clip (the ROI is fixed for
    the clip) and its (crop_h, crop_w) validity mask."""
    (sy, sx), mask = _roi_window_mask(roi, spec, frames.device)
    crops = frames[:, sy:sy + spec.crop_h, sx:sx + spec.crop_w]
    return crops, mask
