"""Per-frame motion extraction: the reference's measure-state inner loop.

Port of ``respmon_tpu/pipeline/motion.py`` (reference base.py:354-407 +
464-494): crop the frame to the calibrated ROI, then either

  - 'average': mean of the cropped pixels (base.py:355-358), or
  - 'flow': Shi-Tomasi corners on the first frame (error if none),
    pyramidal LK tracking afterwards, surviving-point bookkeeping, NaN on
    lost tracking, mean (old - new) displacement pushed to a motion ring,
    and a full-ring PCA first-eigenvector projection of the newest sample
    (base.py:360-407);

plus the ring discipline (popleft at capacity, base.py:473-475) and the
time axis t += 1/fps (base.py:481-484).  The ROI crop is a *bucketed*
window (ROI dims rounded up to ``roi_bucket``) with a validity mask.  The
state is a NamedTuple of tensors; ``measure_step`` returns a new one and
changes nothing in place.  ``relock_state`` moves a state onto a new ROI
(the streaming-ROI monitor's re-lock).  Not ported yet: the carried LK
cache of the fleet step (``FlowCache``, ``measure_step_cached``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.config import FeatureParams, LKParams, MonitorConfig
from respmon_tpu_torch.ops import corners, lk, pca


# Copied from respmon_tpu/pipeline/motion.py:37-84 (that module imports
# jax), without its LK sampling-mode fields: those select TPU gather
# strategies, and the port has one LK path.
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
    """An empty measurement state on ``device`` (``None``: the card, see
    ``device.resolve``)."""
    device = device_mod.resolve(device)
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


def _crop_and_mask(frame: torch.Tensor, roi: Sequence[int],
                   spec: MeasureSpec):
    """Bucketed ROI crop of a single (H, W) frame and its mask."""
    (sy, sx), mask = _roi_window_mask(roi, spec, frame.device)
    return frame[sy:sy + spec.crop_h, sx:sx + spec.crop_w], mask


def _to_u8_scale(img: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> float on the uint8 [0,255] lattice (the reference runs
    corners/LK on float_to_uint8 crops, base.py:364-371)."""
    return torch.trunc(img * 255.0)


def _push(ring: torch.Tensor, value) -> torch.Tensor:
    value = torch.as_tensor(value, dtype=ring.dtype, device=ring.device)
    return torch.cat([ring[1:], value.reshape((1,) + ring.shape[1:])], dim=0)


def measure_step(state: MeasureState, frame,
                 spec: MeasureSpec) -> Tuple[MeasureState, torch.Tensor]:
    """One frame of the measure state: crop -> motion value -> ring push.

    Returns (new_state, sample).  ``new_state.error`` reports the
    reference's error triggers (no keypoints at init / NaN from lost
    tracking).  The frame is computed where the state lives.

    ``frame`` (a tensor or numpy array) may be float in [0, 1] (the
    capture convention) or native ``uint8``.  The u8 path crops the u8 frame, then widens the crop to
    float on the exact [0, 255] integer lattice, which is what the
    reference's cv2 kernels consume (base.py:364-371): it skips the float
    path's ``trunc(f * 255)`` reconstruction, and both ingests land on
    identical u8-lattice crops.
    """
    frame = torch.as_tensor(frame).to(state.data.device)
    roi = [int(v) for v in state.roi.tolist()]
    crop, mask = _crop_and_mask(frame, roi, spec)
    u8_in = frame.dtype == torch.uint8
    dtype = state.data.dtype
    if u8_in:
        crop = crop.to(dtype)          # exact [0, 255] lattice

    if spec.method == "average":
        total = torch.where(mask, crop, 0).sum()
        sample = total / torch.clamp(mask.sum(), min=1)
        if u8_in:
            sample = sample * (1.0 / 255.0)   # match the [0, 1] float scale
        new_state = state
        error = state.error
    else:
        sample, new_state, error = _flow_motion(state, crop, mask, spec,
                                                crop_is_u8_scale=u8_in)

    t_next = torch.where(state.count == 0, 0.0,
                         state.t[-1] + 1.0 / spec.fps)
    new_state = new_state._replace(
        data=_push(state.data, sample),
        t=_push(state.t, t_next),
        count=torch.clamp(state.count + 1, max=spec.buffer_length),
        error=error,
    )
    return new_state, sample


def flow_update(fr: lk.FlowResult, pts, valid, motion_xy, motion_count,
                buffer_length: int, dtype):
    """Shared post-LK bookkeeping (base.py:377-407): surviving-point
    selection, mean (old - new) displacement, motion-ring push, PCA
    projection, NaN on lost tracking.  Used by both the per-frame step and
    the whole-clip path so the two cannot desynchronize.  Once tracking is
    lost the ring and its count freeze.

    Returns (sample, good_mask, motion_xy, motion_count, lost).
    """
    good = fr.status & valid
    n_good = good.sum()
    lost = n_good == 0   # -> NaN sample (base.py:373-386)

    disp = pts - fr.pts  # old - new (base.py:388)
    gw = good.to(dtype)[:, None]
    mean_disp = (disp * gw).sum(dim=0) / torch.clamp(n_good, min=1).to(dtype)

    motion_xy = torch.where(
        lost, motion_xy,
        torch.cat([motion_xy[1:], mean_disp[None].to(motion_xy.dtype)],
                  dim=0))
    motion_count = torch.where(
        lost, motion_count,
        torch.clamp(motion_count + 1, max=buffer_length))

    # PCA projection of the newest sample once >= 2 motions buffered
    # (base.py:396-407); before that the sample is 0.0.
    mmask = torch.arange(buffer_length, device=motion_xy.device) >= \
        (buffer_length - motion_count)
    proj = pca.pca_project_last(motion_xy, mmask)
    sample = torch.where(motion_count >= 2, proj, 0.0)
    sample = torch.where(lost, float("nan"), sample).to(dtype)
    return sample, good, motion_xy, motion_count, lost


def _flow_motion(state: MeasureState, crop, mask, spec: MeasureSpec,
                 crop_is_u8_scale: bool = False):
    crop_u8 = torch.where(mask, crop, 0) if crop_is_u8_scale \
        else _to_u8_scale(torch.where(mask, crop, 0.0))
    crop_u8 = crop_u8.to(state.prev_crop.dtype)

    if not bool(state.initialized):
        cs = corners.good_features_to_track(
            crop_u8, max_corners=spec.features.max_corners,
            quality_level=spec.features.quality_level,
            min_distance=spec.features.min_distance,
            block_size=spec.features.block_size, roi_mask=mask)
        err = cs.count < 1  # "No motion key points found" (base.py:367-368)
        new = state._replace(
            initialized=torch.ones_like(state.initialized),
            prev_crop=crop_u8, pts=cs.pts, pts_valid=cs.valid)
        return torch.zeros((), dtype=crop.dtype, device=crop.device), new, err

    fr = lk.calc_optical_flow_pyr_lk(
        state.prev_crop, crop_u8, state.pts, state.pts_valid,
        win=spec.lk.win_size[0], max_level=spec.lk.max_level,
        max_iters=spec.lk.max_iters, eps=spec.lk.epsilon)
    sample, good, motion_xy, motion_count, lost = flow_update(
        fr, state.pts, state.pts_valid, state.motion_xy,
        state.motion_count, spec.buffer_length, crop.dtype)
    new = state._replace(prev_crop=crop_u8, pts=fr.pts, pts_valid=good,
                         motion_xy=motion_xy, motion_count=motion_count)
    return sample, new, lost


def relock_state(state: MeasureState, frame, new_roi: Sequence[int],
                 spec: MeasureSpec) -> MeasureState:
    """Move a measurement state onto a new ROI without losing tracking
    (the streaming-ROI monitor's re-lock; the reference can only
    recalibrate from scratch).

    The crop window shifts with the ROI, so tracked points move by the
    change in window origin (they keep to the same pixels of the frame),
    and ``prev_crop`` is cropped anew from the CURRENT frame at the new
    window, so the next LK step sees a consistent pair.  Points that leave
    the new window are dropped; when none is left, ``initialized`` drops
    too and the next step detects corners on the new crop.  ``frame`` is
    float in [0, 1] or camera-native uint8, as for ``measure_step``."""
    dev = state.data.device
    frame = torch.as_tensor(frame).to(dev)
    old_roi = [int(v) for v in state.roi.tolist()]
    new_roi = [int(v) for v in new_roi]
    (sy_old, sx_old), _ = _roi_window_mask(old_roi, spec, dev)
    (sy_new, sx_new), _ = _roi_window_mask(new_roi, spec, dev)
    crop, mask = _crop_and_mask(frame, new_roi, spec)
    if frame.dtype == torch.uint8:
        crop_u8 = torch.where(mask, crop, 0)
    else:
        crop_u8 = _to_u8_scale(torch.where(mask, crop, 0.0))
    shift = torch.tensor([sx_old - sx_new, sy_old - sy_new],
                         dtype=state.pts.dtype, device=dev)
    pts = state.pts + shift
    inb = ((pts[:, 0] >= 0) & (pts[:, 0] <= spec.crop_w - 1)
           & (pts[:, 1] >= 0) & (pts[:, 1] <= spec.crop_h - 1))
    valid = state.pts_valid & inb
    return state._replace(
        roi=torch.tensor(new_roi, dtype=torch.int32, device=dev),
        prev_crop=crop_u8.to(state.prev_crop.dtype), pts=pts,
        pts_valid=valid, initialized=state.initialized & (valid.sum() > 0))
