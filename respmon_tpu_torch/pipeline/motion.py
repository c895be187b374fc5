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
(the streaming-ROI monitor's re-lock).

The fleet's functions take a batched state (a leading stream axis S on
every field) and an (S, H, W) frame batch, where the JAX package ``vmap``s
the single-stream ones: ``measure_step_batch``, ``measure_step_cached``
(with the carried LK cache ``FlowCache``) and ``relock_state_batch``.  They
read nothing from the device to decide what to run: the crop is one gather
of S windows at the ROIs on the device, and the first-frame corner
detection runs for the batch unless ``initialized_hint`` promises that
every stream has its corners.  ``measure_step`` and ``relock_state`` are
their S = 1 cases.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

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


def _to_u8_scale(img: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> float on the uint8 [0,255] lattice (the reference runs
    corners/LK on float_to_uint8 crops, base.py:364-371)."""
    return torch.trunc(img * 255.0)


def _one(state: MeasureState) -> MeasureState:
    """A single-stream state as a batch of one stream."""
    return MeasureState(*(f[None] for f in state))


def _first(states: MeasureState) -> MeasureState:
    """Stream 0 of a batched state."""
    return MeasureState(*(f[0] for f in states))


def measure_step(state: MeasureState, frame,
                 spec: MeasureSpec) -> Tuple[MeasureState, torch.Tensor]:
    """One frame of the measure state: crop -> motion value -> ring push.

    Returns (new_state, sample).  ``new_state.error`` reports the
    reference's error triggers (no keypoints at init / NaN from lost
    tracking).  The frame is computed where the state lives.

    ``frame`` (a tensor or numpy array) may be float in [0, 1] (the
    capture convention) or native ``uint8``.  The u8 path crops the u8
    frame, then widens the crop to float on the exact [0, 255] integer
    lattice, which is what the reference's cv2 kernels consume
    (base.py:364-371): it skips the float path's ``trunc(f * 255)``
    reconstruction, and both ingests land on identical u8-lattice crops.

    It is ``measure_step_batch`` with one stream; the host reads
    ``state.initialized`` to skip the tracking of a first frame or the
    corners of a later one, as the JAX package's ``lax.cond`` does.
    """
    frame = torch.as_tensor(frame).to(state.data.device)
    new, sample = measure_step_batch(
        _one(state), frame[None], spec,
        initialized_hint=spec.method == "flow" and bool(state.initialized))
    return _first(new), sample[0]


def flow_update(fr: lk.FlowResult, pts, valid, motion_xy, motion_count,
                buffer_length: int, dtype):
    """Shared post-LK bookkeeping (base.py:377-407): surviving-point
    selection, mean (old - new) displacement, motion-ring push, PCA
    projection, NaN on lost tracking.  Used by the per-frame steps (one
    stream, or a leading stream axis on every input) and the whole-clip
    path, so they cannot desynchronize.  Once tracking is lost the ring and
    its count freeze.

    Returns (sample, good_mask, motion_xy, motion_count, lost).
    """
    good = fr.status & valid
    n_good = good.sum(dim=-1)
    lost = n_good == 0   # -> NaN sample (base.py:373-386)

    disp = pts - fr.pts  # old - new (base.py:388)
    gw = good.to(dtype)[..., None]
    mean_disp = (disp * gw).sum(dim=-2) / \
        torch.clamp(n_good, min=1).to(dtype)[..., None]

    motion_xy = torch.where(
        lost[..., None, None], motion_xy,
        torch.cat([motion_xy[..., 1:, :],
                   mean_disp[..., None, :].to(motion_xy.dtype)], dim=-2))
    motion_count = torch.where(
        lost, motion_count,
        torch.clamp(motion_count + 1, max=buffer_length))

    # PCA projection of the newest sample once >= 2 motions buffered
    # (base.py:396-407); before that the sample is 0.0.
    mmask = torch.arange(buffer_length, device=motion_xy.device) >= \
        (buffer_length - motion_count)[..., None]
    proj = pca.pca_project_last(motion_xy, mmask)
    sample = torch.where(motion_count >= 2, proj, 0.0)
    sample = torch.where(lost, float("nan"), sample).to(dtype)
    return sample, good, motion_xy, motion_count, lost


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
    float in [0, 1] or camera-native uint8, as for ``measure_step``.  It
    is ``relock_state_batch`` with one stream."""
    frame = torch.as_tensor(frame).to(state.data.device)
    roi = torch.tensor([[int(v) for v in new_roi]], dtype=torch.int32,
                       device=state.data.device)
    return _first(relock_state_batch(_one(state), frame[None], roi, spec))


# ---------------------------------------------------------------------------
# The fleet: a leading stream axis on every state field and frame.
# ---------------------------------------------------------------------------


class FlowCache(NamedTuple):
    """The carried LK frame structures of each stream's PREVIOUS frame
    (the fleet fast path; respmon_tpu/pipeline/motion.py:260-275).

    A flow step builds the pyramid and padding of its frame for the
    next-role images; the next step needs that crop's pyramid, Scharr maps
    and padding in the prev role, which ``measure_step_batch`` rebuilds
    from ``state.prev_crop``.  The cached step builds its frame's per-level
    padded (image, dx, dy) stacks once and carries them, which saves one
    pyramid build a step, bit for bit: the stacks are a function of the
    crop values ``prev_crop`` holds, and the next-role images are channel
    0 of the same stacks.
    """

    stacks: Tuple[torch.Tensor, ...]   # per level (S, 3, Hp, Wp)


def init_flow_cache(spec: MeasureSpec, dtype=torch.float32,
                    device=None) -> FlowCache:
    """A zero-filled single-stream cache of the right shapes (per level
    (3, Hp, Wp)): the placeholder the ``cache_valid=False`` step ignores,
    rebuilding from ``state.prev_crop``.  The fleet's batched one is
    ``parallel.streams.init_fleet_cache``."""
    device = device_mod.resolve(device)
    win = spec.lk.win_size[0]
    pad = 2 * (win + 2)
    shapes = lk.level_geometry(spec.crop_h, spec.crop_w, spec.lk.max_level)
    return FlowCache(stacks=tuple(
        torch.zeros((3, h + pad, w + pad), dtype=dtype, device=device)
        for h, w in shapes))


def _window_starts(roi: torch.Tensor, spec: MeasureSpec):
    """Clamped (S,) window starts (sy, sx) of (S, 4) ROIs."""
    sx = roi[:, 0].clamp(0, spec.frame_w - spec.crop_w)
    sy = roi[:, 1].clamp(0, spec.frame_h - spec.crop_h)
    return sy, sx


def _crop_batch(frames: torch.Tensor, roi: torch.Tensor, spec: MeasureSpec):
    """Bucketed ROI crops of (S, H, W) frames at (S, 4) ROIs on the device,
    in one gather, and their (S, crop_h, crop_w) validity masks."""
    dev = frames.device
    sy, sx = _window_starts(roi, spec)
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
    return crops, mask


def _u8_lattice(crop: torch.Tensor, mask: torch.Tensor, u8_in: bool):
    """The masked crop on the uint8 [0, 255] lattice the reference's cv2
    kernels consume: a widened u8 crop as it is, a float one through
    ``trunc(f * 255)``."""
    return torch.where(mask, crop, 0) if u8_in \
        else _to_u8_scale(torch.where(mask, crop, 0.0))


def where_streams(cond: torch.Tensor, a, b):
    """Per stream, ``a``'s value where the (S,) ``cond`` holds, else
    ``b``'s; field by field for (named) tuples of (S, ...) tensors."""
    if isinstance(a, tuple):
        vals = [where_streams(cond, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return torch.where(cond.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _push_rows(rings: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Push one value per (S, N) ring: drop the oldest, append last."""
    return torch.cat([rings[:, 1:], values.to(rings.dtype)[:, None]], dim=1)


def _flow_motion_batch(states: MeasureState, crop, mask, spec: MeasureSpec,
                       initialized_hint: bool, u8_in: bool, carry: bool,
                       prev_stacks):
    """The flow branch of a batched step: LK from each stream's previous
    crop, whose structures are ``prev_stacks`` (a valid carried cache) or,
    when that is ``None``, built from ``state.prev_crop``; and unless
    ``initialized_hint``, the corner detection of the first frame, kept
    where a stream is not initialized yet (what JAX's vmapped ``cond``
    computes).  With ``carry`` the new crop's full stacks are built and
    returned as the next step's cache, else only its next-role images and
    no cache.  Returns (samples, states, errors, the new cache or None).
    """
    crop_u8 = _u8_lattice(crop, mask, u8_in).to(states.prev_crop.dtype)
    win = spec.lk.win_size[0]
    max_level = spec.lk.max_level
    shapes = lk.level_geometry(spec.crop_h, spec.crop_w, max_level)
    if carry:
        # One build serves both roles: channel 0 of each stack IS the
        # padded next-role image, and the stacks are next step's prev.
        new_cache = FlowCache(stacks=lk.precompute_frame_inputs(
            crop_u8, win, max_level).stacks)
        images = tuple(st[:, 0] for st in new_cache.stacks)
    else:
        new_cache = None
        images = lk.precompute_frame_inputs(
            crop_u8, win, max_level, with_stacks=False,
            with_images=True).images
    if prev_stacks is None:
        prev_stacks = lk.precompute_frame_inputs(states.prev_crop, win,
                                                 max_level).stacks
    fr = lk.lk_track_precomputed(
        lk.LKFrameInputs(stacks=prev_stacks),
        lk.LKFrameInputs(stacks=(), images=images),
        states.pts, states.pts_valid, shapes, win, max_level,
        spec.lk.max_iters, spec.lk.epsilon)
    sample, good, motion_xy, motion_count, lost = flow_update(
        fr, states.pts, states.pts_valid, states.motion_xy,
        states.motion_count, spec.buffer_length, crop.dtype)
    tracked = states._replace(prev_crop=crop_u8, pts=fr.pts,
                              pts_valid=good, motion_xy=motion_xy,
                              motion_count=motion_count)
    if initialized_hint:
        return sample, tracked, lost, new_cache

    cs = corners.good_features_to_track_batch(
        crop_u8, max_corners=spec.features.max_corners,
        quality_level=spec.features.quality_level,
        min_distance=spec.features.min_distance,
        block_size=spec.features.block_size, roi_mask=mask)
    first = states._replace(initialized=torch.ones_like(states.initialized),
                            prev_crop=crop_u8, pts=cs.pts,
                            pts_valid=cs.valid)
    init = states.initialized
    # "No motion key points found" (base.py:367-368) on a first frame.
    return (torch.where(init, sample, 0.0).to(crop.dtype),
            where_streams(init, tracked, first),
            torch.where(init, lost, cs.count < 1), new_cache)


def _measure_batch(states: MeasureState, frames, spec: MeasureSpec,
                   initialized_hint: bool, carry: bool = False,
                   prev_stacks=None):
    """The batched step; returns (states, the flow cache when ``carry``
    in flow mode, else None, samples)."""
    frames = torch.as_tensor(frames).to(states.data.device)
    crop, mask = _crop_batch(frames, states.roi, spec)
    u8_in = frames.dtype == torch.uint8
    if u8_in:
        crop = crop.to(states.data.dtype)    # exact [0, 255] lattice
    new_cache = None
    if spec.method == "average":
        total = torch.where(mask, crop, 0).sum(dim=(1, 2))
        sample = total / torch.clamp(mask.sum(dim=(1, 2)), min=1)
        if u8_in:
            sample = sample * (1.0 / 255.0)   # the [0, 1] float scale
        new, error = states, states.error
    else:
        sample, new, error, new_cache = _flow_motion_batch(
            states, crop, mask, spec, initialized_hint, u8_in, carry,
            prev_stacks)
    t_next = torch.where(states.count == 0, 0.0,
                         states.t[:, -1] + 1.0 / spec.fps)
    new = new._replace(
        data=_push_rows(states.data, sample),
        t=_push_rows(states.t, t_next),
        count=torch.clamp(states.count + 1, max=spec.buffer_length),
        error=error)
    return new, new_cache, sample


def measure_step_batch(states: MeasureState, frames, spec: MeasureSpec,
                       initialized_hint: bool = False
                       ) -> Tuple[MeasureState, torch.Tensor]:
    """``measure_step`` for S streams at once: batched ``states`` and
    (S, H, W) ``frames`` (float in [0, 1] or camera-native uint8), one
    frame per stream.  Returns (new states, (S,) samples).

    ``initialized_hint`` promises that every stream already has its
    corners (the JAX package's static ``initialized_hint``,
    respmon_tpu/pipeline/motion.py:171): the step then skips corner
    detection.  Without it, flow mode runs the corners AND the tracking for
    the whole batch and keeps each stream's own branch."""
    new, _, sample = _measure_batch(states, frames, spec, initialized_hint)
    return new, sample


def measure_step_cached(states: MeasureState, cache: Optional[FlowCache],
                        frames, spec: MeasureSpec,
                        initialized_hint: bool = False,
                        cache_valid: bool = True
                        ) -> Tuple[MeasureState, FlowCache, torch.Tensor]:
    """``measure_step_batch`` with the carried prev-frame LK cache (flow
    mode), bit for bit the same results and one pyramid build cheaper per
    step.  ``cache_valid=False`` rebuilds the prev structures from
    ``state.prev_crop`` (the first step after a calibration, a restore or
    any outside change of the states), and ``cache`` may then be ``None``
    or ``init_flow_cache``'s placeholder; the returned cache is valid
    either way.  Average mode returns the cache untouched."""
    if spec.method != "flow":
        new, sample = measure_step_batch(states, frames, spec,
                                         initialized_hint)
        return new, cache, sample
    return _measure_batch(states, frames, spec, initialized_hint, True,
                          cache.stacks if cache_valid else None)


def relock_state_batch(states: MeasureState, frames,
                       new_rois: torch.Tensor,
                       spec: MeasureSpec) -> MeasureState:
    """``relock_state`` for S streams at once: every stream moves onto its
    row of the (S, 4) ``new_rois`` (the caller keeps the streams it does
    not move, as ``parallel.streams.relock_streams`` does)."""
    dev = states.data.device
    frames = torch.as_tensor(frames).to(dev)
    new_rois = torch.as_tensor(new_rois, dtype=torch.int32, device=dev)
    sy_old, sx_old = _window_starts(states.roi, spec)
    sy_new, sx_new = _window_starts(new_rois, spec)
    crop, mask = _crop_batch(frames, new_rois, spec)
    crop_u8 = _u8_lattice(crop, mask, frames.dtype == torch.uint8)
    shift = torch.stack([sx_old - sx_new, sy_old - sy_new],
                        dim=-1).to(states.pts.dtype)
    pts = states.pts + shift[:, None, :]
    inb = ((pts[..., 0] >= 0) & (pts[..., 0] <= spec.crop_w - 1)
           & (pts[..., 1] >= 0) & (pts[..., 1] <= spec.crop_h - 1))
    valid = states.pts_valid & inb
    return states._replace(
        roi=new_rois, prev_crop=crop_u8.to(states.prev_crop.dtype), pts=pts,
        pts_valid=valid,
        initialized=states.initialized & (valid.sum(dim=1) > 0))
