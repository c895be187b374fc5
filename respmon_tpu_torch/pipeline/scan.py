"""Whole-clip path: calibrate on the first buffer, measure the rest, and
estimate a BPM for every frame.

Port of ``respmon_tpu/pipeline/scan.py``: ``evm.locate`` on the
calibration buffer, the motion sample of every remaining frame (the ROI
crop means, or in flow mode corners on the first frame and LK tracking
from frame to frame), and the per-frame BPM trace computed as one batch of
windows (each frame's estimate depends only on its window of samples).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from respmon_tpu_torch.config import MonitorConfig
from respmon_tpu_torch.ops import corners, filters, lk
from respmon_tpu_torch.ops.dtype import ingest_frames
from respmon_tpu_torch.pipeline import bpm as bpm_mod
from respmon_tpu_torch.pipeline import evm, motion
from respmon_tpu_torch.utils.bbox import reduce_bounding_box


class ClipMeasureResult(NamedTuple):
    samples: torch.Tensor    # (T,) per-frame motion values
    t: torch.Tensor          # (T,) time axis
    bpm: torch.Tensor        # (T,) BPM trace (valid where has_bpm)
    has_bpm: torch.Tensor    # (T,) bool
    error: torch.Tensor      # (T,) bool — per-frame error flag
    final_state: motion.MeasureState


def bpm_trace(samples: torch.Tensor, fps: float,
              coeffs: filters.FilterCoeffs, min_dist: int, cfg):
    """Per-frame BPM trace of a whole clip: the (T, N) matrix of
    right-aligned ring windows goes through ``estimate_bpm`` as one batch.
    Returns (bpm, has_bpm), each (T,)."""
    t_len = samples.shape[0]
    n = cfg.buffer_length
    dev = samples.device
    frame = torch.arange(t_len, device=dev)
    src = frame[:, None] - (n - 1) + torch.arange(n, device=dev)[None, :]
    wins = samples[src.clamp(0, t_len - 1)]
    ts = src.to(samples.dtype) / fps
    counts = torch.clamp(frame + 1, max=n)
    r = bpm_mod.estimate_bpm(wins, ts, counts, coeffs, min_dist, cfg)
    return r.bpm, r.has_bpm & (counts > cfg.initialization_length)


def _flow_samples_clip(crops: torch.Tensor, mask: torch.Tensor,
                       spec: motion.MeasureSpec):
    """Flow-mode motion samples for a whole clip.

    The per-frame heavy lifting (pyramids, Scharr maps, padding) happens as
    ONE batch over all frames before the frame loop: clips are known
    upfront, so none of it needs to sit on the sequential path.  The loop
    then carries only the small tracking state (points, masks, motion ring)
    and does window gathers and Newton iterations; it is a Python loop,
    because each frame's points depend on the last frame's.

    Error semantics: this is ONE calibrate->measure episode.  Once tracking
    is lost, samples stay NaN for the remainder (no corner re-detection);
    the per-frame ``error`` flags mark where the streaming monitor would
    have entered its error state and recalibrated.  Callers wanting
    recovery re-run ``process_clip`` from the loss point.
    """
    t_len = crops.shape[0]
    dev = crops.device
    n_ring = spec.buffer_length
    win = spec.lk.win_size[0]
    max_level = spec.lk.max_level
    u8_in = crops.dtype == torch.uint8
    dtype = torch.float32 if u8_in else crops.dtype

    # u8 crops are ALREADY the exact [0,255] lattice the float path's
    # trunc(f*255) reconstructs: widen and mask, skipping the roundtrip
    # (as motion.measure_step does).
    crops_u8 = torch.where(mask, crops, 0).to(dtype) if u8_in \
        else motion._to_u8_scale(torch.where(mask, crops, 0.0))

    # The next-role images are channel 0 of the prev-role stacks.
    stacks = lk.precompute_frame_inputs(crops_u8, win, max_level).stacks

    cs = corners.good_features_to_track(
        crops_u8[0], max_corners=spec.features.max_corners,
        quality_level=spec.features.quality_level,
        min_distance=spec.features.min_distance,
        block_size=spec.features.block_size, roi_mask=mask)
    first_error = cs.count < 1   # base.py:367-368

    shapes = lk.level_geometry(spec.crop_h, spec.crop_w, max_level)
    pts, valid = cs.pts, cs.valid
    motion_xy = torch.zeros((n_ring, 2), dtype=dtype, device=dev)
    motion_count = torch.zeros((), dtype=torch.int32, device=dev)
    # Frame 0: corner detection, sample 0.0 (base.py:363-369).
    samples = [torch.zeros((), dtype=dtype, device=dev)]
    errors = [first_error]
    for i in range(1, t_len):
        fr = lk.lk_track_precomputed(
            lk.LKFrameInputs(stacks=tuple(s[i - 1] for s in stacks)),
            lk.LKFrameInputs(stacks=(),
                             images=tuple(s[i, 0] for s in stacks)),
            pts, valid, shapes, win, max_level, spec.lk.max_iters,
            spec.lk.epsilon)
        sample, valid, motion_xy, motion_count, lost = motion.flow_update(
            fr, pts, valid, motion_xy, motion_count, n_ring, dtype)
        pts = fr.pts
        samples.append(sample)
        errors.append(lost)

    flow_state = dict(initialized=torch.ones((), dtype=torch.bool, device=dev),
                      prev_crop=crops_u8[-1].to(dtype),
                      pts=pts, pts_valid=valid,
                      motion_xy=motion_xy, motion_count=motion_count)
    return torch.stack(samples), torch.stack(errors), flow_state


def measure_clip(frames: torch.Tensor, roi: Sequence[int],
                 spec: motion.MeasureSpec, coeffs: filters.FilterCoeffs,
                 min_dist: int, cfg,
                 estimate_every_frame: bool = True) -> ClipMeasureResult:
    """Whole-clip measurement: the motion sample of every frame (ROI crop
    means, or the flow-mode track), then the batched BPM trace.  Semantics
    match the per-frame ``motion.measure_step``.

    ``frames`` is (T, H, W) float in [0, 1] or camera-native uint8, on the
    device the measurement runs on.  A u8 clip widens on the device:
    average mode sums the exact integer lattice and rescales once, flow
    mode lands on the same u8-lattice crops as the float path, as in the
    JAX package."""
    t_len = frames.shape[0]
    dev = frames.device
    u8_in = frames.dtype == torch.uint8
    dtype = torch.float32 if u8_in else frames.dtype
    n_ring = spec.buffer_length
    crops, mask = motion.crop_clip_and_mask(frames, roi, spec)

    if spec.method == "average":
        vals = crops.to(dtype)
        msum = torch.where(mask, vals, 0.0).sum(dim=(1, 2))
        samples = msum / torch.clamp(mask.sum(), min=1)
        if u8_in:
            samples = samples * (1.0 / 255.0)
        errors = torch.zeros((t_len,), dtype=torch.bool, device=dev)
        flow_state = {}
    else:
        samples, errors, flow_state = _flow_samples_clip(crops, mask, spec)

    t = torch.arange(t_len, device=dev).to(dtype) / spec.fps
    if estimate_every_frame:
        bpm, has = bpm_trace(samples, spec.fps, coeffs, min_dist, cfg)
    else:
        bpm = torch.zeros_like(samples)
        has = torch.zeros(samples.shape, dtype=torch.bool, device=dev)

    # The final MeasureState (for resume / API parity).
    count = min(t_len, n_ring)
    src = torch.arange(n_ring, device=dev) + t_len - n_ring
    gather = src.clamp(0, t_len - 1)
    ring = torch.where(src >= 0, samples[gather], 0.0)
    t_ring = torch.where(src >= 0, t[gather], 0.0)
    final = motion.init_state(spec, (0, 0, 0, 0), dtype=dtype, device=dev)
    final = final._replace(
        roi=torch.as_tensor([int(v) for v in roi], dtype=torch.int32,
                            device=dev),
        data=ring, t=t_ring,
        count=torch.tensor(count, dtype=torch.int32, device=dev),
        error=errors[-1], **flow_state)
    return ClipMeasureResult(samples=samples, t=t, bpm=bpm, has_bpm=has,
                             error=errors, final_state=final)


class ClipRunResult(NamedTuple):
    found: bool
    roi: Optional[Tuple[int, int, int, int]]
    measure: Optional[ClipMeasureResult]
    final_bpm: Optional[float]
    error_frame: Optional[int] = None


def process_clip(frames, fps: float, cfg: MonitorConfig,
                 dtype=torch.float32, estimate_every_frame: bool = True,
                 device=None) -> ClipRunResult:
    """Calibrate on frames 1..buffer_length, then measure the rest (frame 0
    is eaten by the monitor's initialize state, and the frame after the
    buffer arrives during locate and is dropped: base.py:423-463).

    This is ONE calibrate->measure episode: it does not recalibrate after
    a tracking loss (flow mode); ``error_frame`` reports where that would
    have happened.

    ``frames`` is a (T, H, W) numpy array or tensor, float in [0, 1] or
    uint8.  The run is on the card unless ``device`` says otherwise
    (``ops/dtype.ingest_frames``: without a CUDA device ``device=None``
    raises, and a CPU run passes ``device="cpu"``)."""
    cal_len = cfg.calibration.buffer_length
    if frames.shape[0] <= cal_len + 2:
        raise ValueError("clip shorter than calibration")
    cal = ingest_frames(frames[1:cal_len + 1], dtype, device)

    loc = evm.locate(cal, float(fps), cfg.calibration)
    if not bool(loc.found):
        return ClipRunResult(found=False, roi=None, measure=None,
                             final_bpm=None)
    x, y, w, h = (int(v) for v in torch.stack(
        [loc.x, loc.y, loc.w, loc.h]).tolist())
    x, y, w, h = reduce_bounding_box(
        x, y, w, h, cfg.calibration.maximum_bounding_box_area)

    spec = motion.MeasureSpec.for_roi(cfg, frames.shape[1], frames.shape[2],
                                      w, h, float(fps))
    coeffs = filters.design_butter_lowpass(
        cfg.calibration.freq_max * 0.5, float(fps), cfg.measure.filter_order)
    min_dist = max(int(np.floor(fps / cfg.calibration.freq_max)), 1)

    rest = ingest_frames(frames[cal_len + 2:], dtype, cal.device)
    res = measure_clip(rest, (x, y, w, h), spec, coeffs, min_dist,
                       cfg.measure, estimate_every_frame=estimate_every_frame)

    has = res.has_bpm.cpu().numpy()
    final_bpm = float(res.bpm.cpu().numpy()[has][-1]) if has.any() else None
    errs = res.error.cpu().numpy()
    error_frame = int(np.argmax(errs)) if errs.any() else None
    return ClipRunResult(found=True, roi=(x, y, w, h), measure=res,
                         final_bpm=final_bpm, error_frame=error_frame)


class ClipEpisode(NamedTuple):
    start_frame: int           # absolute clip index this episode began at
    result: ClipRunResult


class AutoClipResult(NamedTuple):
    episodes: Tuple[ClipEpisode, ...]
    final_bpm: Optional[float]     # last BPM across all episodes
    recoveries: int                # episodes begun after a tracking loss
    exhausted: bool                # stopped on max_episodes, not clip end


def process_clip_auto(frames, fps: float, cfg: MonitorConfig,
                      dtype=torch.float32, estimate_every_frame: bool = True,
                      max_episodes: int = 8, error_reset_delay: float = 0.0,
                      device=None) -> AutoClipResult:
    """``process_clip`` with the streaming monitor's error -> recalibrate
    cycle (reference base.py:496-533): after a reported ``error_frame`` the
    next episode starts at loss + 1 + round(error_reset_delay * fps);
    found=False retries on the next ``buffer_length`` frames."""
    cal_len = cfg.calibration.buffer_length
    delay_frames = int(round(error_reset_delay * fps))
    episodes = []
    recoveries = 0
    start = 0
    n = int(frames.shape[0])
    clean_end = False
    while len(episodes) < max_episodes and n - start > cal_len + 2:
        res = process_clip(frames[start:], fps, cfg, dtype=dtype,
                           estimate_every_frame=estimate_every_frame,
                           device=device)
        episodes.append(ClipEpisode(start_frame=start, result=res))
        if not res.found:
            start += cal_len
            continue
        if res.error_frame is None:
            clean_end = True
            break
        start = start + cal_len + 2 + res.error_frame + 1 + delay_frames
        recoveries += 1
    exhausted = (not clean_end and len(episodes) >= max_episodes
                 and n - start > cal_len + 2)

    final_bpm = None
    for ep in episodes:
        if ep.result.final_bpm is not None:
            final_bpm = ep.result.final_bpm
    return AutoClipResult(episodes=tuple(episodes), final_bpm=final_bpm,
                          recoveries=recoveries, exhausted=exhausted)
