"""Whole-clip path: calibrate on the first buffer, measure the rest, and
estimate a BPM for every frame.

Port of the average-mode part of ``respmon_tpu/pipeline/scan.py``:
``evm.locate`` on the calibration buffer, the ROI crop means of every
remaining frame, and the per-frame BPM trace computed as one batch of
windows (each frame's estimate depends only on its window of samples).
Flow mode is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from respmon_tpu.config import MonitorConfig
from respmon_tpu.utils.bbox import reduce_bounding_box
from respmon_tpu_torch.ops import filters
from respmon_tpu_torch.ops.dtype import ingest_frames
from respmon_tpu_torch.pipeline import bpm as bpm_mod
from respmon_tpu_torch.pipeline import evm, motion


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


def measure_clip(frames: torch.Tensor, roi: Sequence[int],
                 spec: motion.MeasureSpec, coeffs: filters.FilterCoeffs,
                 min_dist: int, cfg,
                 estimate_every_frame: bool = True) -> ClipMeasureResult:
    """Whole-clip measurement (average mode): ROI crop means of every
    frame, then the batched BPM trace.

    ``frames`` is (T, H, W) float in [0, 1] or camera-native uint8; a u8
    clip sums the exact integer lattice and rescales once, as in the JAX
    package."""
    if spec.method != "average":
        raise NotImplementedError("flow mode: later PR")
    t_len = frames.shape[0]
    dev = frames.device
    u8_in = frames.dtype == torch.uint8
    dtype = torch.float32 if u8_in else frames.dtype
    n_ring = spec.buffer_length
    crops, mask = motion.crop_clip_and_mask(frames, roi, spec)

    vals = crops.to(dtype)
    msum = torch.where(mask, vals, 0.0).sum(dim=(1, 2))
    samples = msum / torch.clamp(mask.sum(), min=1)
    if u8_in:
        samples = samples * (1.0 / 255.0)
    errors = torch.zeros((t_len,), dtype=torch.bool, device=dev)

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
        error=errors[-1])
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

    ``frames`` is a (T, H, W) numpy array or tensor, float in [0, 1] or
    uint8; ``device`` defaults to the tensor's device (CPU for numpy)."""
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
