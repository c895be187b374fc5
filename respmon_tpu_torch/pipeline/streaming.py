"""Streaming (incremental) EVM calibrator: a localizer over a rolling window.

Port of ``respmon_tpu/pipeline/streaming.py`` (the successor of the
reference prototype's sliding-window EVM, prototypes/locating.py:94-147):
per kept Laplacian level a rolling (T, h_i, w_i) ring on the device.  Each
absorbed frame builds its kept levels (``evm._band_laplacian_levels``: on
the card the K1 kernels, with T = 1) and shifts them into the rings; a
localize bandpasses the rings, collapses, and reduces the heatmap to the
largest component's bbox, so the monitor can follow a subject that moves.

A state is a NamedTuple of tensors; every function returns a new one and
changes nothing in place.  The ``*_batch`` functions and ``coarse=True``
serve a fleet of streams (rings with a leading stream axis).  A fleet
localize (``localize_batch``) bandpasses each kept level of all S streams
in one operator product and collapses them as one stack; only the
connected-component search runs stream by stream.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.ops import ccl
from respmon_tpu_torch.ops.dtype import float_to_uint8, uint8_to_float
from respmon_tpu_torch.ops.fft_bandpass import temporal_bandpass_fft
from respmon_tpu_torch.ops.pyramid import pyramid_shapes
from respmon_tpu_torch.pipeline import evm

# The most float32 frame bytes a fleet warm start sends through K1 at once.
WARM_START_CHUNK_BYTES = 1 << 30


class StreamingState(NamedTuple):
    levels: Tuple[torch.Tensor, ...]  # per-kept-level (T, h_i, w_i) rings
    count: torch.Tensor               # int32 frames absorbed (saturates at T)


class StreamingLocate(NamedTuple):
    ready: torch.Tensor
    found: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    heatmap_u8: torch.Tensor


def _kept_levels(cfg: CalibrationConfig):
    return list(range(cfg.skip_levels_at_top, cfg.pyramid_levels - 1))


def _float_frames(frames: torch.Tensor) -> torch.Tensor:
    """Camera-native uint8 widens on the device (ops/dtype contract)."""
    return uint8_to_float(frames) if frames.dtype == torch.uint8 else frames


def init_streaming_state(h: int, w: int, cfg: CalibrationConfig,
                         dtype=torch.float32, device=None) -> StreamingState:
    """Empty rings for (h, w) frames on ``device`` (``None``: the card)."""
    device = device_mod.resolve(device)
    shapes = pyramid_shapes(h, w, cfg.pyramid_levels)
    levels = tuple(
        torch.zeros((cfg.buffer_length,) + tuple(shapes[i]), dtype=dtype,
                    device=device)
        for i in _kept_levels(cfg))
    return StreamingState(levels=levels, count=torch.zeros(
        (), dtype=torch.int32, device=device))


def init_streaming_from_buffer(buffer: torch.Tensor,
                               cfg: CalibrationConfig) -> StreamingState:
    """Warm-start the rings from a (T', H, W) calibration buffer with one
    K1 call over its last ``buffer_length`` frames (newest last, the order
    ``streaming_absorb`` keeps), so a monitor that just calibrated can
    localize at once instead of waiting ``buffer_length`` frames."""
    t = cfg.buffer_length
    buf = _float_frames(buffer[-t:])
    band_lap = evm._band_laplacian_levels(buf.contiguous(), cfg)
    return StreamingState(
        levels=tuple(band_lap[i] for i in _kept_levels(cfg)),
        count=torch.tensor(t, dtype=torch.int32, device=buf.device))


def streaming_absorb(state: StreamingState, frame,
                     cfg: CalibrationConfig) -> StreamingState:
    """Absorb one (H, W) frame into the rings without localizing, the
    cheap half of ``streaming_update``: one K1 call at T = 1 for the kept
    levels, then each ring drops its oldest frame and takes the new one
    last.  ``frame`` is computed where the state lives."""
    frame = _float_frames(torch.as_tensor(frame).to(state.count.device))
    band_lap = evm._band_laplacian_levels(frame.contiguous()[None], cfg)
    levels = tuple(torch.cat([ring[1:], band_lap[lvl].to(ring.dtype)])
                   for ring, lvl in zip(state.levels, _kept_levels(cfg)))
    return StreamingState(
        levels=levels,
        count=torch.clamp(state.count + 1, max=cfg.buffer_length))


def streaming_absorb_batch(state: StreamingState, frames: torch.Tensor,
                           cfg: CalibrationConfig) -> StreamingState:
    """Fleet absorb: (S, H, W) frames, one per stream, into batched
    (S, T, h, w) rings, with one K1 call over the S frames."""
    frames = _float_frames(frames)
    band_lap = evm._band_laplacian_levels(frames.contiguous(), cfg)
    levels = tuple(
        torch.cat([ring[:, 1:], band_lap[lvl][:, None].to(ring.dtype)], dim=1)
        for ring, lvl in zip(state.levels, _kept_levels(cfg)))
    return StreamingState(
        levels=levels,
        count=torch.clamp(state.count + 1, max=cfg.buffer_length))


def init_streaming_from_buffers_batch(buffers: torch.Tensor,
                                      cfg: CalibrationConfig
                                      ) -> StreamingState:
    """Fleet warm start: (S, T', H, W) buffers to batched rings, with K1
    over the flattened (S*T, H, W) stack.  The stack goes through K1 in
    chunks of at most ``WARM_START_CHUNK_BYTES`` of float frames (64
    streams of 128 1080p frames are 68 GB as float32); K1 works frame by
    frame, so the chunks give the same bits as one call."""
    s = buffers.shape[0]
    t = cfg.buffer_length
    h, w = buffers.shape[2:]
    flat = buffers[:, -t:].reshape((s * t, h, w))
    step = max(1, WARM_START_CHUNK_BYTES // (4 * h * w))
    parts = [evm._band_laplacian_levels(
        _float_frames(flat[i:i + step]).contiguous(), cfg)
        for i in range(0, s * t, step)]
    levels = tuple(
        torch.cat([p[i] for p in parts]).reshape(
            (s, t) + tuple(parts[0][i].shape[1:]))
        for i in _kept_levels(cfg))
    return StreamingState(levels=levels, count=torch.full(
        (s,), t, dtype=torch.int32, device=buffers.device))


def localize_batch(state: StreamingState, frame_hw: Tuple[int, int],
                   dtype, fps: float, cfg: CalibrationConfig,
                   coarse: bool) -> StreamingLocate:
    """The localize half of ``streaming_update`` for batched (S, T, h, w)
    rings: bandpass the rings, collapse (to full resolution, or with
    ``coarse`` to level ``skip_levels_at_top``), suppress-top, heatmap,
    threshold, CCL bbox, each stream on its own.  Every field gets a
    leading stream axis.

    Each level's bandpass is one operator product over all S rings, and
    the collapse one pyrUp chain over the (T*S) stack; the CCL (whose
    sweeps read the device) runs stream by stream.  The bandpass is the
    packed-rfft operator whatever ``cfg.temporal_filter`` says, as in the
    JAX package."""
    h0, w0 = frame_hw
    s = state.count.shape[0]
    t = cfg.buffer_length
    shapes = pyramid_shapes(h0, w0, cfg.pyramid_levels)
    # (T, S, h, w): time leads for the bandpass, and the collapse works
    # on the (T*S) frames as one stack.
    band = {lvl: temporal_bandpass_fft(
        ring.transpose(0, 1), fps, cfg.freq_min, cfg.freq_max,
        cfg.amplification).reshape((t * s,) + tuple(ring.shape[2:]))
        for ring, lvl in zip(state.levels, _kept_levels(cfg))}
    stop = cfg.skip_levels_at_top if coarse else 0
    like = torch.empty((), dtype=dtype, device=state.count.device)
    img = evm._collapse(band, shapes, t * s, like, stop)
    img = img.reshape((t, s) + tuple(img.shape[1:]))
    # Suppress-top (evm._suppress_top) per stream.
    lo = img.amin(dim=(0, 2, 3), keepdim=True)
    hi = img.amax(dim=(0, 2, 3), keepdim=True)
    top = hi - (hi - lo) * cfg.temporal_threshold
    avg = evm._tmean(torch.where(img >= top, lo, img))
    # The heatmap and threshold of evm._heat_and_box per stream.
    amin = avg.amin(dim=(1, 2), keepdim=True)
    amax = avg.amax(dim=(1, 2), keepdim=True)
    heat = float_to_uint8((avg - amin) / (amax - amin))
    fg = heat.to(torch.int32) > int(round(cfg.threshold * 255.0))
    boxes = [ccl.largest_component_bbox(fg[i]) for i in range(s)]
    bx, by, bw, bh, found = (torch.stack([getattr(b, f) for b in boxes])
                             for f in ("x", "y", "w", "h", "found"))
    if coarse:
        k = 1 << stop
        bx, by = bx * k, by * k
        bw = torch.minimum(bw * k, w0 - bx)
        bh = torch.minimum(bh * k, h0 - by)
    ready = state.count >= cfg.buffer_length
    return StreamingLocate(ready=ready, found=found & ready, x=bx, y=by,
                           w=bw, h=bh, heatmap_u8=heat)


def _localize_window(state: StreamingState, frame_hw: Tuple[int, int],
                     dtype, fps: float, cfg: CalibrationConfig,
                     coarse: bool) -> StreamingLocate:
    """The localize half of ``streaming_update``: ``localize_batch`` of
    one stream's (T, h, w) rings."""
    one = StreamingState(levels=tuple(lv[None] for lv in state.levels),
                         count=state.count[None])
    res = localize_batch(one, frame_hw, dtype, fps, cfg, coarse)
    return StreamingLocate(*(f[0] for f in res))


def streaming_update(state: StreamingState, frame, fps: float,
                     cfg: CalibrationConfig, coarse: bool = False) \
        -> Tuple[StreamingState, StreamingLocate]:
    """Absorb one frame and localize over the current window.

    ``ready`` is False until the rings hold ``buffer_length`` frames (the
    prototype waits for a full deque before filtering,
    locating.py:117-143).  ``coarse`` stops the collapse at level
    ``skip_levels_at_top``: the heatmap, threshold and CCL run at that
    level and the bbox scales back by ``2**skip`` (a re-lock drift
    detector's granularity; ``heatmap_u8`` is then the coarse one)."""
    frame = _float_frames(torch.as_tensor(frame).to(state.count.device))
    new_state = streaming_absorb(state, frame, cfg)
    return new_state, _localize_window(new_state, tuple(frame.shape),
                                       frame.dtype, fps, cfg, coarse)
