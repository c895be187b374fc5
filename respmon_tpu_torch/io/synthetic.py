# Copied from respmon_tpu/io/synthetic.py:1-107 (numpy only).
"""Synthetic known-BPM breathing video generator.

The reference has no test fixtures (SURVEY.md §4); its de-facto validation
was replaying recorded clips.  For provable parity we generate videos with a
known ground-truth breathing rate: a localized patch whose intensity (and,
for flow testing, position) oscillates sinusoidally at ``bpm/60`` Hz over a
static textured background plus optional noise.
"""

from __future__ import annotations

import numpy as np


def breathing_clip(num_frames: int = 128, height: int = 480, width: int = 640,
                   fps: float = 10.0, bpm: float = 18.0,
                   patch_center=None, patch_size=(80, 100),
                   amplitude: float = 0.1, motion_px: float = 0.0,
                   drift_px=(0.0, 0.0), noise: float = 0.005, seed: int = 0,
                   texture_motion: bool = False,
                   dtype=np.float32) -> np.ndarray:
    """(T, H, W) float frames in [0, 1] with a breathing patch.

    amplitude: peak intensity modulation of the patch.
    motion_px: if > 0, the patch also translates vertically by this many
      pixels (for optical-flow-mode testing).
    drift_px: (dy, dx) total linear translation of the patch CENTER over
      the clip (a moving subject, for the streaming-calibrator tests).
    texture_motion: when True (and motion_px > 0), the background TEXTURE
      inside the patch envelope translates vertically by ``motion_px *
      phase`` (linear resampling) instead of the envelope itself moving —
      corners physically move with breathing, giving optical flow a
      genuine, non-decaying displacement signal (a chest with fabric
      texture, rather than a brightness bump gliding over static texture).
      Envelope translation only produces *apparent* motion: LK points
      latch onto the static texture, the extracted signal is ~20x diluted,
      and it decays as points drift — fine for short parity tests, too
      weak for long realistic clips (the flagship bench uses this mode).
    """
    rng = np.random.default_rng(seed)
    if patch_center is None:
        patch_center = (height // 2, width // 2)
    cy, cx = patch_center
    ph, pw = patch_size
    dy_total, dx_total = drift_px

    yy, xx = np.mgrid[0:height, 0:width]
    background = 0.45 + 0.1 * np.sin(2 * np.pi * xx / 97.0) \
        * np.cos(2 * np.pi * yy / 71.0)
    # Static texture so corners/flow have something to latch onto.
    background = background + 0.05 * rng.standard_normal((height, width))
    background = np.clip(background, 0.05, 0.95)

    t = np.arange(num_frames) / fps
    phase = np.sin(2 * np.pi * (bpm / 60.0) * t)

    frames = np.empty((num_frames, height, width), dtype=np.float64)
    env_y = np.exp(-0.5 * ((yy - cy) / (ph / 2.0)) ** 2)
    env_x = np.exp(-0.5 * ((xx - cx) / (pw / 2.0)) ** 2)
    envelope = env_y * env_x
    denom = max(num_frames - 1, 1)
    for i in range(num_frames):
        fy = cy + dy_total * i / denom
        fx = cx + dx_total * i / denom
        shift = motion_px * phase[i]
        if texture_motion and motion_px:
            env = env_y if fy == cy else \
                np.exp(-0.5 * ((yy - fy) / (ph / 2.0)) ** 2)
            env = env * (env_x if fx == cx else
                         np.exp(-0.5 * ((xx - fx) / (pw / 2.0)) ** 2))
            # moving(y) = background(y - shift), linear resampling.
            i0 = int(np.floor(shift))
            f = shift - i0
            moving = (1.0 - f) * np.roll(background, i0, axis=0) \
                + f * np.roll(background, i0 + 1, axis=0)
            frame = background + env * (moving - background) \
                + amplitude * phase[i] * env
            if noise:
                frame = frame + noise * rng.standard_normal((height, width))
            frames[i] = frame
            continue
        if shift or fy != cy:
            env = np.exp(-0.5 * ((yy - fy - shift) / (ph / 2.0)) ** 2)
            env = env * (env_x if fx == cx else
                         np.exp(-0.5 * ((xx - fx) / (pw / 2.0)) ** 2))
        elif fx != cx:
            env = env_y * np.exp(-0.5 * ((xx - fx) / (pw / 2.0)) ** 2)
        else:
            env = envelope
        frame = background + amplitude * phase[i] * env
        if noise:
            frame = frame + noise * rng.standard_normal((height, width))
        frames[i] = frame
    # Quantize through uint8 like a real camera (reference pipeline ingests
    # uint8 frames converted by uint8_to_float, base.py:227-233).
    u8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    return (u8.astype(dtype) / 255.0)


def motion_trace(num_samples: int = 128, fps: float = 10.0, bpm: float = 18.0,
                 noise: float = 0.02, seed: int = 0):
    """1-D synthetic motion signal + time axis (for DSP-stage tests)."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples) / fps
    y = np.sin(2 * np.pi * (bpm / 60.0) * t) + noise * \
        rng.standard_normal(num_samples)
    return t, y
