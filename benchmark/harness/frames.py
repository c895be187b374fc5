"""The one traffic generator: breathing subjects as uint8 gray frames, made
from the seed and a traffic file's parameters.

A subject is a Gaussian patch whose brightness and texture move with its
breath (the texture inside the patch shifts vertically by ``motion_frac``
of the frame height times the breath's phase, so corners move and LK has
a displacement to track) over a static textured background, plus noise
per frame: ``io/synthetic.breathing_clip``'s model with
``texture_motion=True`` (respmon_tpu_torch/io/synthetic.py:16-97), here
made on the device in whole-frame operations.  A rate of B BPM at F fps
gives a pool of P = 60 F / B frames, an exact period, so a stream replays
its pool cyclically and stays phase-continuous; the traffic's rates must
give whole periods.

Every draw comes from ``rng(seed, purpose)``: the same seed gives the same
frames, schedule and dither, in any process on the same kind of device.
A traffic file that names a ``content_seed`` draws its subjects, pools,
phases and rings from that instead (``content``), the same for every run
seed: the run seed then only orders the streams and draws the steps the
check compares, so that every seed gets the same work.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy generator of its own for each use of the seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def content(traffic: dict, seed: int) -> int:
    """The seed the traffic's content is drawn from."""
    return int(traffic.get("content_seed", seed))


def torch_generator(seed: int, purpose: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, purpose).integers(0, 2 ** 62)))
    return gen


def period_frames(bpm: float, fps: float) -> int:
    """Frames in one breath; the rate has to give a whole number."""
    p = 60.0 * fps / bpm
    if abs(p - round(p)) > 1e-9:
        raise ValueError(f"{bpm} BPM at {fps} fps is not a whole number of "
                         f"frames ({p})")
    return int(round(p))


class Subject(NamedTuple):
    bpm: float
    period: int
    center: tuple      # (cy, cx) in pixels


def subjects(traffic: dict, seed: int, frame_hw, fps: float) -> List[Subject]:
    """One subject per (rate, position): ``positions_per_rate`` centres a
    rate, drawn from the seed inside ``center_frac``."""
    h, w = frame_hw
    r = rng(content(traffic, seed), "positions")
    (y0, y1), (x0, x1) = traffic["center_frac"]
    out = []
    for bpm in traffic["rates_bpm"]:
        for _ in range(int(traffic["positions_per_rate"])):
            cy = int(round(h * r.uniform(y0, y1)))
            cx = int(round(w * r.uniform(x0, x1)))
            out.append(Subject(float(bpm), period_frames(bpm, fps), (cy, cx)))
    return out


def make_pool(subject: Subject, traffic: dict, frame_hw, gen: torch.Generator,
              device) -> torch.Tensor:
    """(P, H, W) uint8 frames of one breath of ``subject`` on ``device``."""
    h, w = frame_hw
    f32 = torch.float32
    yy = torch.arange(h, device=device, dtype=f32)[:, None]
    xx = torch.arange(w, device=device, dtype=f32)[None, :]
    bg = 0.45 + 0.1 * torch.sin(2 * math.pi * xx / 97.0) \
        * torch.cos(2 * math.pi * yy / 71.0)
    bg = bg + 0.05 * torch.randn((h, w), generator=gen, device=device)
    bg = bg.clamp(0.05, 0.95)
    ph = traffic["patch_frac"][0] * h
    pw = traffic["patch_frac"][1] * w
    cy, cx = subject.center
    env = torch.exp(-0.5 * ((yy - cy) / (ph / 2.0)) ** 2) \
        * torch.exp(-0.5 * ((xx - cx) / (pw / 2.0)) ** 2)
    motion_px = traffic["motion_frac"] * h
    out = torch.empty((subject.period, h, w), dtype=torch.uint8,
                      device=device)
    for i in range(subject.period):
        phase = math.sin(2 * math.pi * i / subject.period)
        shift = motion_px * phase
        i0 = math.floor(shift)
        f = shift - i0
        moving = (1.0 - f) * torch.roll(bg, i0, dims=0) \
            + f * torch.roll(bg, i0 + 1, dims=0)
        frame = bg + env * (moving - bg) + traffic["amplitude"] * phase * env
        frame = frame + traffic["noise"] * torch.randn(
            (h, w), generator=gen, device=device)
        # At most 250, so that a dither of a few levels cannot wrap.
        out[i] = (frame * 255.0).clamp(0.0, 250.0).to(torch.uint8)
    return out


def make_pools(subj: Sequence[Subject], traffic: dict, frame_hw, seed: int,
               device) -> List[torch.Tensor]:
    gen = torch_generator(content(traffic, seed), "pools", device)
    return [make_pool(s, traffic, frame_hw, gen, device) for s in subj]


def dither(seed: int, cycle: int, frame_hw, levels: int) -> np.ndarray:
    """A cycle's fixed (H, W) uint8 dither in [0, levels), so that no two
    cycles hand the monitor the same calibration buffer."""
    return rng(seed, f"dither:{cycle}").integers(
        0, levels, frame_hw, dtype=np.uint8)
