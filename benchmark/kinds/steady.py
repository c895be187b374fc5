"""Steady traffic: every stream shows one subject breathing at a constant
rate, replayed cyclically from a pool of one breath (an exact period), in
a closed loop: the next frame goes in when ``step()`` returns.

Set-up calibrates, fills the signal rings with measured steps (the
estimate skipped: ``drive.no_estimate``) and runs ``warm_estimates`` steps
with the estimate, so that the window opens on full rings: every window
step estimates over a full ring, as a deployment's does.  A unit of the
window's work is one step.

Parameters: ``rates_bpm``, ``positions_per_rate``, ``patch_frac``,
``center_frac``, ``amplitude``, ``motion_frac``, ``noise`` (the subjects,
``harness/frames.py``); ``content_seed`` (where given, the subjects,
pools and phases are the same for every run seed, which then only orders
the streams and draws the checked steps); ``warm_estimates``;
``trace_units``; ``checks``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import check, drive, timing
from benchmark.harness import frames as gen

SYSTEMS = ("monitor", "fleet")


class CyclicSource:
    """A camera replaying one breath's frames from host memory, cyclically
    from ``start``; ``last_id`` is the serial number of the last frame."""

    def __init__(self, pool: np.ndarray, start: int, fps: float):
        self.pool = pool
        self.start = int(start)
        self.fps = float(fps)
        self.height, self.width = pool.shape[1:]
        self.frame_dtype = pool.dtype
        self.served = 0
        self.last_id = None
        self.monitor = None

    def frame_of(self, i: int) -> np.ndarray:
        return self.pool[(self.start + i) % len(self.pool)]

    def next_frame(self):
        self.last_id = self.served
        self.served += 1
        return self.frame_of(self.last_id)

    def is_open(self) -> bool:
        return True

    def release(self) -> None:
        pass


class FleetFrames:
    """The fleet's frames: stream ``s`` shows subject ``clip_of[s]`` from
    pool index ``phase0[s]`` on, one frame a tick.  The pools of all
    subjects sit in one pinned host tensor, and a tick's (S, H, W) batch is
    gathered from it."""

    def __init__(self, run):
        tr, s = run.traffic, run.streams
        subj = gen.subjects(tr, run.seed, run.frame_hw, run.fps)
        pools = gen.make_pools(subj, tr, run.frame_hw, run.seed, run.device)
        sizes = [p.shape[0] for p in pools]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.periods = np.asarray(sizes)
        # The streams' subjects and phases come from the content; the run
        # seed puts them in its own order.
        rc = gen.rng(gen.content(tr, run.seed), "streams")
        clip_of = np.arange(s) % len(subj)
        phase0 = np.asarray([rc.integers(0, sizes[k]) for k in clip_of])
        order = gen.rng(run.seed, "order").permutation(s)
        self.clip_of, self.phase0 = clip_of[order], phase0[order]
        pool_all = torch.cat(pools)
        pinned = run.device.type == "cuda"
        self.pool_host = torch.empty(pool_all.shape, dtype=torch.uint8,
                                     pin_memory=pinned)
        self.pool_host.copy_(pool_all)

    def index(self, k: int) -> np.ndarray:
        sub = self.clip_of
        return self.offsets[sub] + (self.phase0 + k) % self.periods[sub]

    def fill(self, k: int, out: torch.Tensor) -> None:
        """Gather tick ``k``'s frames into the host batch ``out``."""
        torch.index_select(self.pool_host, 0,
                           torch.from_numpy(self.index(k)), out=out)

    def frames(self, k: int) -> torch.Tensor:
        """The (S, H, W) uint8 frames of tick ``k`` (host)."""
        return self.pool_host.index_select(
            0, torch.from_numpy(self.index(k)))

    def clips(self, t_len: int):
        """Each subject's first ``t_len`` frames (host), the buffers that
        set-up calibrates."""
        out = []
        for k in range(len(self.periods)):
            idx = self.offsets[k] + np.arange(t_len) % self.periods[k]
            out.append(self.pool_host[torch.from_numpy(idx)])
        return out


def source(run):
    if run.system == "fleet":
        return FleetFrames(run)
    tr = run.traffic
    subj = gen.subjects(tr, run.seed, run.frame_hw, run.fps)
    pool = gen.make_pools(subj, tr, run.frame_hw, run.seed,
                          run.device)[0].cpu().numpy()
    start = int(gen.rng(gen.content(tr, run.seed), "phase")
                .integers(0, subj[0].period))
    return CyclicSource(pool, start, run.fps)


def warm(run) -> None:
    n = run.cfg.measure.buffer_length
    with drive.no_estimate():
        while run.ring_length() < n:
            run.setup_step()
    for _ in range(int(run.traffic["warm_estimates"])):
        run.setup_step()


def unit_ends(run) -> bool:
    return True


def after_step(run) -> None:
    pass


def end_to_end(run):
    """``frame_ms_p95`` over every window step, ``stream_frames_per_s``
    over the window's seconds."""
    first, t_open, t_close = run.window
    steps = run.steps[first:]
    done = run.streams * len(steps)
    values = {"frame_ms_p95": timing.p95([(s.t1 - s.t0) * 1e3
                                          for s in steps]),
              "stream_frames_per_s": done / (t_close - t_open)}
    return values, done, int(check.state_faults(run))


def readings(run, side: str, checks: dict) -> dict:
    out = check.calibration_readings(run, side)
    out["start_sample_rel"] = check.start_readings(run, side)
    out.update(check.step_readings(run, side, checks.get("steps", 8)))
    program = side == "program"
    out["ring_faults"] = check.ring_faults(run) if program else 0.0
    out["state_faults"] = check.state_faults(run) if program else 0.0
    return out
