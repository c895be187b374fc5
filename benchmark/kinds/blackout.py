"""Blackout traffic: a camera whose subject keeps vanishing.  Good frames
of one subject while the monitor calibrates, black ones from its first
measured frame until it is in ``error``; then a new cycle, the subject at
one of the traffic's positions with a dither of its own, so that no
calibration sees a buffer an earlier one saw.  A unit of the window's work
is one cycle, and its end-to-end value is ``recover_ms_p95``.

Parameters: the subjects' (``harness/frames.py``), ``dither_levels``,
``warm_cycles``, ``trace_units``, ``checks``.  Drives a single monitor.
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.harness import check, timing
from benchmark.harness import frames as gen
from benchmark.reference import system as ref

SYSTEMS = ("monitor",)


class BlackoutSource:
    """Good frames of one subject while the monitor calibrates, black ones
    while it measures.  A cycle starts at the step that leaves ``error``;
    its subject, phase and dither come from the seed, and its frames are
    made by ``prepare`` before the cycle begins (between steps, outside
    every timed span).  Frame ids are ``(cycle, j)`` or ``("black",
    cycle)``."""

    def __init__(self, pools: List[np.ndarray], seed: int, fps: float,
                 dither_levels: int, frames_per_cycle: int):
        self.pools = pools
        self.seed = int(seed)
        self.fps = float(fps)
        self.height, self.width = pools[0].shape[1:]
        self.frame_dtype = np.dtype(np.uint8)
        self.levels = int(dither_levels)
        self.n = int(frames_per_cycle)
        r = gen.rng(seed, "cycles")
        self._pos = r.integers(0, len(pools), 1 << 16)
        self._phase = r.integers(0, 1 << 30, 1 << 16)
        self.black = np.zeros(pools[0].shape[1:], np.uint8)
        self.monitor = None
        self.cycle = 0
        self.j = 0
        self.last_id = None
        self._buf = np.empty((self.n,) + pools[0].shape[1:], np.uint8)
        self._ready = None
        self.prepare(0)
        self._take_prepared()

    def recipe(self, cycle: int):
        """(subject, first pool index, dither) of a cycle."""
        pos = int(self._pos[cycle % len(self._pos)])
        return pos, int(self._phase[cycle % len(self._phase)]), \
            gen.dither(self.seed, cycle, self.pools[pos].shape[1:],
                       self.levels)

    def frame(self, cycle: int, j: int) -> np.ndarray:
        pos, phase, dith = self.recipe(cycle)
        pool = self.pools[pos]
        return pool[(phase + j) % len(pool)] + dith

    def frame_of(self, frame_id) -> np.ndarray:
        if frame_id[0] == "black":
            return self.black
        return self.frame(*frame_id)

    def prepare(self, cycle: int) -> None:
        if self._ready == cycle:
            return
        pos, phase, dith = self.recipe(cycle)
        pool = self.pools[pos]
        idx = (phase + np.arange(self.n)) % len(pool)
        np.add(pool[idx], dith, out=self._buf)
        self._ready = cycle

    def _take_prepared(self):
        self.cycle, self.j = self._ready, 0
        self.frames = self._buf

    def next_frame(self):
        state = self.monitor.state if self.monitor is not None \
            else "initialize"
        if state == "measure":
            self.last_id = ("black", self.cycle)
            return self.black
        if state == "error":
            if self._ready != self.cycle + 1:
                self.prepare(self.cycle + 1)
            self._take_prepared()
        j = self.j
        self.j += 1
        self.last_id = (self.cycle, j)
        return self.frames[j] if j < self.n else self.frame(self.cycle, j)

    def is_open(self) -> bool:
        return True

    def release(self) -> None:
        pass


def source(run) -> BlackoutSource:
    tr = run.traffic
    subj = gen.subjects(tr, run.seed, run.frame_hw, run.fps)
    pools = [p.cpu().numpy() for p in
             gen.make_pools(subj, tr, run.frame_hw, run.seed, run.device)]
    return BlackoutSource(pools, run.seed, run.fps, tr["dither_levels"],
                          run.cfg.calibration.buffer_length + 2)


def cycles_done(run) -> int:
    return sum(1 for s in run.steps
               if s.before == "measure" and s.after == "error")


def warm(run) -> None:
    while cycles_done(run) < int(run.traffic["warm_cycles"]):
        run.setup_step()


def unit_ends(run) -> bool:
    last = run.steps[-1]
    return last.before == "measure" and last.after == "error"


def after_step(run) -> None:
    """A cycle's frames are made once the monitor is in error."""
    if run.mon.state == "error":
        run.src.prepare(run.src.cycle + 1)


def recoveries(run, first: int):
    """(start, end) of each recovery that starts at or after step
    ``first``: from the step that leaves ``error`` to the end of the first
    measured step after it."""
    out, start = [], None
    for rec in run.steps[first:]:
        if rec.before == "error" and rec.after != "error":
            start = rec.t0
        elif rec.before == "measure" and start is not None:
            out.append((start, rec.t1))
            start = None
    return out


def cycles(run, first: int):
    """Window cycles: lists of step indices from a step that leaves
    ``error`` to the measured step that ends the cycle."""
    out, cur = [], None
    for i in range(first, len(run.steps)):
        rec = run.steps[i]
        if rec.before == "error":
            cur = [i]
            continue
        if cur is not None:
            cur.append(i)
            if rec.before == "measure":
                out.append(cur)
                cur = None
    return out


def sequence_faults(run) -> float:
    """Window cycles whose states did not run error -> calibration ->
    measure -> error with one located box, and a last cycle that never
    ended."""
    faults = int(run.overrun)
    for cyc in cycles(run, run.window[0]):
        states = [run.steps[cyc[0]].before] + [run.steps[i].after
                                               for i in cyc]
        seq = [s for k, s in enumerate(states) if k == 0
               or s != states[k - 1]]
        relocated = sum(1 for i in cyc if run.steps[i].box is not None)
        if seq != ["error", "calibration", "measure", "error"] \
                or relocated != 1:
            faults += 1
    return float(faults)


def black_readings(run, side: str, n: int) -> float:
    """The first measured step of ``n`` window cycles drawn from the seed
    (a black frame): its error flag and sample against the reference's."""
    cyc = cycles(run, run.window[0])
    picked = check.pick(run, list(range(len(cyc))), n, "black")
    bad = 0
    for c in picked:
        i = cyc[c][-1]
        rec = run.steps[i]
        spec = check.flow_spec(run, *check.box_wh(run, i))
        fr = check.on_device(run, run.frames_of(i))
        want = ref.flow_step(None, fr, rec.s0, spec)
        if side == "program":
            got_s = np.asarray(rec.sample, np.float64).reshape(-1)
            got_e = ref.as_numpy(rec.error).reshape(-1)
        else:
            c_out = ref.flow_step(None, fr, rec.s0, spec, tf32=True)
            got_s, got_e = ref.as_numpy(c_out.sample), \
                ref.as_numpy(c_out.error)
        if check.rel(got_s, ref.as_numpy(want.sample), np.ones(1)) > 0 \
                or (got_e != ref.as_numpy(want.error)).any():
            bad += 1
    return float(bad)


def end_to_end(run):
    rec = recoveries(run, run.window[0])
    value = timing.p95([(b - a) * 1e3 for a, b in rec]) if rec \
        else float("nan")
    return {"recover_ms_p95": value}, len(rec), int(sequence_faults(run))


def readings(run, side: str, checks: dict) -> dict:
    out = check.calibration_readings(run, side)
    out["black_mismatch"] = black_readings(run, side, checks.get("steps", 12))
    program = side == "program"
    out["ring_faults"] = check.ring_faults(run) if program else 0.0
    out["sequence_faults"] = sequence_faults(run) if program else 0.0
    return out
