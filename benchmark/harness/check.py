"""Whether what the timed path produced is correct: the program's outputs
held against the plain reference (``benchmark/reference``), which works
them out again from the frames the benchmark handed in.

What a traffic's kind compares (``benchmark/kinds/<kind>.py``,
``readings``) is built from the readings here:

- ``box_px``: every checked calibration's box against the reference's
  ``locate`` of the same buffer (largest gap of x, y, w, h in pixels; a
  found/not-found disagreement counts 1e9), and ``heat_px``: the pixels of
  its uint8 heatmap that differ from the reference's (the most over the
  checked calibrations).
- ``start_sample_rel``: the start, checked by itself.  From the state the
  benchmark installed and the frames it handed in, the reference detects
  its own corners and tracks on its own state through all of set-up's
  measured steps (those that fill the signal rings among them); the
  largest gap of the samples, over the largest reference sample.
- ``sample_rel``: measured window steps drawn from the seed.  The
  reference follows the program step by step: from the program's state
  before the step (ROI, tracked points, motion ring) and the frames, one
  flow step; the largest sample gap over the largest reference sample of
  the stream.
- ``bpm_mismatch``: at the same steps, the reference's BPM estimate of the
  reference's own signal ring after the step (the program's ring before
  the step, pushed with the reference's sample at the next time) against
  the program's has-BPM and BPM (a mismatch: has-BPM differs, or the BPMs
  by more than 1e-3).
- ``ring_faults``: stream-steps, over every measured step of the run,
  whose signal ring after the step is not the ring before it pushed with
  the step's reported sample at the next time.
- ``state_faults``: window steps that did not end in measuring; for a
  fleet, stream-frames that flagged an error.

``readings(run, "control")`` puts the reference computed in TF32 in the
program's place: the control that has to come out as not correct.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import drive
from benchmark.harness import frames as gen
from benchmark.reference import system as ref

BIG = 1e9


def on_device(run, frames) -> torch.Tensor:
    return torch.as_tensor(np.asarray(frames)).to(run.device)


def flow_spec(run, box_w: int, box_h: int) -> ref.FlowSpec:
    c = run.ref_cfg
    h, w = run.frame_hw
    ch, cw = ref.crop_size(box_w, box_h, h, w, c.roi_bucket)
    return ref.FlowSpec(frame_h=h, frame_w=w, crop_h=ch, crop_w=cw,
                        buffer_length=c.measure.buffer_length,
                        features=c.features, lk=c.lk)


def rel(got: np.ndarray, want: np.ndarray, scale: np.ndarray) -> float:
    """Largest |got - want| over ``scale`` (per stream); NaN on both sides
    is equal, on one side a gap of 1e9."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    if (nan_g != nan_w).any():
        return BIG
    gap = np.where(nan_g, 0.0, np.abs(got - want))
    return float((gap / np.maximum(scale, 1e-12)).max(initial=0.0))


def _measure_cfg(run):
    """The estimate's config as the program runs it: a fleet skips the
    float64 refit unless ``fleet_f64_refine`` (parallel/streams.py)."""
    m = run.ref_cfg.measure
    if isinstance(run, drive.FleetRun) and not run.ref_cfg.fleet_f64_refine:
        m = dataclasses.replace(m, f64_refine=False)
    return m


def _measured(run, first: int = 0):
    return [i for i, r in enumerate(run.steps)
            if i >= first and r.before == "measure"]


def pick(run, candidates: List[int], n: int, purpose: str) -> List[int]:
    """``n`` of ``candidates`` drawn from the seed (all, where fewer)."""
    if len(candidates) <= n:
        return list(candidates)
    r = gen.rng(run.seed, purpose)
    return sorted(int(i) for i in r.choice(candidates, n, replace=False))


def _prev_measured(run, i: int) -> int:
    j = i - 1
    while j >= 0 and run.steps[j].before != "measure":
        j -= 1
    return j


def box_wh(run, i: int):
    """(w, h) the program sized the crop bucket from for step ``i``."""
    if isinstance(run, drive.FleetRun):
        return int(run.boxes[:, 2].max()), int(run.boxes[:, 3].max())
    j = i
    while run.steps[j].box is None:
        j -= 1
    return run.steps[j].box[3], run.steps[j].box[4]


def _sample_tensor(sample, like: torch.Tensor) -> torch.Tensor:
    """A step's reported (S,) samples as a tensor beside ``like``."""
    return torch.as_tensor(np.asarray(sample, np.float64).reshape(-1),
                           device=like.device).to(like.dtype)


# ---------------------------------------------------------------------------
# Readings
# ---------------------------------------------------------------------------

def calibration_readings(run, side: str) -> Dict[str, float]:
    """``box_px`` and ``heat_px`` (pixels of the uint8 heatmap that differ
    from the reference's, the most over the checked calibrations)."""
    box_px = heat_px = 0.0
    fps, cal = run.fps, run.ref_cfg.calibration
    for frames_u8, box, heat in run.calibrations():
        vid = on_device(run, frames_u8)
        want, want_heat = ref.locate(vid, fps, cal)
        if side == "program":
            got, got_heat = box, heat
        else:
            got, got_heat = ref.locate(vid, fps, cal, True)
        del vid
        heat_px = max(heat_px, float((got_heat.to(want_heat.device)
                                      != want_heat).sum()))
        if bool(got[0]) != bool(want[0]):
            box_px = BIG
            continue
        box_px = max(box_px, max(abs(int(a) - int(b))
                                 for a, b in zip(got[1:], want[1:])))
    return {"box_px": float(box_px), "heat_px": heat_px}


def _start_steps(run) -> List[int]:
    """The set-up's measured steps from the first one after the first
    calibration: the start."""
    m = _measured(run)
    first, end = m[0], run.window[0]
    out = [first]
    for i in m[1:]:
        if i >= end or i != out[-1] + 1:
            break
        out.append(i)
    return out


def start_readings(run, side: str) -> float:
    """The reference's own run from the installed state through the
    set-up's measured steps, against the program's samples (or the
    control's own run)."""
    steps = _start_steps(run)
    i0 = steps[0]
    s0 = run.steps[i0].s0
    spec = flow_spec(run, *box_wh(run, i0))
    sides = {"ref": s0, "ctl": s0}
    got_all, want_all = [], []
    prev = None
    for i in steps:
        fr = on_device(run, run.frames_of(i))
        out = ref.flow_step(prev, fr, sides["ref"], spec)
        sides["ref"] = out.state
        want_all.append(ref.as_numpy(out.sample))
        if side == "program":
            got_all.append(np.asarray(run.steps[i].sample,
                                      np.float64).reshape(-1))
        else:
            c = ref.flow_step(prev, fr, sides["ctl"], spec, tf32=True)
            sides["ctl"] = c.state
            got_all.append(ref.as_numpy(c.sample))
        prev = fr
    want, got = np.stack(want_all), np.stack(got_all)
    scale = np.nanmax(np.abs(want), axis=0)
    return rel(got, want, scale[None, :])


def _estimate(run, rec, sample: torch.Tensor, mcfg, tf32: bool):
    """(has_bpm, bpm) of the reference's estimate of step ``rec``'s ring:
    the program's ring before the step pushed with ``sample`` at the next
    time.  A fleet reports a BPM only past ``initialization_length``
    samples (parallel/streams.py)."""
    data, t, count = ref.push_ring(*rec.r0, sample, run.fps,
                                   mcfg.buffer_length)
    has, bpm = (ref.as_numpy(x) for x in ref.estimate(
        data, t, count, run.fps, run.ref_cfg.calibration, mcfg, tf32=tf32))
    if isinstance(run, drive.FleetRun):
        has = has & (ref.as_numpy(count) > mcfg.initialization_length)
    return has, bpm


def step_readings(run, side: str, n: int) -> Dict[str, float]:
    """Measured window steps drawn from the seed: the sample from the
    program's state before the step, and the BPM of the reference's ring
    after it (the program's ring before, pushed with the reference's
    sample)."""
    first = run.window[0]
    cands = [i for i in _measured(run, first)
             if run.steps[i].s0 is not None
             and bool(ref.as_numpy(run.steps[i].s0.initialized).all())
             and _prev_measured(run, i) >= 0]
    picked = pick(run, cands, n, "steps")
    got_s, want_s, mismatch = [], [], 0
    mcfg = _measure_cfg(run)
    tf32 = side != "program"
    for i in picked:
        rec = run.steps[i]
        spec = flow_spec(run, *box_wh(run, i))
        prev = on_device(run, run.frames_of(_prev_measured(run, i)))
        fr = on_device(run, run.frames_of(i))
        want = ref.flow_step(prev, fr, rec.s0, spec).sample
        got = ref.flow_step(prev, fr, rec.s0, spec, tf32=True).sample \
            if tf32 else None
        got_s.append(ref.as_numpy(got) if tf32 else
                     np.asarray(rec.sample, np.float64).reshape(-1))
        want_s.append(ref.as_numpy(want))
        if rec.bpm is None:
            continue
        has_w, bpm_w = _estimate(run, rec, want, mcfg, False)
        if tf32:
            has_g, bpm_g = _estimate(run, rec, got, mcfg, True)
        else:
            has_g = np.asarray(rec.bpm[0]).reshape(-1)
            bpm_g = np.asarray(rec.bpm[1], np.float64).reshape(-1)
        bad = (has_g != has_w) | (has_w & (np.abs(
            np.where(has_w, bpm_g - bpm_w, 0.0)) > 1e-3))
        mismatch += int(bad.sum())
    if not picked:
        return {"sample_rel": BIG, "bpm_mismatch": float(mismatch)}
    want, got = np.stack(want_s), np.stack(got_s)
    scale = np.nanmax(np.abs(want), axis=0)
    return {"sample_rel": rel(got, want, scale[None, :]),
            "bpm_mismatch": float(mismatch)}


def _differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(S,) rows of ``a`` and ``b`` that are not bit for bit equal (NaN
    equal to NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
        if a.is_floating_point() else a == b
    return ~same.reshape(a.shape[0], -1).all(dim=1)


def ring_faults(run) -> float:
    """Stream-steps, over every measured step of the run (set-up's and the
    window's), whose signal ring after the step (data, t, count) is not
    the ring before it pushed with the step's reported sample at the next
    time (``reference.system.push_ring``)."""
    n_ring = run.cfg.measure.buffer_length
    bad = None
    for rec in run.steps:
        if rec.r0 is None:
            continue
        data0, t0, c0 = rec.r0
        want = ref.push_ring(data0, t0, c0, _sample_tensor(rec.sample, data0),
                             run.fps, n_ring)
        rows = torch.zeros(data0.shape[0], dtype=torch.bool,
                           device=data0.device)
        for got_x, want_x in zip(rec.s1, want):
            rows |= _differs(got_x.reshape(data0.shape[0], -1),
                             want_x.reshape(data0.shape[0], -1))
        bad = rows.sum() if bad is None else bad + rows.sum()
    return 0.0 if bad is None else float(bad)


def state_faults(run) -> float:
    window = run.steps[run.window[0]:]
    if run.overrun:
        return BIG
    if isinstance(run, drive.FleetRun):
        return float(sum(int(np.asarray(r.error).sum()) for r in window))
    return float(sum(1 for r in window if r.after != "measure"))


def readings(run, side: str = "program", checks: dict = None) -> dict:
    """Every compared number of the run's cell, as its traffic's kind
    compares them: the program's outputs (``side="program"``) or the
    control's (``"control"``) against the reference.  ``checks`` gives how
    many calibrations and steps to draw."""
    if side not in ("program", "control"):
        raise ValueError(side)
    return run.kind.readings(run, side, checks or {})


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or NaN, fails."""
    rows, ok = [], True
    for name, value in values.items():
        limit = limits.get(name)
        good = limit is not None and not math.isnan(value) \
            and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    for name in limits:
        if name not in values:
            ok = False
            rows.append((name, float("nan"), limits[name]))
    return ok, rows
