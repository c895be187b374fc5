"""Drift traffic: a fleet whose subjects shift, driven through the fleet's
streaming-ROI mode (``MultiStreamMonitor`` with ``streaming_roi``).

The subjects are the steady kind's (``harness/frames.py``: a Gaussian
patch whose brightness and texture move with its breath, over a static
textured background, plus noise; one pool of one breath a subject).  Each
stands still through its camera's calibration buffer (ticks
``-buffer_length`` to -1).  From tick 0 its patch and texture move over
the static background along a triangle path: peak (dy, dx) =
``drift_peak_px``, ``drift_half_period`` frames from one peak to the
other, whole pixels.  Each stream's signs and the tick its path starts at
(its phase, in ``[0, drift_half_period)``) come from the content; the run
seed orders the streams and draws what the check compares.  A tick's
frames are made on the card from the subjects' layers and copied into the
harness's pinned host batch, and the same generator makes any tick's
frames again for the check.

Set-up runs the fleet's own ``calibrate`` over every stream's buffer (the
streams' (S, T, H, W) uint8 buffers made on the card: ``locate_streams``
and the rings' chunked warm start), so that the rings and the host's ROI
mirror are the program's own; then the ring fill under
``drive.no_estimate``, ``warm_estimates`` steps with the estimate, and the
steps to the end of that localize interval.  A unit of the window's work
is one localize interval: ``streaming_interval`` steps ending in the step
that localized.

The localizes are recorded by wrapping ``parallel.streams.update_streams``
(as ``drive.MonitorRun._watch_locate`` wraps ``evm.locate``): the tick,
the ROIs before it, the program's ``StreamingLocate``, and after the step
the ROIs the re-lock left.

Parameters: the subjects' (as the steady kind's), ``drift_peak_px``,
``drift_half_period``, ``content_seed``, ``warm_estimates``,
``trace_units``, ``checks`` (``calibrations``, ``steps``,
``relocked_steps``, ``localizes``, ``localize_streams``).  Drives a fleet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import torch

from benchmark.harness import check, drive
from benchmark.harness import frames as gen
from benchmark.reference import streaming as ref_streaming
from benchmark.reference import system as ref

SYSTEMS = ("fleet",)


def triangle(u: np.ndarray, half_period: int) -> np.ndarray:
    """A triangle wave in [-1, 1], 0 at ``u = 0`` and rising, going from
    one peak to the other in ``half_period`` frames."""
    v = np.mod(u, 2 * half_period) / half_period
    return np.where(v < 0.5, 2.0 * v, np.where(v < 1.5, 2.0 - 2.0 * v,
                                               2.0 * v - 4.0))


def subject_layers(subject: gen.Subject, traffic: dict, frame_hw,
                   generator: torch.Generator, device):
    """The layers of one subject, ``harness/frames.make_pool``'s model
    taken apart so that the patch can move: the background ``bg`` and the
    patch's envelope ``env`` (H, W), and for each frame of its breath the
    patch's layer ``env * texture + amplitude * phase * env`` and the
    frame's noise (P, H, W).  At offset 0 a frame is ``bg * (1 - env) +
    layer + noise``, the steady kind's frame."""
    h, w = frame_hw
    f32 = torch.float32
    yy = torch.arange(h, device=device, dtype=f32)[:, None]
    xx = torch.arange(w, device=device, dtype=f32)[None, :]
    bg = 0.45 + 0.1 * torch.sin(2 * math.pi * xx / 97.0) \
        * torch.cos(2 * math.pi * yy / 71.0)
    bg = bg + 0.05 * torch.randn((h, w), generator=generator, device=device)
    bg = bg.clamp(0.05, 0.95)
    ph = traffic["patch_frac"][0] * h
    pw = traffic["patch_frac"][1] * w
    cy, cx = subject.center
    env = torch.exp(-0.5 * ((yy - cy) / (ph / 2.0)) ** 2) \
        * torch.exp(-0.5 * ((xx - cx) / (pw / 2.0)) ** 2)
    motion_px = traffic["motion_frac"] * h
    layer = torch.empty((subject.period, h, w), dtype=f32, device=device)
    noise = torch.empty((subject.period, h, w), dtype=f32, device=device)
    for i in range(subject.period):
        phase = math.sin(2 * math.pi * i / subject.period)
        shift = motion_px * phase
        i0 = math.floor(shift)
        f = shift - i0
        texture = (1.0 - f) * torch.roll(bg, i0, dims=0) \
            + f * torch.roll(bg, i0 + 1, dims=0)
        layer[i] = env * texture + traffic["amplitude"] * phase * env
        noise[i] = traffic["noise"] * torch.randn(
            (h, w), generator=generator, device=device)
    return bg, env, layer, noise


class DriftFrames:
    """The fleet's frames: stream ``s`` shows subject ``clip_of[s]`` from
    breath frame ``phase0[s]`` on, one frame a tick, its patch at the
    tick's offset on the drift path.  Frames are made on the run's device
    from the subjects' layers."""

    def __init__(self, run):
        tr, s = run.traffic, run.streams
        dev = run.device
        self.frame_hw = run.frame_hw
        self.device = dev
        content = gen.content(tr, run.seed)
        subj = gen.subjects(tr, run.seed, run.frame_hw, run.fps)
        torch_gen = gen.torch_generator(content, "pools", dev)
        parts = [subject_layers(x, tr, run.frame_hw, torch_gen, dev)
                 for x in subj]
        self.bg = torch.stack([p[0] for p in parts])
        self.env = torch.stack([p[1] for p in parts])
        self.layer = torch.cat([p[2] for p in parts])
        self.noise = torch.cat([p[3] for p in parts])
        del parts
        sizes = np.asarray([x.period for x in subj])
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.periods = sizes
        # The streams' subjects, phases, drift signs and starts come from
        # the content; the run seed puts them in its own order.
        rc = gen.rng(content, "streams")
        clip_of = np.arange(s) % len(subj)
        phase0 = np.asarray([rc.integers(0, sizes[k]) for k in clip_of])
        rd = gen.rng(content, "drift")
        self.half_period = int(tr["drift_half_period"])
        signs = rd.choice(np.asarray([-1, 1]), size=(s, 2))
        start = rd.integers(0, self.half_period, s)
        order = gen.rng(run.seed, "order").permutation(s)
        self.clip_of, self.phase0 = clip_of[order], phase0[order]
        self.signs, self.start = signs[order], start[order]
        self.peak = np.asarray(tr["drift_peak_px"], np.float64)

    def offset(self, streams: np.ndarray, ticks: np.ndarray):
        """Whole-pixel (dy, dx) of each stream's patch at each tick: 0
        before the stream's path starts (its calibration buffer among
        those ticks)."""
        u = ticks - self.start[streams]
        tri = np.where(u >= 0, triangle(np.maximum(u, 0), self.half_period),
                       0.0)
        d = np.rint(self.peak[None, :] * self.signs[streams] * tri[:, None])
        return d[:, 0].astype(np.int64), d[:, 1].astype(np.int64)

    def render(self, subj, pool_idx, dy, dx) -> torch.Tensor:
        """(N, H, W) uint8 frames on the device: subject ``subj[n]``'s
        breath frame ``pool_idx[n]`` (an index into the stacked layers)
        with its patch moved by (``dy[n]``, ``dx[n]``)."""
        h, w = self.frame_hw
        dev = self.device

        def lt(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.long,
                                   device=dev)
        subj, pool_idx, dy, dx = lt(subj), lt(pool_idx), lt(dy), lt(dx)
        ys = torch.remainder(torch.arange(h, device=dev)[None, :]
                             - dy[:, None], h)[:, :, None]
        xs = torch.remainder(torch.arange(w, device=dev)[None, :]
                             - dx[:, None], w)[:, None, :]
        out = self.env[subj[:, None, None], ys, xs]
        out.neg_().add_(1.0).mul_(self.bg[subj])
        out.add_(self.layer[pool_idx[:, None, None], ys, xs])
        out.add_(self.noise[pool_idx])
        # At most 250, as the steady kind's frames.
        return out.mul_(255.0).clamp_(0.0, 250.0).to(torch.uint8)

    def make(self, streams, ticks) -> torch.Tensor:
        """(N, H, W) uint8 frames on the device of stream ``streams[n]``
        at tick ``ticks[n]`` (ticks before 0 are the calibration
        buffer's)."""
        streams = np.asarray(streams, np.int64)
        ticks = np.asarray(ticks, np.int64)
        sub = self.clip_of[streams]
        pool_idx = self.offsets[sub] + np.mod(self.phase0[streams] + ticks,
                                              self.periods[sub])
        dy, dx = self.offset(streams, ticks)
        return self.render(sub, pool_idx, dy, dx)

    def device_frames(self, k: int) -> torch.Tensor:
        """The (S, H, W) uint8 frames of tick ``k`` on the device."""
        s = len(self.clip_of)
        return self.make(np.arange(s), np.full(s, k))

    def fill(self, k: int, out: torch.Tensor) -> None:
        """Tick ``k``'s frames into the host batch ``out``."""
        out.copy_(self.device_frames(k))

    def history(self, s: int, k: int, t_len: int) -> torch.Tensor:
        """Stream ``s``'s (T, H, W) uint8 frames of ticks ``k - t_len + 1``
        to ``k`` on the device."""
        return self.make(np.full(t_len, s), np.arange(k - t_len + 1, k + 1))

    def clips(self, t_len: int):
        """Each subject standing still through its first ``t_len`` breath
        frames (the fleet set-up's per-subject clips), one at a time."""
        for k in range(len(self.periods)):
            idx = self.offsets[k] + np.arange(t_len) % self.periods[k]
            zero = np.zeros(t_len, np.int64)
            yield self.render(np.full(t_len, k), idx, zero, zero)


@dataclasses.dataclass
class Localize:
    """One localize of the fleet: the step it ran in, the ROIs before it,
    the program's ``StreamingLocate`` and the ROIs after the step."""

    tick: int
    roi0: torch.Tensor
    loc: Any
    roi1: Optional[torch.Tensor] = None

    def boxes(self) -> np.ndarray:
        """(5, S) found, x, y, w, h."""
        loc = self.loc
        return torch.stack([loc.found.to(torch.int64), loc.x.to(torch.int64),
                            loc.y.to(torch.int64), loc.w.to(torch.int64),
                            loc.h.to(torch.int64)]).cpu().numpy()

    def relocked(self) -> bool:
        return self.roi1 is not None and not torch.equal(self.roi0,
                                                         self.roi1)


def source(run) -> DriftFrames:
    return DriftFrames(run)


def _record_localizes(run) -> None:
    """Wrap ``parallel.streams.update_streams`` so that each localize of
    the fleet is kept in ``run.localizes``."""
    from respmon_tpu_torch.parallel import streams as fleet

    real = fleet.update_streams
    run.localizes = []

    def watched(sstate, frames, fps, cfg, coarse=True):
        rings, loc = real(sstate, frames, fps, cfg, coarse)
        run.localizes.append(Localize(tick=run.k, roi0=run.mon.states.roi,
                                      loc=loc))
        return rings, loc
    fleet.update_streams = watched

    def unpatch():
        fleet.update_streams = real
    run._unpatch = unpatch


def _calibrate(run) -> None:
    """The fleet's own ``calibrate`` over every stream's buffer, made on
    the card; the heatmaps of the streams the check compares are kept
    (``locate_streams`` runs one ``evm.locate`` a stream, in order)."""
    from respmon_tpu_torch.pipeline import evm

    src, t_len = run.src, run.cfg.calibration.buffer_length
    s = run.streams
    n = int(run.traffic.get("checks", {}).get("calibrations", 12))
    keep = check.pick(run, list(range(s)), n, "calibrations")
    buffers = torch.empty((s, t_len) + tuple(run.frame_hw),
                          dtype=torch.uint8, device=run.device)
    for j in range(t_len):
        buffers[:, j] = src.device_frames(j - t_len)
    heats, seen = {}, []
    locate = evm.locate

    def watched(vid, fps, cfg):
        res = locate(vid, fps, cfg)
        if len(seen) in keep:
            heats[len(seen)] = res.heatmap_u8
        seen.append(1)
        return res
    evm.locate = watched
    try:
        loc = run.mon.calibrate(buffers)
    finally:
        evm.locate = locate
    del buffers
    found = loc.found.cpu().numpy()
    boxes = loc.boxes.cpu().numpy()
    # What the crop bucket was sized from (check.box_wh).
    run.boxes = boxes
    run.calibrated = [(i, (bool(found[i]),) + tuple(int(v) for v in boxes[i]),
                       heats[i]) for i in keep]

    def calibrations() -> List[tuple]:
        """(buffer frames (host), box, heatmap) of the checked streams, for
        ``check.calibration_readings``."""
        return [(src.history(i, -1, t_len).cpu(), box, heat)
                for i, box, heat in run.calibrated]
    # The fleet's own calibrate replaces set-up's per-subject locates:
    # its streams' buffers are the calibrations the check compares.
    run.calibrations = calibrations


def warm(run) -> None:
    _record_localizes(run)
    _calibrate(run)
    n = run.cfg.measure.buffer_length
    with drive.no_estimate():
        while run.ring_length() < n:
            run.setup_step()
    for _ in range(int(run.traffic["warm_estimates"])):
        run.setup_step()
    # On to the end of the localize interval: the window runs whole ones.
    while not unit_ends(run):
        run.setup_step()


def unit_ends(run) -> bool:
    return bool(run.localizes) and run.localizes[-1].tick == run.k - 1


def after_step(run) -> None:
    """The ROIs the re-lock left, after a step that localized."""
    if unit_ends(run):
        run.localizes[-1].roi1 = run.mon.states.roi


def end_to_end(run):
    """``stream_frames_per_s`` over the window's seconds."""
    first, t_open, t_close = run.window
    done = run.streams * len(run.steps[first:])
    return ({"stream_frames_per_s": done / (t_close - t_open)}, done,
            int(check.state_faults(run)))


# ---------------------------------------------------------------------------
# The compared numbers
# ---------------------------------------------------------------------------

def _relocks(run) -> dict:
    """{tick: (apply (S,) bool, ROIs after (S, 4))} of the localizes whose
    re-lock moved a window."""
    return {lc.tick: ((lc.roi1 != lc.roi0).any(dim=1), lc.roi1)
            for lc in run.localizes if lc.relocked()}


def start_readings(run, side: str) -> float:
    """The reference's own run from the state ``calibrate`` installed
    through set-up's steps, its state re-locked where the program re-locked
    (onto the program's new ROIs, which ``relock_faults`` holds to the
    rule), against the program's samples (or the control's own run)."""
    spec = check.flow_spec(run, *check.box_wh(run, 0))
    s0 = run.steps[0].s0
    sides = {"ref": s0, "ctl": s0}
    relocks = _relocks(run)
    got_all, want_all = [], []
    prev = None
    for i in range(run.window[0]):
        fr = run.src.device_frames(run.steps[i].frame)
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
        if i in relocks:
            apply, rois = relocks[i]
            sides = {k: ref_streaming.relock(v, rois, apply, spec)
                     for k, v in sides.items()}
        prev = fr
    want, got = np.stack(want_all), np.stack(got_all)
    scale = np.nanmax(np.abs(want), axis=0)
    return check.rel(got, want, scale[None, :])


def step_readings(run, side: str, n: int, n_relocked: int) -> dict:
    """``check.step_readings`` over window steps drawn from the seed, of
    which ``n_relocked`` follow a re-lock (where the window has them)."""
    first = run.window[0]
    relocked = {lc.tick for lc in run.localizes if lc.relocked()}
    cands = [i for i in range(max(first, 1), len(run.steps))
             if bool(ref.as_numpy(run.steps[i].s0.initialized).all())]
    after = [i for i in cands if i - 1 in relocked]
    picked = check.pick(run, after, n_relocked, "relocked steps")
    rest = [i for i in cands if i not in picked]
    picked = sorted(picked + check.pick(run, rest, n - len(picked), "steps"))
    got_s, want_s, mismatch = [], [], 0
    mcfg = check._measure_cfg(run)
    tf32 = side != "program"
    spec = check.flow_spec(run, *check.box_wh(run, 0))
    for i in picked:
        rec = run.steps[i]
        prev = run.src.device_frames(run.steps[i - 1].frame)
        fr = run.src.device_frames(rec.frame)
        want = ref.flow_step(prev, fr, rec.s0, spec).sample
        want_s.append(ref.as_numpy(want))
        if tf32:
            got = ref.flow_step(prev, fr, rec.s0, spec, tf32=True).sample
            got_s.append(ref.as_numpy(got))
            has_g, bpm_g = check._estimate(run, rec, got, mcfg, True)
        else:
            got_s.append(np.asarray(rec.sample, np.float64).reshape(-1))
            has_g = np.asarray(rec.bpm[0]).reshape(-1)
            bpm_g = np.asarray(rec.bpm[1], np.float64).reshape(-1)
        has_w, bpm_w = check._estimate(run, rec, want, mcfg, False)
        bad = (has_g != has_w) | (has_w & (np.abs(
            np.where(has_w, bpm_g - bpm_w, 0.0)) > 1e-3))
        mismatch += int(bad.sum())
    if len(picked) < n or len(after) < n_relocked:
        # Too few window steps, or too few after a re-lock, to compare.
        return {"sample_rel": check.BIG, "bpm_mismatch": float(mismatch)}
    want, got = np.stack(want_s), np.stack(got_s)
    scale = np.nanmax(np.abs(want), axis=0)
    return {"sample_rel": check.rel(got, want, scale[None, :]),
            "bpm_mismatch": float(mismatch)}


def localize_readings(run, side: str, n_loc: int, n_streams: int) -> dict:
    """``localize_box_px``: the largest gap of x, y, w, h between the
    program's coarse box and the reference's localize of the stream's last
    ``buffer_length`` frames (a found/not-found disagreement counts 1e9),
    over ``n_loc`` localizes of the window (of the run, where the window
    has fewer) and ``n_streams`` streams each, drawn from the seed;
    ``localize_heat_px``: the most pixels of their coarse uint8 heatmaps
    that differ."""
    cal = run.ref_cfg.calibration
    t_len = cal.buffer_length
    window = [lc for lc in run.localizes if lc.tick >= run.window[0]]
    pool = window if len(window) >= n_loc else run.localizes
    picked = check.pick(run, list(range(len(pool))), n_loc, "localizes")
    box_px = heat_px = 0.0
    for j in picked:
        lc = pool[j]
        boxes = lc.boxes()
        streams = check.pick(run, list(range(run.streams)), n_streams,
                             f"localize:{lc.tick}")
        for s in streams:
            vid = run.src.history(s, lc.tick, t_len)
            want, want_heat = ref_streaming.localize(vid, run.fps, cal)
            if side == "program":
                got = (bool(boxes[0, s]),) + tuple(int(v)
                                                   for v in boxes[1:, s])
                got_heat = lc.loc.heatmap_u8[s]
            else:
                got, got_heat = ref_streaming.localize(vid, run.fps, cal,
                                                       tf32=True)
            del vid
            heat_px = max(heat_px, float((got_heat.to(want_heat.device)
                                          != want_heat).sum()))
            if got[0] != want[0]:
                box_px = check.BIG
            elif got[0]:
                box_px = max(box_px, max(abs(a - b) for a, b in
                                         zip(got[1:], want[1:])))
    if len(picked) < n_loc:
        box_px = check.BIG   # too few localizes to compare
    return {"localize_box_px": float(box_px),
            "localize_heat_px": float(heat_px)}


def relock_faults(run) -> float:
    """Localizes whose re-lock (the streams it moved and their new ROIs)
    differs from the reference rule applied to that localize's boxes and
    the ROIs before it."""
    faults = 0
    for lc in run.localizes:
        if lc.roi1 is None:
            faults += 1
            continue
        _, want = ref_streaming.relock_rule(
            lc.boxes(), ref.as_numpy(lc.roi0), run.cfg.streaming_drift_px,
            run.frame_hw)
        faults += int(not np.array_equal(want, ref.as_numpy(lc.roi1)))
    return float(faults)


def localize_faults(run) -> float:
    """Steps of the run where a localize ran off the schedule (every
    ``streaming_interval``-th step since ``calibrate``), ran twice, or was
    due and did not run."""
    every = run.cfg.streaming_interval
    ran = [lc.tick for lc in run.localizes]
    due = {k for k in range(len(run.steps)) if (k + 1) % every == 0}
    return float(len(set(ran) ^ due) + len(ran) - len(set(ran)))


def readings(run, side: str, checks: dict) -> dict:
    out = check.calibration_readings(run, side)
    out["start_sample_rel"] = start_readings(run, side)
    out.update(step_readings(run, side, checks.get("steps", 6),
                             checks.get("relocked_steps", 2)))
    out.update(localize_readings(run, side, checks.get("localizes", 3),
                                 checks.get("localize_streams", 8)))
    program = side == "program"
    out["relock_faults"] = relock_faults(run) if program else 0.0
    out["localize_faults"] = localize_faults(run) if program else 0.0
    out["ring_faults"] = check.ring_faults(run) if program else 0.0
    out["state_faults"] = check.state_faults(run) if program else 0.0
    return out
