"""Set-up and measured window of each kind of system, driven through the
program's public entry points: ``runtime.RespiratoryMonitor.step()`` for a
``"monitor"`` configuration, ``parallel.streams.MultiStreamMonitor.step()``
for a ``"fleet"``.  The traffic's kind (``benchmark/kinds/<kind>.py``,
found by the name its traffic file gives) supplies the frames, set-up's
steps and the window's unit of work.  What a step consumed and what it
produced is kept in ``Step`` records for the correctness check, which runs
after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import time
from typing import Any, List, Optional

import numpy as np
import torch

from benchmark.harness import timing


def monitor_config(module, d: dict):
    """A ``MonitorConfig`` of ``module`` (the program's ``config`` or the
    reference's copy) from a configuration file's ``"monitor"`` group."""
    d = dict(d)
    cal = dict(d.pop("calibration"))
    cal["maximum_bounding_box_area"] = float(cal["maximum_bounding_box_area"])
    lk = dict(d.pop("lk"))
    lk["win_size"] = tuple(lk["win_size"])
    if d.get("fig_size") is not None:
        d["fig_size"] = tuple(d["fig_size"])
    return module.MonitorConfig(
        calibration=module.CalibrationConfig(**cal),
        measure=module.MeasureConfig(**d.pop("measure")),
        features=module.FeatureParams(**d.pop("features")),
        lk=module.LKParams(**lk), **d)


def kind_module(kind: str):
    """``benchmark/kinds/<kind>.py``."""
    return importlib.import_module(f"benchmark.kinds.{kind}")


@dataclasses.dataclass
class Step:
    """One ``step()``: the states before and after (the monitor's state
    machine; "measure" for a fleet), the frames it consumed (``frame``: a
    source's frame id, or a fleet step's index), its host seconds, and for
    a measured step the program's state fields before it (``s0``), its
    signal rings before (``r0``) and after it (``s1``) and its outputs."""

    before: str
    after: str
    frame: Any
    t0: float
    t1: float
    cal0: int = 0
    cal1: int = 0
    s0: Any = None
    r0: Any = None
    s1: Any = None
    sample: Any = None
    error: Any = None
    bpm: Any = None       # (has_bpm, bpm): consumed results, else None
    box: Any = None       # (found, x, y, w, h) after a calibration
    heat: Any = None      # its (H, W) uint8 heatmap, where kept


def _flow_fields(state, batched: bool):
    """The state fields a flow step reads (reference.system.FlowState)."""
    from benchmark.reference.system import FlowState

    def b(x):
        return x if batched else x[None]
    return FlowState(roi=b(state.roi), initialized=b(state.initialized),
                     pts=b(state.pts), pts_valid=b(state.pts_valid),
                     motion_xy=b(state.motion_xy),
                     motion_count=b(state.motion_count))


def _rings(state, batched: bool):
    def b(x):
        return x if batched else x[None]
    return b(state.data), b(state.t), b(state.count)


@contextlib.contextmanager
def no_estimate():
    """The program's BPM estimate (``pipeline/bpm.estimate_bpm``) replaced
    by one that reports no BPM, for set-up's steps that fill the signal
    rings: filling a ring then costs its motion steps alone.  The device
    state those steps leave is the program's own (the estimate reads the
    ring and writes nothing of the state)."""
    from respmon_tpu_torch.pipeline import bpm

    real = bpm.estimate_bpm

    def none(data, t, count, coeffs, min_dist, cfg):
        dev, batch = data.device, data.shape[:-1]
        lanes = batch + (cfg.max_peaks,)
        no = torch.zeros(lanes, dtype=torch.bool, device=dev)
        return bpm.BPMResult(
            has_bpm=torch.zeros(batch, dtype=torch.bool, device=dev),
            bpm=torch.zeros(batch, dtype=data.dtype, device=dev),
            filtered=torch.zeros_like(data),
            cand_idx=torch.zeros(lanes, dtype=torch.int32, device=dev),
            cand_mask=no, accept_mask=no,
            peak_count=torch.zeros(batch, dtype=torch.int32, device=dev))
    bpm.estimate_bpm = none
    try:
        yield
    finally:
        bpm.estimate_bpm = real


class _Run:
    """What every system shares: the cell's files, the device, the seed,
    the traffic's kind, set-up and the records."""

    system = ""

    def __init__(self, cell: dict, seed: int, device, sizes: dict = None,
                 traffic: dict = None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        conf = dict(cell["config_data"])
        conf.update(sizes or {})
        self.conf = conf
        self.traffic = dict(cell["traffic_data"])
        self.traffic.update(traffic or {})
        self.kind = kind_module(self.traffic["kind"])
        if self.system not in self.kind.SYSTEMS:
            raise ValueError(f"traffic kind {self.traffic['kind']!r} does "
                             f"not drive a {self.system}")
        self.frame_hw = tuple(conf["frame_hw"])
        self.fps = float(conf["fps"])
        self.streams = int(conf["streams"])
        from respmon_tpu_torch import config as pconfig
        from benchmark.reference import config as rconfig
        self.cfg = monitor_config(pconfig, conf["monitor"])
        self.ref_cfg = monitor_config(rconfig, conf["monitor"])
        self.steps: List[Step] = []
        self.window = None     # (first step index, t_open, t_close)
        self.overrun = False   # a unit of the window never ended
        self.setup_limit = 20 * (self.cfg.calibration.buffer_length + 2) \
            + 4 * self.cfg.measure.buffer_length

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_step(self) -> None:
        """One step of set-up; a set-up that never lets the window open
        raises."""
        if len(self.steps) >= self.setup_limit:
            raise RuntimeError(f"set-up did not warm the {self.system} in "
                               f"{self.setup_limit} steps")
        self.step()
        self.after_step()

    def after_step(self) -> None:
        self.kind.after_step(self)

    def release(self):
        """Drop the program's objects once the window has closed; the
        records and the frames stay for the check."""
        unpatch = getattr(self, "_unpatch", None)
        if unpatch is not None:
            unpatch()
            self._unpatch = None
        self.mon = None
        if getattr(self.src, "monitor", None) is not None:
            self.src.monitor = None
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The single-stream monitor
# ---------------------------------------------------------------------------

class MonitorRun(_Run):
    """``runtime.RespiratoryMonitor`` on one camera; the kind's source is
    its capture."""

    system = "monitor"

    def setup(self):
        from respmon_tpu_torch.runtime import RespiratoryMonitor

        self.src = self.kind.source(self)
        c = self.cfg
        mon = RespiratoryMonitor(
            capture_target="benchmark", capture=self.src, config=c,
            fps_limit=c.fps_limit, error_reset_delay=c.error_reset_delay,
            save_all_data=c.save_all_data, visualize=c.visualize,
            motion_extraction_method=c.motion_extraction_method,
            auto_run=False, sync_fps=False, use_feeder=False,
            device=self.device)
        self.src.monitor = mon
        self._watch_locate()
        self._consumed = None
        consume = mon._consume_bpm

        def consumed(filtered, accept_mask, cand_idx, has_bpm, bpm):
            self._consumed = (bool(has_bpm), float(bpm))
            return consume(filtered, accept_mask, cand_idx, has_bpm, bpm)
        mon._consume_bpm = consumed
        self.mon = mon
        self.kind.warm(self)
        self.sync()

    def _watch_locate(self):
        """Keep the heatmap of each calibration's ``evm.locate`` (the
        program's output the monitor does not keep): the first one's, and
        a reservoir of ``checks.calibrations`` - 1 of the rest drawn from
        the seed, so that memory stays bounded."""
        from respmon_tpu_torch.pipeline import evm
        from benchmark.harness import frames as gen

        locate = evm.locate
        self._heat = None
        self._kept = []
        self._seen = 0
        self._reservoir = gen.rng(self.seed, "calibrations")
        self._keep_n = int(self.traffic.get("checks", {})
                           .get("calibrations", 12))

        def watched(vid, fps, cfg):
            res = locate(vid, fps, cfg)
            self._heat = res.heatmap_u8
            return res
        evm.locate = watched

        def unpatch():
            evm.locate = locate
        self._unpatch = unpatch

    def _keep_heat(self, rec: Step) -> None:
        """Reservoir sampling over the calibrations after the first."""
        heat, self._heat = self._heat, None
        self._seen += 1
        if self._seen == 1:
            rec.heat = heat
            return
        if len(self._kept) < self._keep_n - 1:
            rec.heat = heat
            self._kept.append(rec)
            return
        j = int(self._reservoir.integers(0, self._seen - 1))
        if j < len(self._kept):
            self._kept[j].heat = None
            rec.heat = heat
            self._kept[j] = rec

    def ring_length(self) -> int:
        """Samples in the signal ring (0 until the monitor measures)."""
        return len(self.mon.data) if self.mon.state == "measure" else 0

    def step(self) -> Step:
        mon = self.mon
        before, cal0 = mon.state, mon.calibration_buffer_idx
        s0 = mon._measure_state if before == "measure" else None
        t0 = time.perf_counter()
        if not mon.step():
            raise RuntimeError("the source ended")
        t1 = time.perf_counter()
        rec = Step(before=before, after=mon.state, frame=self.src.last_id,
                   t0=t0, t1=t1, cal0=cal0, cal1=mon.calibration_buffer_idx)
        if before == "measure":
            s1 = mon._measure_state
            rec.s0 = _flow_fields(s0, False)
            rec.r0 = _rings(s0, False)
            rec.s1 = _rings(s1, False)
            rec.sample = mon.data[-1]
            rec.error = s1.error
            rec.bpm, self._consumed = self._consumed, None
        elif before == "calibration" and rec.after == "measure":
            rec.box = (True, mon.x, mon.y, mon.w, mon.h)
            self._keep_heat(rec)
        self.steps.append(rec)
        return rec

    def frames_of(self, i: int) -> np.ndarray:
        """(1, H, W) uint8 frames of step ``i``."""
        return self.src.frame_of(self.steps[i].frame)[None]

    def calibrations(self) -> List[tuple]:
        """(frames (T, H, W) uint8 as handed in, the program's box, its
        heatmap) of the buffers the monitor filled and located whose
        heatmaps the run kept (the first, and a reservoir drawn from the
        seed)."""
        t_len = self.cfg.calibration.buffer_length
        out, stored = [], []
        for rec in self.steps:
            if rec.before == "calibration" and rec.cal1 == rec.cal0 + 1:
                stored.append(rec.frame)
            elif rec.cal1 < rec.cal0 or rec.before == "error":
                stored = []
            if rec.box is not None:
                if rec.heat is not None:
                    buf = np.stack([self.src.frame_of(f)
                                    for f in stored[-t_len:]])
                    out.append((buf, rec.box, rec.heat))
                stored = []
        return out


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------

class FleetRun(_Run):
    """``parallel.streams.MultiStreamMonitor``: S cameras in lockstep, the
    tick's frames one host batch, one host read of the (S,) results."""

    system = "fleet"

    def setup(self):
        from respmon_tpu_torch.parallel import streams as fleet
        from respmon_tpu_torch.pipeline import evm, motion
        from benchmark.reference.bbox import reduce_bounding_box

        dev = self.device
        h, w = self.frame_hw
        self.src = self.kind.source(self)
        self.batch = torch.empty((self.streams, h, w), dtype=torch.uint8,
                                 pin_memory=dev.type == "cuda")

        # One calibration per subject clip (bench --multistream's pattern,
        # respmon_tpu_torch/bench.py:775-813): evm.locate over the clip's
        # first buffer_length frames, its box for every stream showing it.
        cal = self.cfg.calibration
        self.clip_boxes, self.clip_heats = [], []
        for k, clip in enumerate(self.src.clips(cal.buffer_length)):
            loc = evm.locate(clip.to(dev), self.fps, cal)
            found, x, y, bw, bh = (int(v) for v in torch.stack(
                [loc.found.to(torch.int32), loc.x, loc.y, loc.w,
                 loc.h]).cpu())
            if not found:
                raise RuntimeError(f"no ROI found in subject clip {k}")
            self.clip_boxes.append((True,) + tuple(reduce_bounding_box(
                x, y, bw, bh, cal.maximum_bounding_box_area)))
            self.clip_heats.append(loc.heatmap_u8)
        boxes = np.asarray([self.clip_boxes[k][1:]
                            for k in self.src.clip_of], np.int32)
        mon = fleet.MultiStreamMonitor(self.cfg, None, (h, w), self.fps,
                                       device=dev)
        mon.spec = motion.MeasureSpec.for_roi(
            self.cfg, h, w, int(boxes[:, 2].max()), int(boxes[:, 3].max()),
            self.fps)
        mon.states = fleet.init_stream_states(mon.spec, boxes, device=dev)
        self.boxes = boxes
        self.mon = mon
        self.k = 0
        self.kind.warm(self)
        self.sync()

    def ring_length(self) -> int:
        return min(self.k, self.cfg.measure.buffer_length)

    def step(self) -> Step:
        mon, k = self.mon, self.k
        self.src.fill(k, self.batch)
        s0 = mon.states
        t0 = time.perf_counter()
        res = mon.step(self.batch)
        host = torch.stack([res.samples.to(torch.float64),
                            res.bpm.to(torch.float64),
                            res.has_bpm.to(torch.float64),
                            res.error.to(torch.float64)]).cpu().numpy()
        t1 = time.perf_counter()
        s1 = mon.states
        rec = Step(before="measure", after="measure", frame=k, t0=t0, t1=t1,
                   s0=_flow_fields(s0, True), r0=_rings(s0, True),
                   s1=_rings(s1, True), sample=host[0],
                   error=host[3].astype(bool),
                   bpm=(host[2].astype(bool), host[1]))
        self.steps.append(rec)
        self.k += 1
        return rec

    def frames_of(self, i: int) -> torch.Tensor:
        """(S, H, W) uint8 frames of step ``i`` (host)."""
        return self.src.frames(self.steps[i].frame)

    def calibrations(self) -> List[tuple]:
        """(clip frames, box, heatmap) of set-up's per-clip ``locate``s."""
        clips = self.src.clips(self.cfg.calibration.buffer_length)
        return list(zip(clips, self.clip_boxes, self.clip_heats))


SYSTEMS = {"monitor": MonitorRun, "fleet": FleetRun}


def make_run(cell: dict, seed: int, device, sizes: dict = None,
             traffic: dict = None) -> _Run:
    """The cell's run; ``sizes`` and ``traffic`` override entries of its
    configuration and traffic files (the CPU tests' small runs)."""
    system = cell["config_data"]["system"]
    if system not in SYSTEMS:
        raise ValueError(f"unknown system {system!r}")
    return SYSTEMS[system](cell, seed, device, sizes, traffic)


# ---------------------------------------------------------------------------
# The measured window
# ---------------------------------------------------------------------------

def span_targets(run: _Run, mode: str):
    """The program's functions that the spans wrap, by layer."""
    from respmon_tpu_torch.pipeline import bpm, evm, motion

    motion_step = "measure_step_cached" if isinstance(run, FleetRun) \
        else "measure_step"
    targets = [(motion, motion_step, "motion"),
               (bpm, "estimate_bpm", "estimate"), (evm, "locate", "locate")]
    if mode == "trace":
        targets.append((evm, "_band_laplacian_levels", "k1"))
    return targets


def k1_note(vid, cfg):
    return (tuple(vid.shape), cfg.pyramid_levels, cfg.skip_levels_at_top)


# How long past its end a window waits for its unit of work to end.
OVERRUN_S = 60.0


def _advance(run: _Run, until: float, units: Optional[int] = None) -> int:
    """Step until ``until`` (perf_counter) has passed at the end of a unit,
    or ``units`` units are done; returns the units done.  A unit that has
    not ended ``OVERRUN_S`` past ``until`` (or past the start, with
    ``units``) stops the window and sets ``run.overrun``."""
    done = 0
    give_up = (until if units is None else time.perf_counter()) + OVERRUN_S
    while True:
        run.step()
        run.after_step()
        t = run.steps[-1].t1
        if run.kind.unit_ends(run):
            done += 1
            if units is not None and done >= units:
                return done
            if units is None and t >= until:
                return done
        if t >= give_up:
            run.overrun = True
            return done


def window(run: _Run, seconds: float, trace: bool):
    """The measured window: ``seconds`` of closed-loop steps.  With
    ``trace``, ``trace_units`` units (steps, or blackout cycles) from the
    middle of the window run under ``torch.profiler`` with
    ``record_function`` spans, and the rest of the window under the
    synchronising spans.  Returns (profile summary or None, the timing
    spans or None, the traced spans or None)."""
    first = len(run.steps)
    run.sync()
    t_open = time.perf_counter()
    prof_summary = timed = traced = None
    if not trace:
        _advance(run, t_open + seconds)
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if run.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        timed = timing.Spans("time", span_targets(run, "time"))
        traced = timing.Spans("trace", span_targets(run, "trace"),
                              notes={"k1": k1_note})
        with timed:
            _advance(run, t_open + seconds / 2)
        with torch.profiler.profile(activities=acts) as prof:
            with traced:
                with torch.profiler.record_function(timing.WINDOW):
                    _advance(run, math.inf,
                             units=int(run.traffic["trace_units"]))
                    run.sync()
        with timed:
            if time.perf_counter() < t_open + seconds:
                _advance(run, t_open + seconds)
    run.sync()
    run.window = (first, t_open, run.steps[-1].t1)
    if trace:
        # Read the trace once the window has closed.
        prof_summary = timing.reduce_profile(prof)
        del prof
    return prof_summary, timed, traced
