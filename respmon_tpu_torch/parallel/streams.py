"""Multi-stream (multi-kennel) monitoring: S streams in lockstep, on one
card or sharded over the ranks of a mesh.

Port of ``respmon_tpu/parallel/streams.py``.  BASELINE.md config 5: 64
concurrent 1080p streams.  Each stream is an independent monitor (its own
ROI and signal state).  Where the JAX package ``vmap``s the single-stream
pipeline over a leading stream axis, the port carries that axis on every
tensor of the fleet step: one ``MultiStreamMonitor.step`` runs the same
operations (and, given the same loop counts, the same launches) whether S
is 2 or 64.  All streams share one crop bucket (the largest ROI, rounded up
to ``roi_bucket``).

With a mesh (``parallel/mesh``), each rank runs these batch functions on
its own S / n rows of the stream axis (``stream_sharding``): the JAX
package's ``shard_map`` programs are data-parallel with no collective, and
so is the port's work.  Every rank keeps the single-card host API (global
(S, H, W) frames in, global (S,) results out), so a step's one collective
is one ``all_gather`` of its per-stream results (``gather_rows``).  The
fleet calls the batch functions on its rows and gathers what they return;
the ``make_sharded_*`` factories (the JAX package's names) are that pair
as one function of this rank's rows (as ``shard_streams`` places them):
its per-stream outputs are global and its carried state stays this rank's
rows.

The port loops over streams in three places, each where one stream's work
fills the card or runs rarely: ``locate_streams`` (one ``locate`` per
stream: a 64 x 128 x 1080p buffer is 68 GB as float32),
``measure_clip_streams`` (an offline path) and the connected-component
search of the streaming localize (``streaming.localize_batch``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.config import MonitorConfig
from respmon_tpu_torch.ops import filters
from respmon_tpu_torch.ops.dtype import ingest_frames
from respmon_tpu_torch.parallel.mesh import Mesh, stream_sharding
from respmon_tpu_torch.pipeline import bpm as bpm_mod
from respmon_tpu_torch.pipeline import evm, motion, scan, streaming
from respmon_tpu_torch.utils.bench import span

logger = logging.getLogger(__name__)


class BatchedLocate(NamedTuple):
    found: torch.Tensor   # (S,) bool
    boxes: torch.Tensor   # (S, 4) int32 x,y,w,h


def locate_streams(buffers: torch.Tensor, fps: float, cfg) -> BatchedLocate:
    """EVM calibration of (S, T, H, W) buffers, one ``evm.locate`` per
    stream (each fills the card; their inputs together need not fit)."""
    found, boxes = [], []
    for buf in buffers:
        r = evm.locate(buf, fps, cfg)
        found.append(r.found)
        boxes.append(torch.stack([r.x, r.y, r.w, r.h]))
    return BatchedLocate(found=torch.stack(found),
                         boxes=torch.stack(boxes).to(torch.int32))


def _stack_tree(items):
    """Stack a list of equal NamedTuples (or tensors) field by field."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack_tree(list(f)) for f in zip(*items)))
    return torch.stack(items)


def measure_clip_streams(frames: torch.Tensor, rois,
                         spec: motion.MeasureSpec,
                         coeffs: filters.FilterCoeffs, min_dist: int, cfg,
                         estimate_every_frame: bool = True
                         ) -> scan.ClipMeasureResult:
    """Whole-clip measurement of (S, T, H, W) clips at (S, 4) ROIs, one
    ``scan.measure_clip`` per stream (an offline path); every field of the
    result gets a leading stream axis."""
    return _stack_tree([
        scan.measure_clip(f, [int(v) for v in r], spec, coeffs, min_dist,
                          cfg, estimate_every_frame)
        for f, r in zip(frames, np.asarray(rois))])


class StreamStepResult(NamedTuple):
    state: motion.MeasureState     # batched (S, ...)
    samples: torch.Tensor          # (S,)
    bpm: torch.Tensor              # (S,)
    has_bpm: torch.Tensor          # (S,) bool
    error: torch.Tensor            # (S,) bool


def _estimate(states: motion.MeasureState, samples, coeffs, min_dist,
              cfg) -> StreamStepResult:
    with span("fleet.estimate"):
        res = bpm_mod.estimate_bpm(states.data, states.t, states.count,
                                   coeffs, min_dist, cfg)
    ran = states.count > cfg.initialization_length
    return StreamStepResult(state=states, samples=samples, bpm=res.bpm,
                            has_bpm=res.has_bpm & ran, error=states.error)


def monitor_step_streams(states: motion.MeasureState, frames: torch.Tensor,
                         spec: motion.MeasureSpec,
                         coeffs: filters.FilterCoeffs, min_dist: int,
                         cfg, initialized: bool = False) -> StreamStepResult:
    """One live monitoring step for S streams at once: the batched motion
    step, then the BPM estimate of all S rings.  ``initialized=True``
    skips the first-frame corner detection (see
    ``motion.measure_step_batch``)."""
    with span("fleet.motion"):
        states, samples = motion.measure_step_batch(states, frames, spec,
                                                    initialized)
    return _estimate(states, samples, coeffs, min_dist, cfg)


def monitor_step_streams_cached(states, cache, frames, spec, coeffs,
                                min_dist, cfg, initialized: bool = False,
                                cache_valid: bool = True):
    """``monitor_step_streams`` with the carried prev-frame LK cache
    (``motion.FlowCache``): one pyramid build a step instead of two, bit
    for bit the same results.  Returns (result, new cache)."""
    with span("fleet.motion"):
        states, cache, samples = motion.measure_step_cached(
            states, cache, frames, spec, initialized, cache_valid)
    return _estimate(states, samples, coeffs, min_dist, cfg), cache


def init_fleet_cache(spec: motion.MeasureSpec, n_streams: int,
                     dtype=torch.float32, device=None) -> motion.FlowCache:
    """Zero-filled batched (S, ...) cache placeholder for the
    ``cache_valid=False`` rebuild step."""
    base = motion.init_flow_cache(spec, dtype, device)
    return motion.FlowCache(stacks=tuple(
        s.expand((n_streams,) + tuple(s.shape)).clone() for s in base.stacks))


class StreamBatchResult(NamedTuple):
    state: motion.MeasureState     # final batched (S, ...) state
    samples: torch.Tensor          # (K, S)
    bpm: torch.Tensor              # (K, S)
    has_bpm: torch.Tensor          # (K, S) bool
    error: torch.Tensor            # (K, S) bool


def monitor_scan_streams(states, frames, spec, coeffs, min_dist, cfg,
                         initialized: bool = False) -> StreamBatchResult:
    """K lockstep steps over a (K, S, H, W) frame batch; per-frame outputs
    come back stacked (K, S)."""
    outs = []
    for fr in frames:
        r = monitor_step_streams(states, fr, spec, coeffs, min_dist, cfg,
                                 initialized)
        states = r.state
        outs.append((r.samples, r.bpm, r.has_bpm, r.error))
    samples, bpm, has, err = (torch.stack(x) for x in zip(*outs))
    return StreamBatchResult(state=states, samples=samples, bpm=bpm,
                             has_bpm=has, error=err)


def fleet_lk_sample(cfg: MonitorConfig, crop_h: int, crop_w: int,
                    n_streams: int) -> str:
    """The fleet's LK next-window sampling mode: ``"slices"``, the one the
    port has (the JAX package picks it too off a TPU; its ``"onehot"`` is
    a TPU gather strategy, bit-identical to it).  The port's flow step
    always takes the carried LK cache, as the JAX fleet does with this
    mode."""
    del cfg, crop_h, crop_w, n_streams
    return "slices"


def fleet_lk_prev_sample(cfg: MonitorConfig) -> str:
    """The fleet's LK prev-window sampling mode: ``"slices"``, as the JAX
    package picks off a TPU or with ``cfg.fleet_exact_lk``."""
    del cfg
    return "slices"


# ---------------------------------------------------------------------------
# Fleet streaming-ROI re-lock: the single monitor's streaming step at fleet
# scale.  Rolling pyramid rings are batched (S, T, h, w) per kept level;
# every fleet step absorbs all S frames with one K1 call, the localize half
# runs every streaming_interval frames (by default with the coarse collapse,
# at level skip_levels_at_top: the granularity a drift detector needs), and
# drifted streams re-lock through motion.relock_state_batch: tracked points
# and signal rings survive, so a moving subject never meets the
# error -> recalibrate stall.
# ---------------------------------------------------------------------------


def init_fleet_streaming(frame_hw: Tuple[int, int], cfg, n_streams: int,
                         dtype=torch.float32,
                         device=None) -> streaming.StreamingState:
    """Zero-filled batched streaming rings for S streams."""
    base = streaming.init_streaming_state(frame_hw[0], frame_hw[1], cfg,
                                          dtype, device)
    return streaming.StreamingState(
        levels=tuple(lv.expand((n_streams,) + tuple(lv.shape)).clone()
                     for lv in base.levels),
        count=torch.zeros((n_streams,), dtype=torch.int32,
                          device=base.count.device))


def init_fleet_streaming_from_buffers(buffers: torch.Tensor, cfg):
    """Warm-start batched rings from the (S, T, H, W) calibration buffers
    (K1 over the flattened stack, in chunks; see
    ``streaming.init_streaming_from_buffers_batch``)."""
    return streaming.init_streaming_from_buffers_batch(buffers, cfg)


def absorb_streams(sstate, frames: torch.Tensor, cfg):
    """Absorb one (S, H, W) frame batch into the batched rings (one K1
    call)."""
    with span("fleet.absorb", frames=int(frames.shape[0])):
        return streaming.streaming_absorb_batch(sstate, frames, cfg)


def update_streams(sstate, frames: torch.Tensor, fps: float, cfg,
                   coarse: bool = True):
    """Absorb one (S, H, W) frame batch AND localize every stream over its
    rolling window.  Returns (rings, per-stream ``StreamingLocate``)."""
    new_state = absorb_streams(sstate, frames, cfg)
    hw = tuple(frames.shape[-2:])
    loc = streaming.localize_batch(new_state, hw, new_state.levels[0].dtype,
                                   fps, cfg, coarse)
    return new_state, loc


def relock_streams(states: motion.MeasureState, frames: torch.Tensor,
                   new_rois, apply, spec: motion.MeasureSpec
                   ) -> motion.MeasureState:
    """Batched masked re-lock: streams where ``apply`` holds move their
    measurement window onto ``new_rois`` (``motion.relock_state_batch``:
    tracked points move with the window, signal rings stay); the others
    keep their state bit for bit."""
    dev = states.data.device
    apply = torch.as_tensor(apply, device=dev)
    relocked = motion.relock_state_batch(states, frames, new_rois, spec)
    return motion.where_streams(apply, relocked, states)


def init_stream_states(spec: motion.MeasureSpec, rois,
                       dtype=torch.float32,
                       device=None) -> motion.MeasureState:
    """Batched initial states from per-stream (S, 4) ROIs."""
    rois = torch.as_tensor(np.asarray(rois), dtype=torch.int32)
    base = motion.init_state(spec, (0, 0, 0, 0), dtype=dtype, device=device)
    s = rois.shape[0]
    batched = motion.MeasureState(*(
        f.expand((s,) + tuple(f.shape)).clone() for f in base))
    return batched._replace(roi=rois.to(base.roi.device))


# ---------------------------------------------------------------------------
# The sharded fleet: each rank runs the batch functions above on its own
# S / n rows of the stream axis.  The only collective is the gather of the
# per-stream outputs that every rank's host API returns.  The absorb and
# the re-lock return only carried state, so theirs are the batch functions
# themselves.
# ---------------------------------------------------------------------------


def shard_streams(tree, mesh: Mesh, axis: str = "streams"):
    """This rank's rows (``stream_sharding``) of a (named) tuple of (S, ...)
    tensors or numpy arrays, on the mesh's device: the port's placement of
    a stream-sharded tree onto the mesh."""
    if isinstance(tree, tuple):
        vals = [shard_streams(x, mesh, axis) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    rows = stream_sharding(mesh, tree.shape[0], axis)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree[rows])).to(mesh.device)
    return tree[rows].to(mesh.device)


def gather_rows(mesh: Mesh, tensors, axis: str = "streams", dim: int = 0):
    """The global tensors of every rank's rows along ``dim``, in ONE
    ``all_gather``: the rows travel packed side by side as float64, which
    holds every dtype the fleet gathers (bool, uint8, int32, float32,
    float64) exactly, and come back in their own dtypes and shapes."""
    tensors = [t.movedim(dim, 0) for t in tensors]
    n_rows = tensors[0].shape[0]
    packed = torch.cat([t.reshape(n_rows, -1).to(torch.float64)
                        for t in tensors], dim=1)
    full = mesh.all_gather(packed, axis)
    out, k = [], 0
    for t in tensors:
        width = int(np.prod(t.shape[1:], dtype=np.int64))
        part = full[:, k:k + width].to(t.dtype)
        out.append(part.reshape((-1,) + tuple(t.shape[1:])).movedim(0, dim))
        k += width
    return out


def _gather_result(mesh: Mesh, axis: str, res, dim: int = 0):
    """A step or scan result with its per-stream outputs made global (one
    ``all_gather``); its state stays this rank's rows."""
    samples, bpm, has, err = gather_rows(
        mesh, (res.samples, res.bpm, res.has_bpm, res.error), axis, dim)
    return res._replace(samples=samples, bpm=bpm, has_bpm=has, error=err)


def make_sharded_locate(mesh: Mesh, fps: float, cfg,
                        axis: str = "streams"):
    """Calibration of this rank's (S / n, T, H, W) buffers, one
    ``evm.locate`` per local stream; the ``BatchedLocate`` comes back
    global."""
    def local(buffers) -> BatchedLocate:
        return BatchedLocate(*gather_rows(
            mesh, locate_streams(buffers, fps, cfg), axis))
    return local


def make_sharded_monitor_step(mesh: Mesh, spec: motion.MeasureSpec,
                              coeffs: filters.FilterCoeffs, min_dist: int,
                              cfg, axis: str = "streams",
                              initialized: bool = False):
    """``monitor_step_streams`` on this rank's rows: each rank's loops
    (LK, the LM fit) stop on its own streams alone."""
    def local(states, frames) -> StreamStepResult:
        return _gather_result(mesh, axis, monitor_step_streams(
            states, frames, spec, coeffs, min_dist, cfg, initialized))
    return local


def make_sharded_monitor_step_cached(mesh: Mesh, spec: motion.MeasureSpec,
                                     coeffs: filters.FilterCoeffs,
                                     min_dist: int, cfg,
                                     axis: str = "streams",
                                     initialized: bool = False,
                                     cache_valid: bool = True):
    """``monitor_step_streams_cached`` on this rank's rows and its rows of
    the carried LK cache.  Returns (result, this rank's new cache)."""
    def local(states, cache, frames):
        res, cache = monitor_step_streams_cached(
            states, cache, frames, spec, coeffs, min_dist, cfg,
            initialized, cache_valid)
        return _gather_result(mesh, axis, res), cache
    return local


def make_sharded_monitor_scan(mesh: Mesh, spec: motion.MeasureSpec,
                              coeffs: filters.FilterCoeffs, min_dist: int,
                              cfg, axis: str = "streams",
                              initialized: bool = False):
    """``monitor_scan_streams`` over this rank's (K, S / n, H, W) frames;
    the (K, S) outputs come back global."""
    def local(states, frames) -> StreamBatchResult:
        return _gather_result(mesh, axis, monitor_scan_streams(
            states, frames, spec, coeffs, min_dist, cfg, initialized),
            dim=1)
    return local


def make_sharded_absorb(mesh: Mesh, cfg, axis: str = "streams"):
    """``absorb_streams`` on this rank's rings (no collective)."""
    del mesh, axis

    def local(sstate, frames):
        return absorb_streams(sstate, frames, cfg)
    return local


def make_sharded_update(mesh: Mesh, fps: float, cfg,
                        axis: str = "streams", coarse: bool = True):
    """``update_streams`` on this rank's rings; the per-stream
    ``StreamingLocate`` comes back global."""
    def local(sstate, frames):
        sstate, loc = update_streams(sstate, frames, fps, cfg, coarse)
        return sstate, streaming.StreamingLocate(*gather_rows(mesh, loc,
                                                              axis))
    return local


def make_sharded_relock(mesh: Mesh, spec: motion.MeasureSpec,
                        axis: str = "streams"):
    """``relock_streams`` on this rank's rows of the states, frames, new
    ROIs and mask (no collective)."""
    del mesh, axis

    def local(states, frames, new_rois, apply):
        return relock_streams(states, frames, new_rois, apply, spec)
    return local


class MultiStreamMonitor:
    """Fleet monitor: S concurrent streams on one card, or sharded over
    the ``"streams"`` axis of a mesh.

    The multi-kennel deployment surface (BASELINE.md config 5): calibrate
    all streams, then step frames in lockstep batches.  Per-stream error
    flags surface so the host can recalibrate individual streams
    (``recalibrate`` with a stream mask).  The signature is the JAX
    package's, plus ``device`` (``None``: the card, or with a mesh the
    mesh's device).

    With a mesh every rank makes the same calls with the same global
    arguments ((S, ...) buffers and frames, S divisible by the axis size)
    and gets the same global per-stream results; ``states``, the carried
    LK cache and the streaming rings hold this rank's rows only."""

    def __init__(self, cfg: MonitorConfig, mesh: Optional[Mesh],
                 frame_hw: Tuple[int, int], fps: float,
                 dtype=torch.float32, streaming_coarse: bool = True,
                 device=None) -> None:
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            self.device = device_mod.resolve(device)
        else:
            if "streams" not in mesh.shape:
                raise ValueError("a fleet's mesh needs a 'streams' axis, "
                                 f"not {mesh.axis_names}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        self.frame_hw = tuple(frame_hw)
        self.dtype = dtype
        self.spec: Optional[motion.MeasureSpec] = None
        self._states: Optional[motion.MeasureState] = None
        # Streaming-ROI re-lock (cfg.streaming_roi): batched rolling rings
        # and the per-stream drift re-lock.  ``streaming_coarse`` keeps the
        # per-interval localize at level skip_levels_at_top (the fleet
        # default; False gives the single-stream monitor's full-resolution
        # localize).
        self.streaming_coarse = bool(streaming_coarse)
        self._streaming = None
        self._stream_tick = 0
        self._rois: Optional[np.ndarray] = None   # host mirror (S, 4)
        self.relocks = 0
        # What ran K1, for a check of its launches: single-stream locates
        # (calibrate, recalibrate), warm starts of the rings and absorbed
        # (S, H, W) batches.
        self.locates = 0
        self.streaming_starts = 0
        self.streaming_absorbed = 0
        # Rows that repeat a stream's previous frame (a live FleetFeeder's
        # ``stale`` mask, when passed to ``step``).  Their streams advance
        # t by 1/fps all the same, as in the JAX package.
        self.stale_rows = 0
        # Unless cfg.fleet_f64_refine, the lockstep step runs without the
        # f64 wild-fit refit: one persistent suspect lane would make every
        # step pay the refit loop.
        self.measure_cfg = cfg.measure
        if not cfg.fleet_f64_refine and cfg.measure.f64_refine:
            self.measure_cfg = dataclasses.replace(cfg.measure,
                                                   f64_refine=False)
        # Carried prev-frame LK stacks (motion.FlowCache, batched); None
        # makes the next step rebuild them.  Any outside assignment to
        # .states drops it (the property setter): the cache is consistent
        # only with states that step() itself produced.
        self._cache = None
        # True until every stream has had its corner-detection step; the
        # steady-state step (the common case) then skips corner detection.
        self._needs_init = True
        self._set_fps(fps)

    @property
    def states(self) -> Optional[motion.MeasureState]:
        return self._states

    @states.setter
    def states(self, value) -> None:
        self._states = value
        self._cache = None

    def _set_fps(self, fps: float) -> None:
        """Install ``fps`` and what derives from it (the lowpass design
        and the peak min-distance)."""
        self.fps = float(fps)
        cfg = self.cfg
        self.coeffs = filters.design_butter_lowpass(
            cfg.calibration.freq_max * 0.5, self.fps,
            cfg.measure.filter_order)
        self.min_dist = max(
            int(np.floor(self.fps / cfg.calibration.freq_max)), 1)

    def _own(self, x, dim: int = 0):
        """This rank's rows of a global stream axis at ``dim`` (all of
        them without a mesh), where it lies: numpy or a tensor."""
        if self.mesh is None:
            return x
        rows = stream_sharding(self.mesh, x.shape[dim])
        return x[(slice(None),) * dim + (rows,)]

    def _ingest(self, frames, dim: int = 0) -> torch.Tensor:
        """This rank's rows of global frames, staged on its device."""
        return ingest_frames(self._own(frames, dim), self.dtype, self.device)

    def _global(self, tree):
        """A named tuple of this rank's per-stream outputs made global
        (one ``all_gather``; as it is without a mesh)."""
        if self.mesh is None:
            return tree
        return type(tree)(*gather_rows(self.mesh, tree))

    def _global_result(self, res, dim: int = 0):
        """A step or scan result with its per-stream outputs made global;
        its state stays this rank's rows."""
        if self.mesh is None:
            return res
        return _gather_result(self.mesh, "streams", res, dim)

    def _locate(self, dev) -> BatchedLocate:
        self.locates += dev.shape[0]
        return self._global(locate_streams(dev, self.fps,
                                           self.cfg.calibration))

    def _warm_start(self, dev):
        self.streaming_starts += 1
        return init_fleet_streaming_from_buffers(dev, self.cfg.calibration)

    def calibrate(self, buffers) -> BatchedLocate:
        """buffers: (S, T, H, W) float in [0, 1], or camera-native uint8
        (widened on the device).  Sets up the batched measurement state."""
        dev = self._ingest(buffers)
        loc = self._locate(dev)
        boxes = loc.boxes.cpu().numpy()
        wmax = int(boxes[:, 2].max(initial=1))
        hmax = int(boxes[:, 3].max(initial=1))
        self.spec = motion.MeasureSpec.for_roi(
            self.cfg, self.frame_hw[0], self.frame_hw[1], wmax, hmax,
            self.fps)
        self.states = init_stream_states(self.spec, self._own(boxes),
                                         self.dtype, self.device)
        self._needs_init = True
        self._rois = boxes.astype(np.int32).copy()
        if self.cfg.streaming_roi:
            self._streaming = self._warm_start(dev)
            self._stream_tick = 0
        return loc

    def recalibrate(self, buffers,
                    stream_mask: Optional[np.ndarray] = None
                    ) -> BatchedLocate:
        """Recalibrate a subset of streams in place (the fleet analog of
        the single monitor's error -> recalibrate cycle).

        Streams where ``stream_mask`` is True (default: all) AND
        calibration found an ROI get a fresh measurement state at the new
        ROI; the others keep their state untouched.  New ROIs are clipped
        to the fleet's crop bucket; if one exceeds it, call ``calibrate``
        instead (which sizes the bucket anew).  When no stream is applied,
        states and rings stay as they are (the JAX package rebuilds them
        to the same values)."""
        assert self.states is not None, "calibrate() first"
        dev = self._ingest(buffers)
        loc = self._locate(dev)
        boxes = loc.boxes.cpu().numpy().copy()
        clipped = (boxes[:, 2] > self.spec.crop_w) | \
                  (boxes[:, 3] > self.spec.crop_h)
        boxes[:, 2] = np.minimum(boxes[:, 2], self.spec.crop_w)
        boxes[:, 3] = np.minimum(boxes[:, 3], self.spec.crop_h)
        apply = loc.found.cpu().numpy()
        if stream_mask is not None:
            apply = apply & np.asarray(stream_mask)
        if (clipped & apply).any():
            logger.warning(
                "recalibrate: ROI(s) for streams %s exceed the fleet crop "
                "bucket (%dx%d) and were clipped; run calibrate() to "
                "rebuild the fleet spec if this persists",
                np.where(clipped & apply)[0].tolist(),
                self.spec.crop_w, self.spec.crop_h)
        installed = BatchedLocate(found=loc.found, boxes=torch.as_tensor(
            boxes, dtype=torch.int32, device=loc.boxes.device))
        if not apply.any():
            return installed

        fresh = init_stream_states(self.spec, self._own(boxes), self.dtype,
                                   self.device)
        sel = torch.as_tensor(self._own(apply), device=self.device)
        self.states = motion.where_streams(sel, fresh, self.states)
        self._needs_init = True   # fresh streams detect corners anew
        if self._rois is not None:
            self._rois[apply] = boxes[apply].astype(np.int32)
        if self.cfg.streaming_roi and self._streaming is not None:
            # Recalibrated streams warm-start their rings from the fresh
            # buffers; the others keep rolling.
            fresh_rings = self._warm_start(dev)
            self._streaming = motion.where_streams(sel, fresh_rings,
                                                    self._streaming)
        return installed

    def step(self, frames, stale=None) -> StreamStepResult:
        """frames: (S, H, W), one new frame per stream (``uint8`` frames
        widen on the device).  ``stale`` (optional (S,) bool, a live
        ``FleetFeeder`` batch's mask) only counts the rows that repeat a
        stream's previous frame into ``stale_rows``: like the JAX package,
        the step advances every stream's t all the same."""
        assert self.states is not None, "calibrate() first"
        with span("fleet.step"):
            with span("fleet.ingest"):
                dev = self._ingest(frames)
            if stale is not None:
                self.stale_rows += int(np.asarray(stale).sum())
            initialized = not self._needs_init
            if self.spec.method == "flow":
                res, self._cache = monitor_step_streams_cached(
                    self._states, self._cache, dev, self.spec, self.coeffs,
                    self.min_dist, self.measure_cfg, initialized=initialized,
                    cache_valid=self._cache is not None)
                self._states = res.state
            else:
                res = monitor_step_streams(self.states, dev, self.spec,
                                           self.coeffs, self.min_dist,
                                           self.measure_cfg,
                                           initialized=initialized)
                self.states = res.state
            res = self._global_result(res)
            self._needs_init = False
            self._streaming_step(dev)
            return res

    def _streaming_step(self, dev) -> None:
        """The per-step half of the streaming-ROI mode: absorb this step's
        (S, H, W) batch into the rings (one K1 call); every
        ``streaming_interval`` steps localize every stream and re-lock the
        drifted ones.  A no-op unless cfg.streaming_roi."""
        if not self.cfg.streaming_roi or self._streaming is None:
            return
        self._stream_tick += 1
        self.streaming_absorbed += 1
        cal = self.cfg.calibration
        if self._stream_tick % self.cfg.streaming_interval:
            self._streaming = absorb_streams(self._streaming, dev, cal)
            return
        with span("fleet.localize", streams=len(self._rois)) as sp:
            self._streaming, loc = update_streams(
                self._streaming, dev, self.fps, cal,
                coarse=self.streaming_coarse)
            loc = self._global(loc)
            # One small read of the boxes each localize interval.
            boxes = torch.stack(
                [loc.found.to(torch.int64), loc.x.to(torch.int64),
                 loc.y.to(torch.int64), loc.w.to(torch.int64),
                 loc.h.to(torch.int64)]).cpu().numpy()
            sp.set(found=int(boxes[0].sum()))
        self._maybe_relock(boxes, dev)

    def _maybe_relock(self, boxes: np.ndarray, dev) -> None:
        """The host's drift decision on the localize's ``boxes`` (found, x,
        y, w, h rows) and the batched masked re-lock.  Each stream keeps
        its calibrated window SIZE, recentred on the localized bbox and
        clipped to the frame, like the single-stream monitor's re-lock.

        A re-lock that moves every tracked point of a stream out of its
        window leaves that stream uninitialized; the next step then runs
        the corner detection (the JAX fleet keeps the hint and never
        detects that stream's corners again)."""
        found, bx, by, bw, bh = boxes
        found = found.astype(bool)
        if not found.any():
            return
        cur = self._rois
        cx = bx + bw / 2.0
        cy = by + bh / 2.0
        drift = np.hypot(cx - (cur[:, 0] + cur[:, 2] / 2.0),
                         cy - (cur[:, 1] + cur[:, 3] / 2.0))
        apply = found & (drift >= self.cfg.streaming_drift_px)
        if not apply.any():
            return
        h_f, w_f = self.frame_hw
        w = cur[:, 2]
        h = cur[:, 3]
        x2 = np.clip(np.round(cx - w / 2.0), 0, w_f - w).astype(np.int32)
        y2 = np.clip(np.round(cy - h / 2.0), 0, h_f - h).astype(np.int32)
        apply &= (x2 != cur[:, 0]) | (y2 != cur[:, 1])
        if not apply.any():
            return
        new_rois = np.stack([x2, y2, w, h], axis=1).astype(np.int32)
        with span("fleet.relock", relocked=int(apply.sum())):
            # The property setter also drops the carried LK cache
            # (re-locked streams re-cropped prev from the current frame).
            self.states = relock_streams(self._states, dev,
                                         self._own(new_rois),
                                         self._own(apply), self.spec)
            # One more small read, after an applied flow re-lock only.
            if self.spec.method == "flow" and \
                    not bool(self._states.initialized.all()):
                self._needs_init = True
        self._rois[apply] = new_rois[apply]
        self.relocks += int(apply.sum())

    def step_many(self, frames) -> StreamBatchResult:
        """frames: (K, S, H, W): K lockstep frames per stream; per-frame
        outputs come back stacked (K, S).  The streaming-ROI mode is
        served by ``step`` only: this batch path does NOT absorb frames
        into the rolling rings (a K-frame gap would break the bandpass's
        contiguous window)."""
        assert self.states is not None, "calibrate() first"
        dev = self._ingest(frames, dim=1)
        initialized = not self._needs_init
        res = monitor_scan_streams(self.states, dev, self.spec, self.coeffs,
                                   self.min_dist, self.measure_cfg,
                                   initialized=initialized)
        self.states = res.state
        res = self._global_result(res, dim=1)
        self._needs_init = False
        return res
