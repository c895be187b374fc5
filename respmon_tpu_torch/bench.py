# Ported from bench.py (the JAX package's benchmark); corpus_traces and REFERENCE_BEST_FPS are copies of bench.py:612-647 and :38.
"""Benchmark of the PyTorch/CUDA port: bench.py's nine measurement modes.

    python -m respmon_tpu_torch.bench [--live | --fleet-live | --multistream
        | --breakdown | --streaming | --recovery [--warm] | --bpm-corpus]
        [--device cpu]

Each mode prints ONE JSON line on stdout, with the keys of bench.py's line
for that mode plus ``"device"``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (``"cpu"`` off the card), since a card set below its power limit runs
slower.  Diagnostics go to stderr.  The modes, in bench.py's dispatch
order: ``--bpm-corpus`` (the float32 BPM estimator against the scipy-f64
golden chain over a synthetic corpus), ``--recovery`` (the monitor through
blackout faults, cold or ``--warm``), ``--streaming`` (the streaming
calibrator's absorb and update), ``--breakdown`` (the fleet step stage by
stage), ``--fleet-live`` (``FleetFeeder`` into ``MultiStreamMonitor``),
``--live`` (``FrameFeeder`` into the live step), ``--multistream`` (64
streams of 1080p in lockstep and the 1080p recalibration unit), and by
default the headline ``evm_calibration_plus_flow_measurement_640x480``
(``evm.locate`` then whole-clip flow measurement, with its upload,
overlap, 300-frame and 16 x 720p fleet segments).

Every mode runs on ``cuda:0`` unless ``--device`` (or ``device=``) says
otherwise, and raises without a CUDA device; ``--device cpu`` runs it on
the CPU, where each mode's keyword arguments (its sizes, defaulting to
bench.py's constants) make it small enough for the tests.  On the card
K1 (``ops/pyramid_cuda.laplacian_band_levels``, ``csrc/pyramid.cu``) runs
in every ``locate``, absorb and warm start, and K2 in K1's 1080p plan; a
kernel that fails to build or launch raises, and so does every segment of
a mode: nothing here falls back or carries on after a failure.

Timing.  bench.py fetches a result to the host to end a timed loop,
because its TPU's ``block_until_ready`` acknowledged dispatch only; here
``_timed`` synchronises the device before and after its loop around
``time.perf_counter``.  Each timed call still does distinct work (a
perturbed input per call), as bench.py's do.  The port's LM fit and LK
read a flag on the host every step or iteration, so "device-resident"
numbers include those round trips.  bench.py's ``_enable_compile_cache``
has no counterpart: nothing is compiled per shape, and the port's kernels
are built once into ``build/`` by ``ops/_build.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.config import CalibrationConfig, MeasureConfig, \
    MonitorConfig

REFERENCE_BEST_FPS = 7.68  # BASELINE.md: best observed session fps
FPS_VIDEO = 10.0
_REPO = Path(__file__).resolve().parent.parent


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync() -> None:
    """Wait for every queued kernel of the card (nothing to wait for on
    the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed(fn, iters):
    """Average seconds a call over ``iters`` calls of ``fn(i)``, the device
    synchronised before the first and after the last.  ``fn`` does
    distinct work per ``i`` (bench.py's rule, kept so each call computes
    anew) and its calls chain on the device as they are made."""
    _sync()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    _sync()
    return (time.perf_counter() - t0) / iters


def _device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _emit(out: dict, dev: torch.device) -> dict:
    """Print a mode's one JSON line with its device and return it."""
    out["device"] = _device_label(dev)
    print(json.dumps(out), flush=True)
    return out


def _release(dev: torch.device) -> None:
    """Free a finished mode's buffers, so modes run one after another in
    one process do not hold each other's memory."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _golden():
    """The golden oracle (``tests/golden/reference_numpy.py``: numpy, scipy
    and the vendored peakutils) from this checkout, loaded by its path
    under a package name of its own (an installed ``tests`` package may
    shadow the checkout's)."""
    name = "_respmon_golden"
    if name not in sys.modules:
        root = _REPO / "tests" / "golden"
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py",
            submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(name + ".reference_numpy")


def _geometry(h: int, w: int) -> str:
    return "1080p" if (h, w) == (1080, 1920) else f"{w}x{h}"


def _to_dev(frames, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames)).to(dev)


def _perturbed(x: torch.Tensor, n: int, first: int = 0):
    """``n`` copies of ``x`` on its device, copy ``i`` shifted by
    ``(first + i) * 1e-6``: distinct work per timed call."""
    return [x + (first + i) * 1e-6 for i in range(n)]


def _u8_variants(base, n, at):
    """``n`` copies of a u8 (T, H, W) buffer, copy ``i`` with one low bit
    flipped at frame 0, (ay, ax + i): inside the located ROI, so each
    copy's result depends on it."""
    ay, ax = at
    out = []
    for i in range(n):
        v = base.copy()
        v[0, ay, ax + i] ^= 1
        out.append(v)
    return out


def _headline_clip(num_frames, height, width):
    from respmon_tpu_torch.io.synthetic import breathing_clip

    # texture_motion: the patch texture translates with breathing, so flow
    # has a strong non-decaying signal (bench.py:111-115).
    return breathing_clip(num_frames=num_frames, height=height, width=width,
                          fps=FPS_VIDEO, bpm=18.0,
                          patch_center=(height // 2, width // 2),
                          patch_size=(height // 6, width * 5 // 32),
                          amplitude=0.12, motion_px=2.0, texture_motion=True)


def _warmup(dev: torch.device) -> None:
    log(f"device: {_device_label(dev)}")
    t0 = time.perf_counter()
    _ = float(torch.ones((), device=dev) + 1.0)
    log(f"transfer warmup: {time.perf_counter() - t0:.3f}s")
    _check_u8_widen(dev)


def _full_rings(states, streams: int, n_ring: int, rng, motion_ring=False):
    """The states with full ``n_ring``-sample signal rings: per-stream
    phase-shifted 0.3 Hz breathing traces, the load a deployed fleet's
    BPM stage carries every step (bench.py:866-880)."""
    dev = states.data.device
    t_axis = np.arange(n_ring, dtype=np.float32) / FPS_VIDEO
    phases = rng.uniform(0, 2 * np.pi, streams).astype(np.float32)
    ring = 0.15 * np.sin(2 * np.pi * 0.3 * t_axis[None, :]
                         + phases[:, None]) \
        + 0.01 * rng.standard_normal((streams, n_ring)).astype(np.float32)
    full = torch.full((streams,), n_ring, dtype=torch.int32, device=dev)
    extra = {}
    if motion_ring:
        extra["motion_xy"] = torch.from_numpy(np.stack(
            [0.02 * np.ones((streams, n_ring), np.float32),
             ring.astype(np.float32)], axis=-1)).to(dev)
    return states._replace(
        data=torch.from_numpy(ring.astype(np.float32)).to(dev),
        t=torch.from_numpy(t_axis).to(dev).expand(streams, n_ring).clone(),
        count=full, motion_count=full.clone(), **extra)


def _fleet_frames(streams, height, width, rng, dtype=np.uint8):
    """Three (S, H, W) frame batches rolled 0, 1, 2 px: real +-1 px
    inter-frame shifts, so the timed steps do genuine LK work."""
    base = rng.random((streams, height, width), np.float32) * 0.2 + 0.4
    if dtype == np.uint8:
        base = np.trunc(base * 255.0).astype(np.uint8)
    return base, [np.roll(base, s, axis=2) for s in (0, 1, 2)]


# ---------------------------------------------------------------------------
# The headline: calibration + flow measurement at 640x480
# ---------------------------------------------------------------------------

def main_headline(include_fleet: bool = True, *, height: int = 480,
                  width: int = 640, measure_len: int = 128, iters: int = 5,
                  config3_frames: int = 300,
                  calibration: CalibrationConfig = None,
                  gaussfit_windows: int = 120, fleet_streams: int = 16,
                  fleet_hw=(720, 1280), fleet_box=(560, 300, 160, 130),
                  fleet_steps: int = 8, device=None):
    """bench.py's default mode: a synthetic clip calibrated (``evm.locate``
    over the 128-frame buffer) and measured frame by frame in flow mode
    (``scan.measure_clip`` with the per-frame BPM trace).  The value is
    frames a second device-resident (the buffers staged on the device);
    ``value_with_upload`` re-uploads camera-native u8 buffers every call.
    Segments: the H2D/compute overlap (pinned buffers copied on a side
    stream while ``locate`` runs), config 3 (a 300-frame 5-level locate),
    the BPM tail against the golden oracle, and the compact 16 x 720p
    fleet.  bench.py's f32 upload path was the fallback of a failed u8
    upload; the port has no fallback, so its uploads are u8."""
    from respmon_tpu_torch.ops import filters
    from respmon_tpu_torch.pipeline import evm, motion, scan

    dev = device_mod.resolve(device)
    _warmup(dev)
    u8_widen_exact = _check_u8_widen(dev)
    gf_parity = _check_gaussfit_parity(gaussfit_windows, device=dev)

    fps_video = FPS_VIDEO
    cfg = MonitorConfig(motion_extraction_method="flow",
                        calibration=calibration or CalibrationConfig())
    cal_len = cfg.calibration.buffer_length
    total = cal_len + 1 + measure_len

    log(f"generating synthetic {width}x{height} clip...")
    clip = _headline_clip(total, height, width)
    # Camera-native u8 bytes feed both ingests (bench.py:120-125).
    clip_u8 = np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)
    clip = (clip_u8.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    cal_u8 = np.ascontiguousarray(clip_u8[:cal_len])
    rest_u8 = np.ascontiguousarray(clip_u8[cal_len + 1:])
    cal = _to_dev(clip[:cal_len], dev)
    rest = _to_dev(clip[cal_len + 1:], dev)
    del clip

    t0 = time.perf_counter()
    loc = evm.locate(cal, fps_video, cfg.calibration)
    if not bool(loc.found):
        raise RuntimeError("headline: locate found no ROI")
    log(f"locate first run: {time.perf_counter() - t0:.2f}s")
    x, y, w, h = int(loc.x), int(loc.y), int(loc.w), int(loc.h)
    log(f"roi: {(x, y, w, h)}")

    spec = motion.MeasureSpec.for_roi(cfg, height, width, w, h, fps_video)
    coeffs = filters.design_butter_lowpass(0.5, fps_video,
                                           cfg.measure.filter_order)
    roi = (x, y, w, h)
    t0 = time.perf_counter()
    res = scan.measure_clip(rest, roi, spec, coeffs, 10, cfg.measure)
    has = res.has_bpm.cpu().numpy()
    log(f"measure first run: {time.perf_counter() - t0:.2f}s")
    bpm_tail_median = bpm_oracle_delta = None
    if has.any():
        tail = res.bpm.cpu().numpy()[has][-10:]
        bpm_tail_median = float(np.median(tail))
        # The device's own sample trace through the golden chain (scipy
        # filtfilt + peakutils + curve_fit), window by window.
        golden = _golden()
        samples_np = res.samples.cpu().numpy()
        t_np = res.t.cpu().numpy()
        n_ring = cfg.measure.buffer_length
        total_t = len(samples_np)
        oracle_tail = []
        for i in range(total_t - 10, total_t):
            lo = max(0, i + 1 - n_ring)
            ob, _, _, _ = golden.measure_bpm(samples_np[lo:i + 1],
                                             t_np[lo:i + 1], fps_video)
            oracle_tail.append(ob if ob is not None else np.nan)
        oracle_med = float(np.nanmedian(np.asarray(oracle_tail)))
        bpm_oracle_delta = abs(bpm_tail_median - oracle_med)
        log(f"BPM tail median: {bpm_tail_median:.2f} (true 18.0); golden "
            f"oracle on the same trace: {oracle_med:.2f}; |device - "
            f"oracle| = {bpm_oracle_delta:.3f}")

    # --- timed: device-resident, each call on its own perturbed copy.
    cal_v = _perturbed(cal, iters)
    rest_v = _perturbed(rest, iters)
    t_cal = _timed(lambda i: evm.locate(
        cal_v[i], fps_video, cfg.calibration).heatmap_u8, iters)
    t_meas = _timed(lambda i: scan.measure_clip(
        rest_v[i], roi, spec, coeffs, 10, cfg.measure).samples, iters)
    del cal_v, rest_v

    # --- timed: u8 upload every call (the cold client's end to end).
    # The two extra trailing variants warm up and probe.
    cy, cx = y + h // 2, x + w // 2
    cal_u8_v = _u8_variants(cal_u8, iters + 2, (cy, cx))
    rest_u8_v = _u8_variants(rest_u8, iters + 2, (cy, cx))

    def run_cal_up(i):
        return evm.locate(_to_dev(cal_u8_v[i], dev), fps_video,
                          cfg.calibration).heatmap_u8

    def run_meas_up(i):
        return scan.measure_clip(_to_dev(rest_u8_v[i], dev), roi, spec,
                                 coeffs, 10, cfg.measure).samples

    # bench.py also runs one upload measure_clip first, to compile its
    # transfer; eager PyTorch compiles nothing, and the probe below is
    # the u8 locate's first run.
    run_cal_up(iters)
    _sync()
    up_probe0 = time.perf_counter()
    run_cal_up(iters + 1)
    _sync()
    up_probe = time.perf_counter() - up_probe0
    up_iters = iters if up_probe < 1.0 else 2
    t_cal_up = _timed(run_cal_up, up_iters)
    t_meas_up = _timed(run_meas_up, up_iters)
    del rest_u8_v

    overlap = _overlap_segment(cal_u8, (cy, cx), up_iters, t_cal, dev,
                               lambda v: evm.locate(v, fps_video,
                                                    cfg.calibration))

    config3 = _config3_segment(cfg, config3_frames, height, width, iters,
                               dev)

    frames = cal_len + measure_len
    wall = t_cal + t_meas
    wall_up = t_cal_up + t_meas_up
    fps_chip = frames / wall
    fps_chip_up = frames / wall_up
    realtime_x = (total / fps_video) / wall
    log(f"calibration: {t_cal*1e3:.1f} ms for {cal_len} frames "
        f"({t_cal_up*1e3:.1f} ms incl. upload)")
    log(f"measurement: {t_meas*1e3:.1f} ms for {measure_len} frames "
        f"({t_meas_up*1e3:.1f} ms incl. upload)")
    log(f"end-to-end: {fps_chip:.1f} fps device-resident "
        f"({realtime_x:.1f}x real-time); {fps_chip_up:.1f} fps incl. upload")

    out = {
        "metric": "evm_calibration_plus_flow_measurement_"
                  f"{_geometry(height, width)}",
        "value": round(fps_chip, 1),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps_chip / REFERENCE_BEST_FPS, 1),
        "value_with_upload": round(fps_chip_up, 1),
        "upload_ingest": "uint8",
        "u8_widen_exact_on_device": u8_widen_exact,
        # Upload-inclusive throughput if the same u8 buffers rode a
        # 16 GB/s PCIe-class link.
        "value_with_upload_pcie16GBps_estimate": round(
            frames / (wall + (cal_u8.nbytes + rest_u8.nbytes) / 16e9), 1),
        "h2d_overlap": overlap,
        **config3,
    }
    ar, an, _, _ = gf_parity
    out["gaussfit_device_agreement_realistic"] = round(ar, 4)
    out["gaussfit_device_agreement_noise"] = round(an, 4)
    if bpm_tail_median is not None:
        out["bpm_tail_median"] = round(bpm_tail_median, 3)
        out["bpm_true"] = 18.0
        out["bpm_oracle_delta"] = round(bpm_oracle_delta, 4)

    del cal, rest, res
    _release(dev)
    if include_fleet:
        fh, fw = fleet_hw
        out.update(_fleet_segment(fleet_streams, fh, fw, fleet_box,
                                  fps_video, steps=fleet_steps, device=dev))
    out = _emit(out, dev)
    _release(dev)
    return out


def _overlap_segment(cal_u8, at, up_iters, t_cal, dev, locate):
    """Double-buffered prefetch (bench.py:268-328): the upload of buffer
    k + 1 is issued, then ``locate`` runs on buffer k.  On the card the
    upload is a ``non_blocking`` copy from a pinned host buffer on a side
    stream, and ``locate``'s stream waits for it on an event before the
    next call uses it; ``overlap_efficiency`` is how much of
    min(upload, compute) was hidden."""
    cy, cx = at
    up_only_iters = max(up_iters, 2)
    # Byte-variant families of their own, apart from the timed locates'.
    up_only_v = _u8_variants(cal_u8, up_only_iters + 1, (cy + 2, cx))
    ovl_v = _u8_variants(cal_u8, up_iters + 2, (cy + 1, cx))
    cuda = dev.type == "cuda"

    def host(v):
        t = torch.from_numpy(v)
        return t.pin_memory() if cuda else t

    up_only_h = [host(v) for v in up_only_v]
    ovl_h = [host(v) for v in ovl_v]
    side = torch.cuda.Stream(dev) if cuda else None

    def run_upload_only(i):
        d = up_only_h[i].to(dev, non_blocking=True)
        return d[0, 0, :2]

    run_upload_only(up_only_iters)
    t_up_only = _timed(run_upload_only, up_only_iters)

    def upload(h):
        """Start the copy of ``h``; returns the tensor and the event that
        marks its end (None on the CPU, where the copy is done)."""
        if not cuda:
            return h.to(dev), None
        with torch.cuda.stream(side):
            d = h.to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        return d, ev

    def ready(pair):
        d, ev = pair
        if ev is not None:
            main = torch.cuda.current_stream(dev)
            main.wait_event(ev)
            d.record_stream(main)
        return d

    roll = {"cur": ready(upload(ovl_h[0]))}

    def run_overlapped(i):
        nxt = upload(ovl_h[i + 1])
        out = locate(roll["cur"]).heatmap_u8
        roll["cur"] = ready(nxt)
        return out

    t_ovl = _timed(run_overlapped, up_iters)
    hidden = (t_up_only + t_cal) - t_ovl
    denom = min(t_up_only, t_cal)
    eff = hidden / denom if denom > 0 else 0.0
    mb = cal_u8.nbytes / 1e6
    log(f"H2D overlap: upload-only {t_up_only*1e3:.2f} ms, compute "
        f"{t_cal*1e3:.2f} ms, overlapped {t_ovl*1e3:.2f} ms (efficiency "
        f"{eff:.0%}, {mb/t_up_only:.0f} MB/s)")
    return {
        "upload_only_ms": round(t_up_only * 1e3, 1),
        "compute_only_ms": round(t_cal * 1e3, 1),
        "overlapped_ms": round(t_ovl * 1e3, 1),
        "overlap_efficiency": round(eff, 3),
        "h2d_MBps": round(mb / t_up_only, 1),
        # The same u8 buffer over a 16 GB/s PCIe-class link.
        "pcie16GBps_upload_ms": round(mb / 16e3 * 1e3, 2),
    }


def _config3_segment(cfg, frames, height, width, iters, dev):
    """BASELINE config 3 (bench.py:329-365): a 5-level pyramid and the
    temporal-FFT localization over a 300-frame buffer; skip 2 keeps the
    default's two kept levels."""
    from respmon_tpu_torch.pipeline import evm

    cfg3 = dataclasses.replace(cfg.calibration, buffer_length=frames,
                               pyramid_levels=5, skip_levels_at_top=2)
    c3 = _to_dev(_headline_clip(frames, height, width), dev)
    t0 = time.perf_counter()
    r3 = evm.locate(c3, FPS_VIDEO, cfg3)
    found = bool(r3.found)
    log(f"config3 locate first run: {time.perf_counter() - t0:.2f}s "
        f"(found={found})")
    c3v = _perturbed(c3, iters, first=1)
    t_c3 = _timed(lambda i: evm.locate(c3v[i], FPS_VIDEO, cfg3).heatmap_u8,
                  iters)
    realtime = (frames / FPS_VIDEO) / t_c3
    log(f"config3 ({frames}-frame 5-level locate): {t_c3*1e3:.2f} ms "
        f"({realtime:.1f}x real-time)")
    return {
        "config3_locate_ms": round(t_c3 * 1e3, 1),
        "config3_geometry": f"{frames}f x {height}x{width}, 5-level "
                            "pyramid, skip 2",
        "config3_found": found,
        "config3_realtime_x": round(realtime, 1),
    }


def _check_u8_widen(dev=None):
    """The device's u8 -> f32 widen against the host chain over all 256
    bytes, bit for bit."""
    from respmon_tpu_torch.ops.dtype import uint8_to_float

    dev = device_mod.resolve(dev)
    b = np.arange(256, dtype=np.uint8)
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got = uint8_to_float(torch.from_numpy(b).to(dev)).cpu().numpy()
    ok = bool(np.array_equal(got.view(np.uint32), want.view(np.uint32)))
    log(f"device u8 widen bit-parity vs host chain: "
        f"{'EXACT (256/256)' if ok else 'MISMATCH'}")
    if not ok:
        bad = np.nonzero(got.view(np.uint32) != want.view(np.uint32))[0]
        log(f"  differing bytes: {bad[:12].tolist()} ({bad.size}/256 total)")
    return ok


def _fleet_segment(streams: int = 16, H: int = 720, W: int = 1280,
                   box=(560, 300, 160, 130), fps_video: float = 10.0,
                   steps: int = 8, device=None):
    """The compact fleet metric of the headline (bench.py:448-526): S
    streams of H x W with fixed ROIs (the step's cost does not depend on
    how the box was found), device-resident u8 frames with +-1 px shifts,
    full 128-sample signal rings, ``steps`` steps timed in a row."""
    dev = device_mod.resolve(device)
    cfg = MonitorConfig(motion_extraction_method="flow")
    log(f"fleet segment: {streams}x{H}p")
    mon, _ = _fleet_at_box(cfg, H, W, box, streams, dev, fps_video)

    rng = np.random.default_rng(0)
    _, frames_host = _fleet_frames(streams, H, W, rng)
    frames_v = [_to_dev(f, dev) for f in frames_host]
    t0 = time.perf_counter()
    mon.step(frames_v[0]).samples.cpu()    # corner detection
    mon.step(frames_v[1]).samples.cpu()    # steady state
    log(f"fleet step first runs: {time.perf_counter() - t0:.2f}s")

    def run_step(i):
        return mon.step(frames_v[i % 3]).samples

    for i in range(3):
        run_step(i).cpu()
    mon.states = _full_rings(mon.states, streams, cfg.measure.buffer_length,
                             rng)
    run_step(0).cpu()   # rebuilds the LK cache the assignment dropped
    run_step(1).cpu()
    t_step = _timed(run_step, steps)
    sfps = streams / t_step
    margin = (1.0 / fps_video) / t_step
    log(f"fleet segment: {t_step*1e3:.1f} ms/step -> {sfps:.1f} "
        f"stream-frames/s, {margin:.3f}x margin at 10 fps")
    return {
        "fleet_streams": streams,
        "fleet_geometry": f"{H}x{W}",
        "fleet_step_ms": round(t_step * 1e3, 2),
        "fleet_sfps": round(sfps, 1),
        "fleet_realtime_margin_at_10fps": round(margin, 2),
    }


def _check_gaussfit_parity(n_windows: int = 120, device=None):
    """Accept/reject agreement of the device LM Gaussian fit with scipy's
    ``curve_fit`` at the bench's geometry (bench.py:529-609): windows of
    4-20 samples at 10 fps around a genuine peak, an oscillation fragment
    or pure noise.  Returns (agreement_realistic, agreement_noise,
    n_realistic, n_noise); pure-noise windows, whose decisions are near
    arbitrary, are reported apart."""
    from scipy.optimize import curve_fit

    from respmon_tpu_torch.ops import gaussfit

    dev = device_mod.resolve(device)
    rng = np.random.default_rng(2024)
    fps = 10.0
    pad = 32
    wins = []
    kinds = []
    for trial in range(n_windows):
        n = int(rng.integers(4, 21))
        t0 = rng.uniform(0, 12)
        t = t0 + np.arange(n) / fps
        kind = trial % 3
        if kind == 0:    # genuine peak (sigma swept across the cutoff)
            sig = rng.uniform(0.1, 1.2)
            c = t0 + n / (2 * fps)
            y = rng.uniform(0.2, 3) * np.exp(-((t - c) ** 2)
                                             / (2 * sig ** 2)) \
                + rng.normal(0, 0.05, n)
        elif kind == 1:  # oscillation fragment (filtered-signal look)
            y = np.sin(2 * np.pi * rng.uniform(0.2, 0.45) * t) \
                + rng.normal(0, 0.1, n)
        else:            # pure noise
            y = rng.normal(0, 1, n)
        wins.append((t, y))
        kinds.append(kind)

    T = np.zeros((n_windows, pad), np.float32)
    Y = np.zeros((n_windows, pad), np.float32)
    M = np.zeros((n_windows, pad), bool)
    for i, (t, y) in enumerate(wins):
        T[i, :len(t)] = t
        Y[i, :len(y)] = y
        M[i, :len(t)] = True
    res = gaussfit.gaussian_fit_batch(_to_dev(T, dev), _to_dev(Y, dev),
                                      _to_dev(M, dev))
    got_dev = res.dev.cpu().numpy()
    got_conv = res.converged.cpu().numpy()

    def gauss(x, a, c, s):
        return a * np.exp(-((x - c) ** 2) / (2 * s ** 2))

    agree = [0, 0]
    total = [0, 0]
    for i, (t, y) in enumerate(wins):
        # The oracle's rule: a fit curve_fit cannot make is a rejection.
        try:
            p, _ = curve_fit(gauss, t, y,
                             p0=[y.max(), t[0], (t[1] - t[0]) * 5])
            want = p[2] < 10.0
        except (RuntimeError, TypeError):
            want = False
        got = bool(got_conv[i]) and float(got_dev[i]) < 10.0
        b = 1 if kinds[i] == 2 else 0
        total[b] += 1
        agree[b] += int(got == want)
    ar = agree[0] / max(total[0], 1)
    an = agree[1] / max(total[1], 1)
    log(f"device gaussfit accept/reject vs scipy: realistic "
        f"{agree[0]}/{total[0]} ({ar:.1%}), pure-noise {agree[1]}/"
        f"{total[1]} ({an:.1%})")
    return ar, an, total[0], total[1]


# ---------------------------------------------------------------------------
# --bpm-corpus
# ---------------------------------------------------------------------------

def corpus_traces(n_traces: int, length: int = 192):
    """Synthetic motion-trace corpus across BPM/noise/fps/fault regimes
    (VERDICT r4 #3).  Returns a list of dicts with float64 ``y``/``t``."""
    kinds = ("clean", "drift", "spike", "step")
    bpms = (8.0, 12.0, 16.0, 18.0, 22.0, 26.0, 30.0)
    noises = (0.02, 0.05, 0.1, 0.2, 0.4)
    fpss = (5.01, 7.68, 10.0)
    out = []
    i = 0
    while len(out) < n_traces:
        bpm = bpms[i % len(bpms)]
        noise = noises[(i // len(bpms)) % len(noises)]
        fps = fpss[(i // (len(bpms) * len(noises))) % len(fpss)]
        kind = kinds[i % len(kinds)]
        rng = np.random.default_rng(1000 + i)
        t = np.arange(length) / fps
        f = bpm / 60.0
        if kind == "step":        # rate change mid-trace (subject settles)
            f2 = f * rng.uniform(0.6, 1.5)
            phase = np.where(t < t[length // 2],
                             2 * np.pi * f * t,
                             2 * np.pi * f * t[length // 2]
                             + 2 * np.pi * f2 * (t - t[length // 2]))
            y = np.sin(phase)
        else:
            y = np.sin(2 * np.pi * f * t)
        if kind == "drift":       # amplitude decay (weakening signal)
            y = y * np.linspace(1.0, 0.25, length)
        if kind == "spike":       # transient occlusion-like bursts
            for s in rng.integers(20, length - 4, size=3):
                y[s:s + 3] += rng.uniform(2.0, 5.0)
        y = y + noise * rng.standard_normal(length)
        out.append({"y": y, "t": t, "fps": fps, "bpm": bpm,
                    "noise": noise, "kind": kind})
        i += 1
    return out


def main_bpm_corpus(n_traces: int = 120, out_path: str = None, *,
                    device=None):
    """End-to-end BPM decision envelope: the device float32 estimator
    (``pipeline/bpm.estimate_bpm``, every sliding ring window of a trace
    as one batch) against the scipy-f64 golden chain (filtfilt +
    peakutils + curve_fit), window by window.  Reports the |dBPM|
    distribution where both chains give a BPM, and the has-BPM agreement;
    ``out_path`` also gets the JSON line."""
    from respmon_tpu_torch.ops import filters
    from respmon_tpu_torch.pipeline import bpm as bpm_mod

    dev = device_mod.resolve(device)
    golden = _golden()
    cfg = MeasureConfig()
    n_ring = cfg.buffer_length
    traces = corpus_traces(n_traces)
    log(f"bpm corpus: {len(traces)} traces x "
        f"{len(traces[0]['y']) - cfg.initialization_length} steps")

    deltas = []
    per_trace = []
    n_steps = n_both = n_mismatch = 0
    by_kind = {}
    t_dev = t_orc = 0.0
    for ti, tr in enumerate(traces):
        y, t, fps = tr["y"], tr["t"], tr["fps"]
        length = len(y)
        steps = list(range(cfg.initialization_length + 1, length + 1))
        k = len(steps)
        D = np.zeros((k, n_ring), np.float32)
        T = np.zeros((k, n_ring), np.float32)
        C = np.zeros((k,), np.int32)
        for j, c in enumerate(steps):
            m = min(c, n_ring)
            D[j, n_ring - m:] = y[c - m:c]
            T[j, n_ring - m:] = t[c - m:c]
            C[j] = m
        coeffs = filters.design_butter_lowpass(0.5, fps, cfg.filter_order)
        min_dist = max(int(np.floor(fps / 1.0)), 1)
        t0 = time.perf_counter()
        res = bpm_mod.estimate_bpm(_to_dev(D, dev), _to_dev(T, dev),
                                   _to_dev(C, dev), coeffs, min_dist, cfg)
        dev_has = res.has_bpm.cpu().numpy()
        dev_bpm = res.bpm.cpu().numpy()
        t_dev += time.perf_counter() - t0

        t0 = time.perf_counter()
        tr_deltas = []
        for j, c in enumerate(steps):
            m = min(c, n_ring)
            ob, _, _, _ = golden.measure_bpm(y[c - m:c], t[c - m:c], fps)
            orc_has = ob is not None
            n_steps += 1
            if orc_has != bool(dev_has[j]):
                n_mismatch += 1
            elif orc_has:
                n_both += 1
                d = abs(float(dev_bpm[j]) - ob)
                tr_deltas.append(d)
                deltas.append(d)
                by_kind.setdefault(tr["kind"], []).append(d)
        t_orc += time.perf_counter() - t0
        per_trace.append(max(tr_deltas) if tr_deltas else 0.0)
        if (ti + 1) % 20 == 0:
            log(f"  {ti + 1}/{len(traces)} traces "
                f"(dev {t_dev:.1f}s oracle {t_orc:.1f}s)")

    deltas = np.asarray(deltas)
    per_trace = np.asarray(per_trace)
    stats = {
        "metric": "bpm_corpus_max_abs_delta_vs_scipy_f64",
        "value": round(float(deltas.max()) if deltas.size else 0.0, 4),
        "unit": "bpm",
        "vs_baseline": 0.5,   # BASELINE bar: +-0.5 BPM
        "n_traces": len(traces),
        "n_steps": n_steps,
        "n_both_have_bpm": n_both,
        "has_bpm_mismatch_rate": round(n_mismatch / max(n_steps, 1), 5),
        "delta_p50": round(float(np.percentile(deltas, 50)), 5),
        "delta_p99": round(float(np.percentile(deltas, 99)), 5),
        "delta_p999": round(float(np.percentile(deltas, 99.9)), 5),
        "traces_within_half_bpm": int((per_trace <= 0.5).sum()),
        "per_kind_max": {kk: round(float(np.max(v)), 4)
                         for kk, v in sorted(by_kind.items())},
        "per_kind_p99": {kk: round(float(np.percentile(v, 99)), 4)
                         for kk, v in sorted(by_kind.items())},
    }
    log(f"device estimator {t_dev:.2f}s, oracle {t_orc:.2f}s")
    log(json.dumps(stats, indent=2))
    stats["device"] = _device_label(dev)
    if out_path:
        with open(out_path, "w") as f:
            f.write(json.dumps(stats) + "\n")
    print(json.dumps(stats), flush=True)
    _release(dev)
    return stats


# ---------------------------------------------------------------------------
# --multistream
# ---------------------------------------------------------------------------

def _fleet_at_box(cfg, height, width, box, streams, dev, fps=FPS_VIDEO):
    """A fleet of ``streams`` at one fixed ROI, its spec sized to that
    box (the steps' cost does not depend on how the box was found)."""
    from respmon_tpu_torch.parallel import streams as fleet
    from respmon_tpu_torch.pipeline import motion

    x, y, w, h = box
    mon = fleet.MultiStreamMonitor(cfg, None, (height, width), fps,
                                   device=dev)
    boxes = np.tile(np.asarray([[x, y, w, h]], np.int32), (streams, 1))
    mon.spec = motion.MeasureSpec.for_roi(cfg, height, width, w, h, fps)
    mon.states = fleet.init_stream_states(mon.spec, boxes, device=dev)
    log(f"crop bucket {mon.spec.crop_h}x{mon.spec.crop_w}, lk_sample="
        f"{fleet.fleet_lk_sample(cfg, mon.spec.crop_h, mon.spec.crop_w, streams)}")
    return mon, boxes


def _locate_1080p(cfg, height, width, dev):
    """The 1080p calibration buffer (bench.py:793-799) on the device and
    its ``locate``."""
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm

    log(f"generating {height}x{width} calibration buffer...")
    cal = breathing_clip(num_frames=cfg.calibration.buffer_length,
                         height=height, width=width, fps=FPS_VIDEO, bpm=18.0,
                         patch_center=(height // 2, width // 2),
                         patch_size=(height // 6, width * 11 // 96),
                         amplitude=0.12, motion_px=3.0)
    cal_dev = _to_dev(cal.astype(np.float32, copy=False), dev)
    del cal
    t0 = time.perf_counter()
    loc = evm.locate(cal_dev, FPS_VIDEO, cfg.calibration)
    if not bool(loc.found):
        raise RuntimeError(f"{height}x{width} locate found no ROI")
    box = (int(loc.x), int(loc.y), int(loc.w), int(loc.h))
    log(f"{height}x{width} locate first run: "
        f"{time.perf_counter() - t0:.2f}s, roi {box}")
    return cal_dev, box


def main_multistream(streams: int = 64, fleet_refine: bool = False, *,
                     height: int = 1080, width: int = 1920,
                     calibration: CalibrationConfig = None,
                     timed_steps: int = 10, sync_steps: int = 6,
                     streaming_interval: int = None, batch_iters: int = 6,
                     device=None):
    """BASELINE.md config 5: 64 streams of 1080p in lockstep on one card
    (``MultiStreamMonitor`` on the 1080p locate's box, device-resident u8
    frames, full signal rings), plus the single-stream 1080p recalibration
    unit (K1's 1080p plan, whose first level is K2), the fleet in
    streaming-ROI mode (absorb every step, a coarse update every
    ``streaming_interval``, default the config's) and K-frame
    ``step_many`` batches.  ``fleet_refine`` runs the accuracy tier
    (``fleet_f64_refine``: the f64 refit of wild fits in every step)."""
    from respmon_tpu_torch.parallel import streams as fleet
    from respmon_tpu_torch.pipeline import evm

    dev = device_mod.resolve(device)
    _warmup(dev)
    fps_video = FPS_VIDEO
    H, W = height, width
    cfg = MonitorConfig(motion_extraction_method="flow",
                        fleet_f64_refine=fleet_refine,
                        calibration=calibration or CalibrationConfig())

    # --- single-stream 1080p recalibration unit
    cal_dev, box = _locate_1080p(cfg, H, W, dev)

    def locate_heat(i):
        return evm.locate(cal_dev + 1e-6 * (i + 1), fps_video,
                          cfg.calibration).heatmap_u8

    locate_heat(-1)
    t_cal = _timed(locate_heat, 3)
    log(f"{_geometry(H, W)} recalibration unit: {t_cal*1e3:.2f} ms "
        f"({cfg.calibration.buffer_length / fps_video / t_cal:.0f}x "
        f"real-time)")
    del cal_dev
    _release(dev)

    # --- the lockstep fleet
    log(f"building {streams}-stream fleet state...")
    mon, boxes = _fleet_at_box(cfg, H, W, box, streams, dev)
    rng = np.random.default_rng(0)
    _, frames_host = _fleet_frames(streams, H, W, rng)
    frames_v = [_to_dev(f, dev) for f in frames_host]
    del frames_host
    t0 = time.perf_counter()
    mon.step(frames_v[0]).samples.cpu()   # corner detection
    mon.step(frames_v[1]).samples.cpu()   # steady state
    log(f"fleet step first runs: {time.perf_counter() - t0:.2f}s")

    def run_step(i):
        return mon.step(frames_v[i % 3]).samples

    for i in range(3):
        run_step(i).cpu()
    n_ring = cfg.measure.buffer_length
    mon.states = _full_rings(mon.states, streams, n_ring, rng)
    ring_states = mon.states
    run_step(0).cpu()   # rebuilds the LK cache the assignment dropped
    run_step(1).cpu()
    # Steps chain on the device state; one synchronise at the end.
    t_step = _timed(run_step, timed_steps)
    sfps = streams / t_step
    margin = (1.0 / fps_video) / t_step
    log(f"{streams}-stream {_geometry(H, W)} lockstep step: "
        f"{t_step*1e3:.1f} ms -> {sfps:.1f} stream-frames/s, "
        f"{margin:.3f}x real-time margin at {fps_video:.0f} fps")
    # A host read of every step's samples, for contrast.
    t0 = time.perf_counter()
    for i in range(sync_steps):
        run_step(i + 1).cpu()
    t_step_sync = (time.perf_counter() - t0) / sync_steps
    log(f"  (fetch-every-step: {t_step_sync*1e3:.1f} ms/step)")

    # --- the fleet in streaming-ROI mode: an absorb every step, a coarse
    # localize every interval and the drift re-lock.
    interval = streaming_interval or cfg.streaming_interval
    cfg_s = dataclasses.replace(cfg, streaming_roi=True,
                                streaming_interval=interval)
    mon_s = fleet.MultiStreamMonitor(cfg_s, None, (H, W), fps_video,
                                     device=dev)
    mon_s.spec = mon.spec
    mon_s.states = ring_states
    mon_s._rois = boxes.copy()
    mon_s._streaming = fleet.init_fleet_streaming((H, W), cfg.calibration,
                                                  streams, device=dev)
    t0 = time.perf_counter()
    for i in range(interval + 2):   # covers the absorb AND update steps
        r = mon_s.step(frames_v[i % 3])
    r.samples.cpu()
    log(f"fleet streaming warm-up: {time.perf_counter() - t0:.2f}s")
    t_step_s = _timed(lambda i: mon_s.step(frames_v[i % 3]).samples,
                      2 * interval)
    over_ms = (t_step_s - t_step) * 1e3
    log(f"fleet streaming-ROI overhead: step {t_step_s*1e3:.1f} ms vs "
        f"{t_step*1e3:.1f} base -> {over_ms:+.2f} ms/step amortized "
        f"(interval {interval})")
    extra = {
        "streaming_step_ms": round(t_step_s * 1e3, 2),
        "streaming_overhead_ms_per_step": round(over_ms, 2),
        "streaming_overhead_ms_per_stream_frame": round(over_ms / streams, 4),
        "streaming_interval": interval,
    }
    del mon_s, r

    out = {
        "metric": f"multistream_{streams}x{_geometry(H, W)}_flow_monitoring"
                  + ("_f64refine" if fleet_refine else ""),
        "value": round(sfps, 1),
        "unit": "stream-frames/sec/chip",
        "vs_baseline": round(sfps / REFERENCE_BEST_FPS, 1),
        "step_ms": round(t_step * 1e3, 2),
        "step_ms_sync_fetch": round(t_step_sync * 1e3, 2),
        "realtime_margin_at_10fps": round(margin, 2),
    }
    # K-frame lockstep batches (step_many), skipped where two staged
    # (K, S, H, W) batches would crowd the step's own memory.
    K = 4
    batch_bytes = 2 * K * streams * H * W * frames_v[0].element_size()
    if batch_bytes > (6 << 30):
        log(f"skipping step_many: {K}-frame batches for {streams} streams "
            f"need {batch_bytes / 2**30:.1f} GB staged")
    else:
        batch_v = [torch.stack([frames_v[(i + k) % 3] for k in range(K)])
                   for i in range(2)]
        t0 = time.perf_counter()
        mon.step_many(batch_v[0]).samples.cpu()
        log(f"step_many first run: {time.perf_counter() - t0:.2f}s")
        t_batch = _timed(lambda i: mon.step_many(batch_v[i % 2]).samples,
                         batch_iters)
        sfps_b = streams * K / t_batch
        margin_b = (K / fps_video) / t_batch
        log(f"{streams}-stream {K}-frame batch: {t_batch*1e3:.1f} ms "
            f"({t_batch/K*1e3:.1f} ms/frame) -> {sfps_b:.1f} "
            f"stream-frames/s, {margin_b:.3f}x real-time margin")
        out[f"batch{K}_ms_per_frame"] = round(t_batch / K * 1e3, 2)
        out[f"batch{K}_realtime_margin"] = round(margin_b, 2)
        del batch_v
    out["recalibration_1080p_ms"] = round(t_cal * 1e3, 1)
    out.update(extra)
    del mon, frames_v, ring_states
    out = _emit(out, dev)
    _release(dev)
    return out


# ---------------------------------------------------------------------------
# --breakdown
# ---------------------------------------------------------------------------

def main_fleet_breakdown(streams: int = 64, *, height: int = 1080,
                         width: int = 1920,
                         calibration: CalibrationConfig = None,
                         calls: int = 8, windows: int = 4,
                         production_steps: int = 10, device=None):
    """The fleet step of ``--multistream`` split into its stages, each
    timed on its own: ``calls`` calls chained on the device (call i + 1's
    input depends on call i's result), one synchronise at the end of a
    window, the least of ``windows`` windows.  Full signal rings, as a
    deployed fleet's.  The stages run the fleet step's own functions:
    the crop, the prev- and next-role LK builds
    (``lk.precompute_frame_inputs``), LK in full, ``measure_step_batch``,
    filtfilt, the peak candidates, the batched LM fit, ``estimate_bpm``,
    the full fused step on full and on 3-sample rings, and
    ``MultiStreamMonitor.step`` itself with float and u8 frames.  The
    "floor" stages time one trivial launch, and a pass over every state
    tensor.  Eager PyTorch computes every output, so "FULL + state
    materialization" differs from "FULL" only by the host's spread."""
    from respmon_tpu_torch.ops import filters, gaussfit, lk
    from respmon_tpu_torch.ops import peaks as peaks_mod
    from respmon_tpu_torch.pipeline import bpm as bpm_mod
    from respmon_tpu_torch.pipeline import motion

    dev = device_mod.resolve(device)
    _warmup(dev)
    H, W = height, width
    cfg = MonitorConfig(motion_extraction_method="flow",
                        calibration=calibration or CalibrationConfig())
    cal_dev, box = _locate_1080p(cfg, H, W, dev)
    del cal_dev
    _release(dev)
    mon, _ = _fleet_at_box(cfg, H, W, box, streams, dev)
    spec = mon.spec
    # The production fleet's estimate: no f64 refit unless
    # fleet_f64_refine (the fleet's own measure_cfg).
    mcfg = mon.measure_cfg

    rng = np.random.default_rng(0)
    frames_np, frames_host = _fleet_frames(streams, H, W, rng,
                                           dtype=np.float32)
    frames_v = [_to_dev(f, dev) for f in frames_host]
    del frames_host
    for i in range(3):   # corner detection, then tracking settles
        mon.step(frames_v[i % 3]).samples.cpu()
    states = _full_rings(mon.states, streams, mcfg.buffer_length, rng,
                         motion_ring=True)
    mon.states = states
    coeffs, min_dist = mon.coeffs, mon.min_dist

    stage_ms = {}

    def time_stage(name, body, payload):
        """Least, over ``windows`` windows, of a window's ms a call:
        ``calls`` calls of ``body(eps, payload)``, each call's eps a
        function of the previous call's device result, one synchronise
        at the end of the window, after one untimed call (bench.py makes
        two: a compile and a settle; eager PyTorch compiles nothing)."""
        def scalar(out):
            return out[0] if isinstance(out, tuple) else out

        scalar(body(torch.zeros((), device=dev), payload))
        best = float("inf")
        k = 0
        for _ in range(windows):
            eps = torch.full((), 2e-6 + 1e-9 * k, device=dev)
            _sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                k += 1
                o = scalar(body(eps, payload))
                eps = torch.nan_to_num(o.to(torch.float32)) * 1e-30 \
                    + 1e-6 * (k + 3)
            _sync()
            best = min(best, (time.perf_counter() - t0) / calls * 1e3)
        stage_ms[name] = best
        log(f"  {name:36s} {best:8.3f} ms")
        return best

    log(f"--- per-stage chained device times ({streams} streams) ---")
    time_stage("floor (trivial program)",
               lambda eps, x: torch.sum(x + eps),
               torch.zeros((8,), device=dev))

    def crop_u8(fr):
        crops, mask = motion._crop_batch(fr, states.roi, spec)
        return motion._to_u8_scale(torch.where(mask, crops, 0.0))

    time_stage("crop+u8 (from 1080p frames)",
               lambda eps, fr: torch.sum(crop_u8(fr + eps)), frames_v[0])
    crops_a = crop_u8(frames_v[1])
    crops_b = crop_u8(frames_v[2])

    win = spec.lk.win_size[0]
    max_level = spec.lk.max_level
    shapes = tuple(lk.level_geometry(spec.crop_h, spec.crop_w, max_level))

    def prev_build_body(eps, crops):
        ins = lk.precompute_frame_inputs(crops + eps, win, max_level)
        return sum(torch.sum(s) for s in ins.stacks)
    time_stage("prev stacks (pyr+Scharr+pad)", prev_build_body, crops_a)

    lk_sample = "slices"   # the port's one LK sampling mode

    def next_build_body(eps, crops):
        ins = lk.precompute_frame_inputs(crops + eps, win, max_level,
                                         with_stacks=False, with_images=True)
        return sum(torch.sum(p) for p in ins.images)
    next_build_name = f"next build ({lk_sample})"
    time_stage(next_build_name, next_build_body, crops_a)

    def lk_body(eps, p):
        crops, prev_crop, pts, valid = p
        prev = lk.precompute_frame_inputs(prev_crop, win, max_level)
        nxt = lk.precompute_frame_inputs(crops + eps, win, max_level,
                                         with_stacks=False, with_images=True)
        fr = lk.lk_track_precomputed(prev, nxt, pts, valid, shapes, win,
                                     max_level, spec.lk.max_iters,
                                     spec.lk.epsilon)
        return torch.sum(fr.pts) + torch.sum(fr.status)
    time_stage("LK full (builds + Newton)", lk_body,
               (crops_b, states.prev_crop, states.pts, states.pts_valid))

    def step_body(eps, p):
        fr, st = p
        st2, sample = motion.measure_step_batch(st, fr + eps, spec,
                                                initialized_hint=True)
        return torch.sum(sample) + torch.sum(st2.pts)
    time_stage("measure_step (crop+LK+PCA+rings)", step_body,
               (frames_v[1], states))

    data, t_st, count = states.data, states.t, states.count
    time_stage("filtfilt (masked Hillis-Steele)",
               lambda eps, p: torch.sum(filters.filtfilt_masked(
                   coeffs, p[0] + eps, p[1])), (data, count))
    filtered = filters.filtfilt_masked(coeffs, data, count)

    def peaks_body(eps, p):
        f, c = p
        idx, mask = peaks_mod.peak_indexes_masked(
            f + eps, c, min_dist, thres=mcfg.peak_threshold,
            max_peaks=mcfg.max_peaks)
        return torch.sum(idx) + torch.sum(mask)
    time_stage("peak candidates", peaks_body, (filtered, count))

    # The fit's windows, built as the estimate builds them (bench.py's
    # make_windows: every candidate slot).
    n = filtered.shape[-1]
    width_w = max(min_dist, 1)
    cand_idx, cand_mask = peaks_mod.peak_indexes_masked(
        filtered, count, min_dist, thres=mcfg.peak_threshold,
        max_peaks=mcfg.max_peaks)
    i_loc = cand_idx - (n - count)[:, None]
    w1 = torch.where(i_loc - width_w < 0, i_loc, width_w)
    w2 = torch.where(i_loc + w1 > count[:, None], count[:, None] - i_loc, w1)
    offs = torch.arange(2 * width_w, device=dev)
    gidx = (cand_idx - w2)[..., None] + offs
    gclip = gidx.clamp(0, n - 1).reshape(streams, -1)
    win_t = torch.gather(t_st, 1, gclip).reshape(gidx.shape)
    win_y = torch.gather(filtered, 1, gclip).reshape(gidx.shape)
    win_m = cand_mask[..., None] & (offs < 2 * w2[..., None]) \
        & (gidx >= 0) & (gidx < n)
    n_cand = int(win_m.any(dim=2).sum())
    log(f"  (candidate windows in flight: {n_cand} across {streams} "
        f"streams)")

    def fit_body(eps, p):
        wy, wt, wm = p
        r = gaussfit.gaussian_fit_batch(wt, wy + eps, wm)
        return torch.sum(r.dev) + torch.sum(r.converged)
    time_stage("gaussian LM fit (batched)", fit_body, (win_y, win_t, win_m))

    def bpm_body(eps, p):
        d, t_, c = p
        r = bpm_mod.estimate_bpm(d + eps, t_, c, coeffs, min_dist, mcfg)
        return torch.sum(r.bpm) + torch.sum(r.filtered)
    time_stage("estimate_bpm full", bpm_body, (data, t_st, count))

    def full(eps, fr, st):
        st2, sample = motion.measure_step_batch(st, fr + eps, spec,
                                                initialized_hint=True)
        r = bpm_mod.estimate_bpm(st2.data, st2.t, st2.count, coeffs,
                                 min_dist, mcfg)
        return torch.sum(sample + r.bpm), st2

    full_ms = time_stage("FULL fused step (full rings)",
                         lambda eps, p: full(eps, *p)[0],
                         (frames_v[1], states))
    time_stage("FULL + state materialization",
               lambda eps, p: full(eps, *p), (frames_v[1], states))

    def outputs_floor_body(eps, p):
        fr, st = p
        small = eps > 2.0   # False for every eps here

        def pert(x):
            if x.dtype.is_floating_point:
                return x + eps.to(x.dtype)
            if x.dtype == torch.bool:
                return x & ~small
            return x + small.to(x.dtype)
        st2 = type(st)(*(pert(f) for f in st))
        return torch.sum(fr[0, 0, :4] + eps), st2
    time_stage("outputs floor (state-shaped)", outputs_floor_body,
               (frames_v[1], states))

    empty = states._replace(
        data=torch.zeros_like(data),
        count=torch.full((streams,), 3, dtype=torch.int32, device=dev),
        motion_count=torch.full((streams,), 3, dtype=torch.int32,
                                device=dev))
    time_stage("FULL fused step (3-sample rings)",
               lambda eps, p: full(eps, *p)[0], (frames_v[1], empty))

    # The production path: MultiStreamMonitor.step, steady-state rings.
    def states_copy():
        return type(states)(*(f.clone() for f in states))

    def production(frames):
        mon.states = states_copy()
        mon.step(frames[0]).samples.cpu()   # rebuilds the LK cache
        mon.step(frames[1]).samples.cpu()
        return _timed(lambda i: mon.step(frames[(i + 2) % 3]).samples,
                      production_steps) * 1e3

    prod_ms = production(frames_v)
    stage_ms["mon.step production (incl dispatch)"] = prod_ms
    log(f"  {'mon.step production (incl dispatch)':36s} {prod_ms:8.3f} ms")
    # Camera-native u8 frames (the deployment's ingest).
    frames_u8_v = [_to_dev(np.trunc(np.roll(frames_np, s, axis=2) * 255.0)
                           .astype(np.uint8), dev) for s in (0, 1, 2)]
    prod_u8_ms = production(frames_u8_v)
    stage_ms["mon.step production (u8 ingest)"] = prod_u8_ms
    log(f"  {'mon.step production (u8 ingest)':36s} {prod_u8_ms:8.3f} ms")

    derived = {
        "newton_loop_ms": stage_ms["LK full (builds + Newton)"]
        - stage_ms["prev stacks (pyr+Scharr+pad)"]
        - stage_ms[next_build_name],
        "flow_update_rings_ms":
            stage_ms["measure_step (crop+LK+PCA+rings)"]
            - stage_ms["LK full (builds + Newton)"]
            - stage_ms["crop+u8 (from 1080p frames)"],
        "bpm_stage_in_situ_ms": stage_ms["FULL fused step (full rings)"]
            - stage_ms["measure_step (crop+LK+PCA+rings)"],
        "fit_load_in_situ_ms": stage_ms["FULL fused step (full rings)"]
            - stage_ms["FULL fused step (3-sample rings)"],
        "state_writeout_ms": stage_ms["FULL + state materialization"]
            - stage_ms["FULL fused step (full rings)"],
        "state_io_floor_ms":
            stage_ms["outputs floor (state-shaped)"]
            - stage_ms["floor (trivial program)"],
        "host_wrapper_dispatch_ms":
            stage_ms["mon.step production (incl dispatch)"]
            - stage_ms["FULL + state materialization"],
    }
    for k, v in derived.items():
        log(f"  {k:36s} {v:8.3f} ms (derived)")
    del mon, frames_v, frames_u8_v, states, empty
    out = _emit({
        "metric": f"fleet_step_breakdown_{streams}x{_geometry(H, W)}",
        "value": round(full_ms, 2),
        "unit": "ms/step device (chained)",
        "vs_baseline": 0,
        "production_step_ms": round(prod_ms, 2),
        "stages_ms": {k: round(v, 2) for k, v in stage_ms.items()},
        "derived_ms": {k: round(v, 2) for k, v in derived.items()},
    }, dev)
    _release(dev)
    return out


# ---------------------------------------------------------------------------
# --live and --fleet-live
# ---------------------------------------------------------------------------

class _SlowSource:
    """An in-memory capture with a simulated per-frame decode cost."""

    def __init__(self, frames, delay_s, fps):
        from respmon_tpu_torch.io.capture import ArrayCapture

        self._src = ArrayCapture(frames, fps=fps)
        self._delay = delay_s
        self.fps = self._src.fps
        self.width = self._src.width
        self.height = self._src.height

    def next_frame(self):
        f = self._src.next_frame()
        if f is not None and self._delay:
            time.sleep(self._delay)
        return f

    def is_open(self):
        return self._src.is_open()

    def release(self):
        self._src.release()


def main_live(measure_frames: int = 256, capture_ms: float = 15.0, *,
              height: int = 480, width: int = 640,
              calibration: CalibrationConfig = None, device=None):
    """The live path's sustained rate: frames from a source with a
    simulated ``capture_ms`` decode cost through the lossless
    ``FrameFeeder``, uploaded, then ``runtime/monitor._measure_and_estimate``
    (the motion step and the BPM estimate) with a host read of every
    frame's sample, as the monitor's loop does; against the same loop
    reading the source synchronously, in float32 and camera-native u8."""
    from respmon_tpu_torch.ops import filters
    from respmon_tpu_torch.pipeline import evm, motion
    from respmon_tpu_torch.runtime.feeder import FrameFeeder
    from respmon_tpu_torch.runtime.monitor import _measure_and_estimate

    dev = device_mod.resolve(device)
    _warmup(dev)
    fps_video = FPS_VIDEO
    cfg = MonitorConfig(motion_extraction_method="flow",
                        calibration=calibration or CalibrationConfig())
    cal_len = cfg.calibration.buffer_length
    total = cal_len + 1 + measure_frames
    log("generating clip...")
    clip = _headline_clip(total, height, width)
    loc = evm.locate(_to_dev(clip[:cal_len], dev), fps_video,
                     cfg.calibration)
    if not bool(loc.found):
        raise RuntimeError("live: locate found no ROI")
    x, y, w, h = int(loc.x), int(loc.y), int(loc.w), int(loc.h)
    log(f"roi {(x, y, w, h)}")
    spec = motion.MeasureSpec.for_roi(cfg, height, width, w, h, fps_video)
    coeffs = filters.design_butter_lowpass(0.5, fps_video,
                                           cfg.measure.filter_order)
    rest = np.ascontiguousarray(clip[cal_len + 1:], np.float32)
    rest_u8 = np.clip(rest * 255.0, 0, 255).astype(np.uint8)
    del clip

    def fresh_state():
        return motion.init_state(spec, (x, y, w, h), device=dev)

    def step(state, frame):
        # u8 frames widen on the device inside the motion step.
        return _measure_and_estimate(state, _to_dev(frame, dev), spec,
                                     coeffs, 10, cfg.measure)

    for frames in (rest, rest_u8):   # the first run of each ingest
        _, s, _ = step(fresh_state(), frames[0])
        float(s)

    delay = capture_ms * 1e-3

    def run_sync(frames):
        src = _SlowSource(frames, delay, fps_video)
        state = fresh_state()
        n = 0
        t0 = time.perf_counter()
        while True:
            f = src.next_frame()
            if f is None:
                break
            state, sample, _ = step(state, f)
            float(sample)       # the monitor's per-frame host mirror
            n += 1
        return n / (time.perf_counter() - t0)

    def run_live(frames):
        feeder = FrameFeeder(_SlowSource(frames, delay, fps_video),
                             capacity=4, lossless=True,
                             dtype=frames.dtype).start()
        state = fresh_state()
        n = 0
        t0 = time.perf_counter()
        try:
            while True:
                f, _seq = feeder.next_frame(latest=False)
                if f is None:
                    break
                state, sample, _ = step(state, f)
                float(sample)
                n += 1
            rate = n / (time.perf_counter() - t0)
        finally:
            feeder.stop()
        if n != len(frames):
            raise RuntimeError(f"live: the lossless feeder gave {n} of "
                               f"{len(frames)} frames")
        return rate, feeder.dropped

    log(f"timing sync loop (f32 upload, {capture_ms:.0f} ms simulated "
        f"decode)...")
    fps_sync = run_sync(rest)
    log(f"sync f32: {fps_sync:.2f} fps")
    fps_live, dropped = run_live(rest)
    log(f"live f32 (feeder overlap): {fps_live:.2f} fps, dropped={dropped}")
    fps_sync_u8 = run_sync(rest_u8)
    log(f"sync u8 upload: {fps_sync_u8:.2f} fps")
    fps_live_u8, dropped_u8 = run_live(rest_u8)
    log(f"live u8 (feeder overlap): {fps_live_u8:.2f} fps, "
        f"dropped={dropped_u8}")

    out = _emit({
        "metric": f"live_path_sustained_{_geometry(height, width)}",
        "value": round(fps_live, 1),
        "unit": "frames/sec (feeder + upload + fused step + host fetch)",
        "vs_baseline": round(fps_live / REFERENCE_BEST_FPS, 1),
        "sync_fps": round(fps_sync, 1),
        "overlap_gain": round(fps_live / fps_sync, 2),
        "dropped": dropped,
        "u8_upload_live_fps": round(fps_live_u8, 1),
        "u8_upload_sync_fps": round(fps_sync_u8, 1),
        "simulated_capture_ms": capture_ms,
    }, dev)
    _release(dev)
    return out


class _CyclingSlowSource:
    """Loops a small frame set forever with a simulated decode cost, so the
    sources cannot run out while the fleet warms up."""

    def __init__(self, frames, delay_s, fps):
        self._frames, self._delay, self._i = frames, delay_s, 0
        self.fps = fps
        self.height, self.width = frames.shape[1:]

    def next_frame(self):
        f = self._frames[self._i % self._frames.shape[0]]
        self._i += 1
        if self._delay:
            time.sleep(self._delay)
        return f

    def is_open(self):
        return True

    def release(self):
        pass


def main_fleet_live(streams: int = 16, measure_frames: int = 64,
                    capture_ms: float = 15.0, height: int = 1080,
                    width: int = 1920, *,
                    calibration: CalibrationConfig = None, device=None):
    """The fleet's production loop, the multi-stream ``--live``: S u8
    sources with a simulated decode cost -> ``FleetFeeder`` (per-stream
    native rings, live freshest-wins, one assembled (S, H, W) u8 batch a
    tick, through the C++ ``rings_collect_latest``) -> upload ->
    ``MultiStreamMonitor.step``.  Reports fresh stream-frames a second,
    the share of stale rows and the drops."""
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm
    from respmon_tpu_torch.runtime.fleet_feeder import FleetFeeder

    dev = device_mod.resolve(device)
    _warmup(dev)
    fps_video = FPS_VIDEO
    H, W = height, width
    cfg = MonitorConfig(motion_extraction_method="flow",
                        calibration=calibration or CalibrationConfig())

    log(f"locate for the fleet ROI ({H}x{W})...")
    cal = breathing_clip(num_frames=cfg.calibration.buffer_length, height=H,
                         width=W, fps=fps_video, bpm=18.0,
                         patch_center=(H // 2, W // 2),
                         patch_size=(H // 6, W // 9), amplitude=0.12,
                         motion_px=3.0)
    cal_u8 = np.clip(np.round(cal * 255.0), 0, 255).astype(np.uint8)
    del cal
    loc = evm.locate(_to_dev(cal_u8, dev), fps_video, cfg.calibration)
    if not bool(loc.found):
        raise RuntimeError("fleet-live: locate found no ROI")
    box = (int(loc.x), int(loc.y), int(loc.w), int(loc.h))
    log(f"roi: {box}")
    mon, _ = _fleet_at_box(cfg, H, W, box, streams, dev, fps_video)

    # Per-stream u8 source clips: the last calibration frame shifted +-1
    # px per frame, a phase offset per stream.
    t_total = min(measure_frames, 16)   # cycled; small host footprint
    base = cal_u8[-1]
    del cal_u8

    def stream_frames(s):
        out = np.empty((t_total, H, W), np.uint8)
        for i in range(t_total):
            out[i] = np.roll(base, (s + i) % 3 - 1, axis=1)
        return out

    # Both step variants run once before the feeder starts.
    warm0 = np.stack([np.roll(base, s % 3 - 1, axis=1)
                      for s in range(streams)])
    warm1 = np.stack([np.roll(base, (s + 1) % 3 - 1, axis=1)
                      for s in range(streams)])
    mon.step(warm0).samples.cpu()   # corner detection
    mon.step(warm1).samples.cpu()   # steady state

    feeder = FleetFeeder(
        [_CyclingSlowSource(stream_frames(s), capture_ms * 1e-3, fps_video)
         for s in range(streams)],
        capacity=4, lossless=False, dtype=np.uint8).start()
    ticks = 0
    stale_rows = 0
    try:
        _sync()
        t0 = time.perf_counter()
        for _ in range(measure_frames):
            b = feeder.next_batch(timeout=30.0)
            if b is None:
                break
            mon.step(b.frames)
            ticks += 1
            stale_rows += int(b.stale.sum())
        _sync()
        wall = time.perf_counter() - t0
    finally:
        feeder.stop()

    # Fresh rows only: a live tick proceeds once ANY stream has a new
    # frame, so stale repeated rows are not ingest.
    fresh_rows = ticks * streams - stale_rows
    sfps = fresh_rows / wall
    tick_rate = ticks / wall
    stale_rate = stale_rows / max(ticks * streams, 1)
    dropped = feeder.dropped
    log(f"fleet-live: {ticks} lockstep ticks ({tick_rate:.2f}/s) in "
        f"{wall:.2f}s -> {sfps:.1f} fresh stream-frames/s; stale rate "
        f"{stale_rate:.2%}; dropped/stream min={dropped.min()} "
        f"max={dropped.max()}")
    del mon
    out = _emit({
        "metric": f"fleet_live_{streams}x{H}p_sustained",
        "value": round(sfps, 1),
        "unit": "fresh stream-frames/sec (feeder + u8 upload + fused step)",
        "vs_baseline": round(sfps / REFERENCE_BEST_FPS, 1),
        "ticks": ticks,
        "tick_rate_hz": round(tick_rate, 2),
        "stale_rate": round(stale_rate, 4),
        "dropped_total": int(dropped.sum()),
        "simulated_capture_ms": capture_ms,
    }, dev)
    _release(dev)
    return out


# ---------------------------------------------------------------------------
# --recovery
# ---------------------------------------------------------------------------

class _AdaptiveSource:
    """Good breathing frames or blackouts, as the soak asks, at the video's
    rate: a camera gives 10 frames a second, so a recovery that consumes
    frames (the cold refill of the calibration buffer, the warm path's
    localize) costs real time here as deployed."""

    def __init__(self, pool, fps):
        self.pool = pool
        self.black = np.zeros_like(pool[0])
        self.fps = fps
        self.height, self.width = pool.shape[1:]
        self.mode = "good"
        self.idx = 0          # advances only on good frames: the phase
        self.open = True      # stays continuous across blackouts
        self._last = 0.0

    def next_frame(self):
        if not self.open:
            return None
        wait = self._last + 1.0 / self.fps - time.time()
        if wait > 0:
            time.sleep(wait)
        self._last = time.time()
        if self.mode == "black":
            return self.black
        f = self.pool[self.idx % len(self.pool)]
        self.idx += 1
        return f

    def is_open(self):
        return self.open

    def release(self):
        self.open = False


def main_recovery(cycles: int = 3, error_reset_delay: float = 0.5,
                  height: int = 480, width: int = 640,
                  smoke: bool = False, streaming_roi: bool = False, *,
                  device=None):
    """Error-recovery soak on the device: ``runtime/monitor.
    RespiratoryMonitor`` through calibrate -> measure -> blackout fault ->
    NaN detection -> error -> reset -> recalibrate, ``cycles`` times.
    The source serves phase-continuous breathing frames (18.75 BPM, an
    exact 32-frame period at 10 fps) and switches to blackout once the
    cycle has 8 BPM samples; good frames resume at the error, so the
    recalibration sees a live subject.  Recovery latency is the time from
    the error to the next cycle's first BPM.  ``smoke`` takes a 64-frame
    5-level calibration; ``streaming_roi`` is the warm variant, whose
    rings survive the error so the recalibration localizes from them (K1
    at T = 1 every frame) instead of refilling the buffer."""
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.runtime.monitor import RespiratoryMonitor

    dev = device_mod.resolve(device)
    _warmup(dev)
    fps_video, true_bpm = FPS_VIDEO, 18.75     # 32-frame period at 10 fps
    log("generating phase-periodic frame pool...")
    pool = breathing_clip(num_frames=320, height=height, width=width,
                          fps=fps_video, bpm=true_bpm,
                          patch_center=(height // 2, width // 2),
                          patch_size=(min(80, height // 3),
                                      min(100, width // 3)),
                          amplitude=0.12, motion_px=2.0,
                          texture_motion=True)
    src = _AdaptiveSource(pool, fps_video)
    if smoke:   # a small calibration for logic runs
        cfg = MonitorConfig(
            motion_extraction_method="flow",
            calibration=CalibrationConfig(buffer_length=64,
                                          pyramid_levels=5,
                                          skip_levels_at_top=2))
    else:
        cfg = MonitorConfig(motion_extraction_method="flow")
    if streaming_roi:
        cfg = dataclasses.replace(cfg, streaming_roi=True)
    mon = RespiratoryMonitor(
        capture_target="recovery-soak", capture=src, config=cfg,
        motion_extraction_method="flow", visualize=None,
        save_all_data=False, auto_run=False, sync_fps=False,
        error_reset_delay=error_reset_delay, use_feeder=False, device=dev)
    mon.fps = fps_video

    transitions = []
    latencies, compute_latencies, bpm_tails = [], [], []
    last_state = mon.state
    t_err = None
    t_phase = t_start = time.time()
    log(f"soaking {cycles} fault/recovery cycles "
        f"(error_reset_delay={error_reset_delay}s)...")
    while len(latencies) < cycles and time.time() - t_start < 1800:
        if not mon.step():
            raise RuntimeError("recovery: the capture closed unexpectedly")
        if mon.state != last_state:
            now = time.time()
            log(f"  -> {mon.state} (prev phase {now - t_phase:.2f}s)")
            t_phase = now
            transitions.append(mon.state)
            if mon.state == "error":
                t_err = time.time()
                bpm_tails.append(float(np.median(list(mon.freq)[-8:]))
                                 if mon.freq else float("nan"))
                src.mode = "good"   # recalibration needs a live subject
                log(f"cycle {len(latencies)}: error detected "
                    f"({mon.error_message!r}), pre-fault BPM tail "
                    f"{bpm_tails[-1]:.2f}")
            last_state = mon.state
        if mon.state == "measure" and t_err is not None \
                and len(mon.freq) > 0:
            lat = time.time() - t_err
            latencies.append(lat)
            compute_latencies.append(lat - error_reset_delay)
            log(f"cycle {len(latencies) - 1}: recovered in {lat:.2f}s "
                f"(compute {lat - error_reset_delay:.2f}s), "
                f"BPM {mon.freq[-1]:.2f}")
            t_err = None
        if mon.state == "measure" and t_err is None \
                and len(mon.freq) >= 8 and src.mode == "good":
            src.mode = "black"      # inject the next fault

    if len(latencies) != cycles:
        raise RuntimeError(f"recovery: only {len(latencies)}/{cycles} "
                           "recoveries in 30 min")
    # Each cycle is error -> calibration -> measure (the initialize state
    # is internal to reset()); the run starts mid-calibration, so what
    # comes before the first error is dropped.
    want = ["error", "calibration", "measure"] * cycles
    got = [s for s in transitions if s in ("error", "calibration",
                                           "measure")]
    while got and got[0] != "error":
        got.pop(0)
    if got[:len(want)] != want:
        raise RuntimeError(f"recovery: state sequence {got} != {want}")
    tails = [b for b in bpm_tails if b == b]
    relocks = mon.relocks
    del mon
    out = _emit({
        "metric": f"error_recovery_soak_{width}x{height}"
                  + ("_warm_streaming" if streaming_roi else ""),
        "streaming_roi": streaming_roi,
        "relocks": relocks,
        "value": round(float(np.mean(latencies)), 2),
        "unit": "s mean recovery latency (error->first BPM)",
        "vs_baseline": round(
            (error_reset_delay
             + (cfg.calibration.buffer_length + 13) / fps_video)
            / float(np.mean(latencies)), 1),
        "cycles": cycles,
        "max_latency_s": round(float(np.max(latencies)), 2),
        "compute_latency_s": round(float(np.mean(compute_latencies)), 2),
        "error_reset_delay_s": error_reset_delay,
        "pre_fault_bpm_tail_median": round(float(np.median(tails)), 2)
        if tails else None,
        "bpm_true": true_bpm,
        "state_sequence_ok": True,
    }, dev)
    _release(dev)
    return out


# ---------------------------------------------------------------------------
# --streaming
# ---------------------------------------------------------------------------

def main_streaming(reps_absorb: int = 32, reps_update: int = 6, *,
                   sizes=((480, 640), (1080, 1920)),
                   calibration: CalibrationConfig = None, device=None):
    """Device cost of the streaming calibrator (``pipeline/streaming``):
    ms a frame of ``streaming_absorb`` (K1 at T = 1, the every-frame half)
    and ms of ``streaming_update`` (absorb + re-localize, every
    ``streaming_interval`` frames), full and coarse, at 640x480 and 1080p.
    Each timed call runs ``reps`` absorbs or updates over distinct frames
    in a row, one synchronise at the end; the amortized figure at the
    default interval is what the monitor's streaming-ROI mode adds to a
    measured frame."""
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import streaming

    dev = device_mod.resolve(device)
    _warmup(dev)
    cfg = MonitorConfig(calibration=calibration or CalibrationConfig())
    cal = cfg.calibration
    interval = cfg.streaming_interval
    fps_video = FPS_VIDEO
    out = {"metric": "streaming_calibrator_device_costs",
           "unit": "ms (device, chained calls amortized)",
           "interval": interval}

    for h, w in sizes:
        name = _geometry(h, w)
        log(f"--- {name} ---")
        total = cal.buffer_length + max(reps_absorb, reps_update)
        clip = breathing_clip(num_frames=total, height=h, width=w,
                              fps=fps_video, bpm=18.0,
                              patch_center=(h // 2, w // 2),
                              patch_size=(h // 6, w // 6), amplitude=0.12,
                              motion_px=2.0, texture_motion=True,
                              drift_px=(10.0, 16.0))
        buf = _to_dev(clip[:cal.buffer_length], dev)
        rest = _to_dev(clip[cal.buffer_length:], dev)
        del clip
        state = streaming.init_streaming_from_buffer(buf, cal)
        del buf

        def absorb_k(eps):
            s = state
            probe = torch.zeros((), device=dev)
            for f in rest[:reps_absorb]:
                s = streaming.streaming_absorb(s, f + eps, cal)
                probe = probe + s.levels[-1][-1, 0, 0]
            return probe

        def update_k(eps, coarse):
            s = state
            probe = torch.zeros((), device=dev, dtype=torch.int64)
            for f in rest[:reps_update]:
                s, res = streaming.streaming_update(s, f + eps, fps_video,
                                                    cal, coarse=coarse)
                probe = probe + res.x + res.y + res.found.to(torch.int64)
            return probe

        absorb_k(0.0)     # first runs (excluded)
        update_k(0.0, False)
        update_k(0.0, True)

        absorb_ms = _timed(lambda i: absorb_k((i + 1) * 1e-6),
                           3) / reps_absorb * 1e3
        update_ms = _timed(lambda i: update_k((i + 1) * 1e-6, False),
                           3) / reps_update * 1e3
        coarse_ms = _timed(lambda i: update_k((i + 1) * 1e-6, True),
                           3) / reps_update * 1e3
        amort_ms = ((interval - 1) * absorb_ms + update_ms) / interval
        amort_c = ((interval - 1) * absorb_ms + coarse_ms) / interval
        log(f"{name}: absorb {absorb_ms:.3f} ms/frame, update "
            f"{update_ms:.2f} ms (coarse {coarse_ms:.2f} ms), amortized "
            f"{amort_ms:.3f} ms/frame (coarse {amort_c:.3f}) at interval "
            f"{interval} ({1e3 / (amort_ms * fps_video):.1f}x real-time at "
            f"{fps_video:.0f} fps)")
        key = name.replace("x", "_")
        out[f"absorb_ms_{key}"] = round(absorb_ms, 2)
        out[f"update_ms_{key}"] = round(update_ms, 1)
        out[f"update_coarse_ms_{key}"] = round(coarse_ms, 2)
        out[f"amortized_ms_per_frame_{key}"] = round(amort_ms, 2)
        out[f"amortized_coarse_ms_per_frame_{key}"] = round(amort_c, 2)
        out[f"realtime_x_{key}"] = round(1e3 / (amort_ms * fps_video), 1)
        del rest, state
        _release(dev)

    first = _geometry(*sizes[0]).replace("x", "_")
    out["value"] = out[f"amortized_ms_per_frame_{first}"]
    out["vs_baseline"] = out[f"realtime_x_{first}"]
    out = _emit(out, dev)
    _release(dev)
    return out


def main():
    p = argparse.ArgumentParser(prog="python -m respmon_tpu_torch.bench")
    p.add_argument("--multistream", action="store_true",
                   help="benchmark 64-stream 1080p lockstep monitoring "
                        "(BASELINE.md config 5) instead of the headline")
    p.add_argument("--streams", type=int, default=None,
                   help="fleet size (default: 64 for --multistream/"
                        "--breakdown, 16 for --fleet-live)")
    p.add_argument("--breakdown", action="store_true",
                   help="per-stage breakdown of the fleet step")
    p.add_argument("--live", action="store_true",
                   help="sustained live-path throughput through the "
                        "FrameFeeder (lossless), incl. uint8-upload mode")
    p.add_argument("--fleet-live", action="store_true",
                   help="sustained PRODUCTION fleet loop: FleetFeeder "
                        "(u8 rings) -> fused upload -> lockstep step")
    p.add_argument("--frames", type=int, default=256,
                   help="--live/--fleet-live: number of measured frames")
    p.add_argument("--capture-ms", type=float, default=15.0,
                   help="--live/--fleet-live: simulated per-frame decode "
                        "cost")
    p.add_argument("--height", type=int, default=1080,
                   help="--fleet-live: frame height (shrink for CPU smoke)")
    p.add_argument("--width", type=int, default=1920,
                   help="--fleet-live: frame width")
    p.add_argument("--no-fleet", action="store_true",
                   help="headline: skip the compact 16x720p fleet segment")
    p.add_argument("--streaming", action="store_true",
                   help="device cost of the streaming EVM calibrator "
                        "(absorb/update ms at 640x480 and 1080p)")
    p.add_argument("--recovery", action="store_true",
                   help="soak the calibrate->measure->error->recalibrate "
                        "loop on device with blackout fault injection")
    p.add_argument("--cycles", type=int, default=3,
                   help="--recovery: number of fault/recovery cycles")
    p.add_argument("--warm", action="store_true",
                   help="--recovery: streaming-ring warm recovery variant "
                        "(config.streaming_roi on; rings survive the error "
                        "state so recalibration skips the buffer refill)")
    p.add_argument("--fleet-refine", action="store_true",
                   help="--multistream: run the fleet in the ACCURACY tier "
                        "(fleet_f64_refine on: the f64 wild-fit refinement "
                        "inside the lockstep step)")
    p.add_argument("--bpm-corpus", action="store_true",
                   help="end-to-end BPM decision envelope: device f32 "
                        "estimator vs the scipy-f64 golden chain over a "
                        "synthetic trace corpus")
    p.add_argument("--traces", type=int, default=120,
                   help="--bpm-corpus: number of corpus traces")
    p.add_argument("--out", type=str, default=None,
                   help="--bpm-corpus: also write the JSON artifact here")
    p.add_argument("--device", default=None,
                   help="where to compute (default cuda:0, which must "
                        "exist; cpu runs on the CPU)")
    args = p.parse_args()
    dev = args.device
    if args.bpm_corpus:
        main_bpm_corpus(n_traces=args.traces, out_path=args.out, device=dev)
    elif args.recovery:
        main_recovery(cycles=args.cycles, streaming_roi=args.warm,
                      device=dev)
    elif args.streaming:
        main_streaming(device=dev)
    elif args.breakdown:
        main_fleet_breakdown(args.streams or 64, device=dev)
    elif args.fleet_live:
        main_fleet_live(streams=args.streams or 16,
                        measure_frames=args.frames,
                        capture_ms=args.capture_ms, height=args.height,
                        width=args.width, device=dev)
    elif args.live:
        main_live(args.frames, args.capture_ms, device=dev)
    elif args.multistream:
        main_multistream(args.streams or 64, fleet_refine=args.fleet_refine,
                         device=dev)
    else:
        main_headline(include_fleet=not args.no_fleet, device=dev)


if __name__ == "__main__":
    main()
