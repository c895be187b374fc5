#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``respmon_tpu_torch/csrc`` (one nvcc
per source, into ``build/``; the build line also holds what ptxas says of
each kernel), checks each against its plain
PyTorch version on the card (the stencil kernels bit for bit, along the
launches their plan makes for each parity geometry; the band kernels also
on dense, all-zero-tile, unaligned and minuend operands; the Gaussian LM
fit's kernel at the single monitor's and the 64-stream fleet's shapes,
with its float64 refit, bit for bit against the plain loop,
``phase_gaussfit``; the connected-component kernel at the fleet's localize
and the calibrations' shapes, bit for bit against the plain version,
``phase_ccl``; the
monitor and fleet phases count its launches, two a single estimate and one
a fleet estimate), and drives the whole-clip path
``process_clip`` at 640x480 in average mode and in flow mode (Shi-Tomasi
corners, pyramidal LK, 2x2 PCA), one 640x480 calibration with the
band-matrix pyramid (K3) in place of the stencil one (K1), and one 1080p
calibration, checking what comes out.  Then the live monitor
(``runtime.RespiratoryMonitor``) on the same 640x480 clip, frame by frame,
in average and in flow mode (``phase_monitor``), fed by the native frame
ring (``phase_feeder``), and through a blackout, the error state and a
recalibration (``phase_monitor_recovery``); the last two also split each
measured frame's time between the motion step and the BPM estimate.  The
streaming-ROI mode: K1 at T = 1, the kernel call of every frame the rolling
rings absorb (``phase_streaming_kernels``), the streaming localizer on a
640x480 moving subject (``phase_streaming``), the monitor re-locking onto a
drifting subject in both modes (``phase_monitor_streaming``) and its warm
recovery through the blackout (``phase_monitor_warm_recovery``); and the
IIR temporal filter (``temporal_filter="iir"``) in the 120x160 cross-check
and a 640x480 calibration (``phase_iir_locate``).  The multi-stream fleet
(``parallel.streams.MultiStreamMonitor``, the stream axis a batch
dimension): 4 streams of 640x480 in flow mode, calibrated and measured
(``phase_fleet``), fed by the ``FleetFeeder`` (``phase_fleet_feeder``), a
small fleet on the card against the CPU (``phase_fleet_cross_check``), 4
drifting subjects in streaming-ROI mode (``phase_fleet_streaming``), the
64 x 1080p deployment of bench.py's fleet bench (``phase_fleet_1080p``) and
K1 at the fleet's shapes (``phase_fleet_kernels``).  Checkpoint / resume
(``phase_checkpoint``): the 640x480 flow monitor and the 4 x 640x480 flow
fleet saved mid-run and restored on the card go on bit for bit as the
uninterrupted ones.  The sharded paths in a one-rank NCCL process group
(``phase_sharded``): the T-sharded locate (K1 on its shard) and the
W-sharded locate of the 640x480 buffer against ``locate``, and the
stream-sharded fleet against the unsharded one.  The auxiliary modules
(``phase_aux``: the dtype converters, ``detect_peaks``, the wavelets and
the FFT diagnostics at the sizes their users meet, against the port's CPU
results), the functions that completed the port's public surface
(``phase_surface``: the single-stream ``measure_step_cached`` on the
640x480 clip against ``measure_step``, ``measure_step``'s
``initialized_hint``, ``filtfilt``, ``peak_indexes`` and
``gaussian_fit_single`` against their CPU results, and the counterpart of
``__graft_entry__.entry()``, ``respmon_tpu_torch.entry``, whose 64-frame
120x160 ``locate`` runs K1), and the port's nine demos run in this process
on the card (``phase_examples``: K1 in the locating, flow and fleet demos,
the 1-D demos and the locating demo against their CPU runs), and the
port's benchmark, ``respmon_tpu_torch.bench``: its nine modes (bench.py's)
through their in-process functions, the headline at full size and the
others cut to the phase's time (``phase_bench``, ``BENCH_MODES``), each
line checked for bench.py's keys, finite numbers and its mode's results,
and every K1 call in it for the launches of its plan.  Each phase
prints one JSON line; then each phase's seconds, the kernel table, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.  Without a CUDA device it exits 1.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

FPS = 10.0
TIME_BUDGET_S = 900   # the whole script, kernel builds included
REPEATS = 20
KERNEL_CALLS = 10   # calls in a row per reading of a kernel's time, see cuda_ms
PYRAMID_CU = "respmon_tpu_torch/csrc/pyramid.cu"
BAND_CU = "respmon_tpu_torch/csrc/band_mm.cu"
PALLAS = "respmon_tpu/ops/pyramid_pallas.py"
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and the float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, repeats: int = REPEATS, calls: int = 1) -> float:
    """Median device time of one ``fn`` in ms (CUDA events, after warm-up).
    With ``calls`` > 1 each reading spans that many calls in a row and is
    divided by it, so the host's time to make a call (tens of
    microseconds) does not count against a kernel as short as that."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_times(kernel, plain, graph: bool = False) -> dict:
    """A kernel's row of times: ``ms`` and ``plain_ms`` from readings of
    ``KERNEL_CALLS`` calls in a row, and ``ms_one_call`` from readings of
    one call each, which holds the host's time to make the call as well.
    With ``graph``, also ``graph_ms``: ``KERNEL_CALLS`` calls replayed from
    a CUDA graph, the device's time alone where a call takes the host
    longer to make than the card to run."""
    row = {"ms": cuda_ms(kernel, calls=KERNEL_CALLS),
           "plain_ms": cuda_ms(plain, calls=KERNEL_CALLS),
           "ms_one_call": cuda_ms(kernel)}
    if graph:
        row["graph_ms"] = graph_ms(kernel, calls=KERNEL_CALLS)
    return row


def wall_s(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_us_per_call(call, n: int = 200) -> float:
    """The host's time to make one call, over ``n`` calls made without
    waiting for the card."""
    call()
    _, seconds = wall_s(lambda: [call() for _ in range(n)])
    return seconds / n * 1e6


def graph_ms(fn, calls: int = 1) -> float:
    """Median device time of one ``fn`` replayed from a CUDA graph of
    ``calls`` calls in a row: what its launches take when the host's time
    to launch them (and, with ``calls`` > 1, to replay the graph) is out of
    the way."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [fn() for _ in range(calls)]  # noqa: F841  (outputs live
        # as long as the graph)
    return cuda_ms(graph.replay) / calls


def max_abs(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes that
    must move (every input read once, every output written once) over the
    memory rate and the operations over the float32 rate."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from respmon_tpu_torch.ops import _build

    _build.reset_launches()


def read_launches() -> dict:
    """A copy of every kernel's launch count since ``reset_launches``
    (``ops/_build.LAUNCHES``): the stencil and band kernels by name, the
    Gaussian fit's as ``gauss_fit``, the connected-component search's
    library calls as ``ccl``."""
    from respmon_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def pyramid_launches(launches: dict) -> dict:
    """The stencil and band kernels' counts of a ``read_launches`` dict."""
    return {k: n for k, n in launches.items()
            if k not in ("gauss_fit", "ccl")}


class count_estimates:
    """While open, counts the BPM estimates (``n``): the calls of
    ``pipeline.bpm.estimate_bpm``, through which the monitor and the fleet
    estimate."""

    def __enter__(self):
        from respmon_tpu_torch.pipeline import bpm

        self._bpm, self._estimate, self.n = bpm, bpm.estimate_bpm, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self._estimate(*args, **kwargs)

        bpm.estimate_bpm = counted
        return self

    def __exit__(self, *exc):
        self._bpm.estimate_bpm = self._estimate
        return False


def check_fit_launches(launches, estimates: int, per_estimate: int,
                       what: str) -> None:
    """A run that made ``estimates`` BPM estimates launched the Gaussian
    fit's kernel ``per_estimate`` times each (the float32 fit, and the
    float64 refit where the configuration runs it)."""
    check(estimates > 0 and launches["gauss_fit"] == per_estimate * estimates,
          f"{what}: {per_estimate} gauss_fit launches an estimate, "
          f"{launches['gauss_fit']} over {estimates} estimates")


def check_ccl_launches(launches, searches: int, what: str) -> None:
    """A run that made ``searches`` connected-component searches (one a
    ``locate``, one a batched localize of S masks) called ``csrc/ccl.cu``
    once each."""
    check(searches > 0 and launches["ccl"] == searches,
          f"{what}: one ccl call a search, {launches['ccl']} over "
          f"{searches} searches")


def check_k1_path(launches, what: str) -> None:
    """One 640x480 ``locate`` ran K1 as its plan says: one A (d = 2), one
    B, no A (d = 1), no lap_level_f32, and no kernel of the chain before
    them."""
    check(launches["pyr_down_levels_d2"] == 1 and launches["pyr_tail"] == 1
          and launches["pyr_down_levels_d1"] == 0
          and launches["lap_level"] == 0 and "pyr_down" not in launches,
          f"{what} launched A (d = 2) and B once each: {launches}")


def planned_launches(h: int, w: int, levels: int, skip: int) -> dict:
    """The stencil kernels' launch counts that the plan of one K1 call at
    this geometry makes."""
    from respmon_tpu_torch.ops import pyramid_cuda

    p = pyramid_cuda.plan(h, w, levels, skip)
    counts = dict.fromkeys(pyramid_cuda.KERNELS.counted, 0)
    for _, d in p.downs:
        counts[f"pyr_down_levels_d{d}"] += 1
    counts["pyr_tail"] = int(p.tail)
    counts["lap_level"] = len(p.laps)
    return counts


def quantize(clip):
    import numpy as np

    return np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})
    return card


def phase_build():
    from respmon_tpu_torch.ops import (_build, ccl, gaussfit, pyramid_cuda,
                                       pyramid_mm)

    root = _build.BUILD_DIR.parent.parent

    def build(name):
        t0 = time.perf_counter()
        path = _build.build(name)
        seconds = time.perf_counter() - t0
        # What ptxas says of each kernel in the source: registers, shared
        # memory, spills (a second compilation, to a cubin that is dropped).
        flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
        said = subprocess.run(
            [_build.find_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
             os.devnull, str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        check(said.returncode == 0, f"nvcc -Xptxas -v: {said.stderr.strip()}")
        return {"library": str(path.relative_to(root)), "seconds": seconds,
                "ptxas": [ln.strip() for ln in said.stderr.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Compiling" in ln]}

    # One nvcc per source, all started together.
    names = ("pyramid", "band_mm", "gaussfit", "ccl")
    with ThreadPoolExecutor(len(names)) as pool:
        libraries = dict(zip(names, pool.map(build, names)))
    for ops in (pyramid_cuda, pyramid_mm, gaussfit, ccl):
        ops.KERNELS.bind()
    emit({"phase": "build", "libraries": libraries})


def phase_widen(dev):
    import numpy as np
    import torch

    from respmon_tpu_torch.ops.dtype import uint8_to_float

    b = np.arange(256, dtype=np.uint8)
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got = uint8_to_float(torch.from_numpy(b).to(dev)).cpu().numpy()
    bad = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    emit({"phase": "widen", "bytes": 256, "mismatches": bad})
    check(bad == 0, "uint8_to_float is the f64 chain's f32 image")


GAUSSFIT_CU = "respmon_tpu_torch/csrc/gaussfit.cu"
GAUSSFIT_STREAMS = 64     # the 64-stream fleet: (64 x 12, 20) lanes
# One thread's issue rate: one operation a cycle at the H100 SXM's
# highest SM clock (1980 MHz).
SM_CLOCK_HZ = 1.98e9


def _fit_windows(dev, streams):
    """The float32 fit's and the float64 refit's inputs that
    ``estimate_bpm`` makes from ``streams`` full 128-sample rings at 10 fps
    (12 candidate lanes of 20 samples a ring): (f32 args, f64 args)."""
    import dataclasses

    import numpy as np
    import torch

    from respmon_tpu_torch.config import MeasureConfig
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import filters, gaussfit
    from respmon_tpu_torch.pipeline import bpm

    rings = [motion_trace(num_samples=128, fps=FPS, bpm=12.0 + 0.25 * k,
                          noise=0.1, seed=k) for k in range(streams)]
    t = torch.tensor(np.stack([r[0] for r in rings]) + 30.0,
                     dtype=torch.float32, device=dev)
    y = torch.tensor(np.stack([r[1] for r in rings]), dtype=torch.float32,
                     device=dev)
    count = torch.full((streams,), 128, dtype=torch.int32, device=dev)
    cfg = MeasureConfig()
    if streams > 1:   # the fleet runs without the float64 refit
        cfg = dataclasses.replace(cfg, f64_refine=False)
    seen = []
    fit = gaussfit.gaussian_fit_batch

    def capture(*args, **kw):
        seen.append(args)
        return fit(*args, **kw)

    gaussfit.gaussian_fit_batch = capture
    try:
        bpm.estimate_bpm(y, t, count, filters.design_butter_lowpass(
            0.5, FPS, cfg.filter_order), int(FPS), cfg)
    finally:
        gaussfit.gaussian_fit_batch = fit
    torch.cuda.synchronize()
    return seen[0], (seen[1] if len(seen) > 1 else None)


def phase_gaussfit(dev):
    """The Gaussian LM fit's kernel (``csrc/gaussfit.cu``) at the main
    path's shapes: the single monitor's float32 fit (12, 20) and its
    float64 refit, the fleet's float32 fit (768, 20), each against the
    plain loop on the card: one launch a fit, and every lane's parameters,
    cost and converged flag and the LM counts the plain loop's bit for bit
    (the kernel sums in the card's order at these shapes); timed beside
    the plain loop and the bound.  The refit is timed as the estimate calls it (only the suspect
    lanes unmasked) and with every lane refit.  Returns the kernel rows,
    each naming the main path (``path``) whose launches ``main`` reads."""
    import torch

    from respmon_tpu_torch.config import MeasureConfig
    from respmon_tpu_torch.ops import _build, gaussfit
    from respmon_tpu_torch.utils import bench

    cut = MeasureConfig().gaussian_cutoff
    single32, single64 = _fit_windows(dev, 1)
    fleet32, _ = _fit_windows(dev, GAUSSFIT_STREAMS)
    t32, y32, m32 = single32
    every_lane64 = (t32.double(), y32.double(), m32)

    def plain(t, y, m, iters=200):
        with bench.span("bpm.fit") as rec:
            return gaussfit._fit_loop(t, y, m, iters, None, None, rec)

    def recorded(fn):
        """``fn()``'s result and the counts of the bpm.fit span it
        closed last."""
        bench.enable()
        try:
            out = fn()
        finally:
            bench.disable()
        return out, dict(bench._ring[-1].counts)

    rows = []
    for name, args, iters, path in (
            ("single_f32", single32, 200, "monitor_640x480_flow"),
            ("fleet_f32", fleet32, 200, "fleet_1080p_streaming"),
            ("single_f64_refit", single64[:3], 500, "monitor_640x480_flow"),
            ("single_f64_every_lane", every_lane64, 500,
             "monitor_640x480_flow")):
        t, y, m = args
        before = _build.LAUNCHES["gauss_fit"]
        got = gaussfit.gaussian_fit_batch(t, y, m, iters=iters)
        launches = _build.LAUNCHES["gauss_fit"] - before
        want, plain_counts = recorded(lambda: plain(t, y, m, iters))
        _, counts = recorded(lambda: gaussfit.gaussian_fit_batch(
            t, y, m, iters=iters))
        same = torch.ones_like(got.converged)
        for g, w in zip(got, want):
            same &= (g == w) | (g != g) & (w != w)   # NaN equal to NaN
        lanes, w = m.numel() // m.shape[-1], m.shape[-1]
        item = y.element_size()
        n_bytes = lanes * w * (2 * item + 1) + lanes * (4 * item + 1 + 4)
        # The slowest lane's chain, at least: each iteration's two passes
        # over W (38 operations a sample for the residual, Jacobian and
        # normal sums, 9 for the trial cost), exp and division counted as
        # one operation each, the Newton steps not counted.
        chain_s = counts["steps"] * w * 47 / SM_CLOCK_HZ
        by_bytes = n_bytes / PEAK_BYTES_S * 1e3
        by_chain = chain_s * 1e3
        _, plain_s = wall_s(lambda: plain(t, y, m, iters))
        rows.append({
            "name": f"gauss_fit_{str(y.dtype)[6:]}", "route": "cuda",
            "source": GAUSSFIT_CU,
            "replaces": "none: the JAX package's vmap of while_loop in XLA",
            "case": name, "shape": list(m.shape), "iters": iters,
            "path": path, "launches_a_fit": launches, "lm_counts": counts,
            "plain_lm_counts": plain_counts,
            "kept_lanes": int((got.converged & (got.dev < cut)).sum()),
            "lanes": lanes, "lanes_bit_equal": int(same.sum()),
            "ms": cuda_ms(lambda: gaussfit.gaussian_fit_batch(
                t, y, m, iters=iters), calls=KERNEL_CALLS),
            "ms_one_call": cuda_ms(lambda: gaussfit.gaussian_fit_batch(
                t, y, m, iters=iters)),
            "plain_ms": plain_s * 1e3, "bound_ms": max(by_bytes, by_chain),
            "bound_by": "bytes" if by_bytes >= by_chain
                        else "the slowest lane's serial chain",
            "library_ms": None})
    emit({"phase": "gaussfit", "rows": rows})
    for r in rows:
        case = r["case"]
        check(r["launches_a_fit"] == 1, f"{case}: one launch a fit")
        check(r["lanes_bit_equal"] == r["lanes"],
              f"{case}: {r['lanes_bit_equal']} of {r['lanes']} lanes the "
              f"plain loop's bit for bit")
        check(r["lm_counts"] == r["plain_lm_counts"],
              f"{case}: the kernel's LM counts {r['lm_counts']} are the "
              f"plain loop's {r['plain_lm_counts']}")
    return rows


CCL_CU = "respmon_tpu_torch/csrc/ccl.cu"
# The connected-component search's shapes on the main path: the 64 x 1080p
# fleet's coarse localize (level 4), a 640x480 and a 1080p calibration.
CCL_SHAPES = ((64, 68, 120, "fleet_1080p_streaming"),
              (1, 480, 640, "monitor_recovery_640x480"),
              (1, 1080, 1920, "locate_1080p"))


def ccl_masks(dev, shape, kind, gen):
    """An (S, H, W) bool batch: ``sparse`` noise (10%), ``dense`` noise
    (55%, past 8-connected percolation: large winding components), or
    ``blobs`` (a 9x9 box mean of noise over 0.5, as a thresholded heatmap
    looks: a few large regions with holes)."""
    import torch
    import torch.nn.functional as F

    noise = torch.rand(shape, generator=gen, device=dev)
    if kind == "sparse":
        return noise < 0.1
    if kind == "dense":
        return noise < 0.55
    return F.avg_pool2d(noise[:, None], 9, 1, 4)[:, 0] > 0.5


def phase_ccl(dev):
    """The connected-component kernel (``csrc/ccl.cu``) at the main path's
    shapes (``CCL_SHAPES``) on sparse, dense and blob masks: one call of
    the library a batch, every field (x, y, w, h, found, area) the plain
    version's on the card bit for bit, timed beside the plain version and
    the bytes bound (the masks read once, the results written once).
    Returns the kernel rows."""
    import torch

    from respmon_tpu_torch.ops import _build, ccl

    gen = torch.Generator(device=dev).manual_seed(18)
    rows = []
    for s, h, w, path in CCL_SHAPES:
        for kind in ("sparse", "dense", "blobs"):
            fg = ccl_masks(dev, (s, h, w), kind, gen)
            before = _build.LAUNCHES["ccl"]
            got = ccl.largest_component_bbox_batch(fg)
            launches = _build.LAUNCHES["ccl"] - before
            parts, plain_s = wall_s(
                lambda: [ccl._largest_component_bbox(img) for img in fg])
            want = [torch.stack(f) for f in zip(*(b for b, _ in parts))]
            equal = torch.ones(s, dtype=torch.bool, device=dev)
            for g, v in zip(got, want):
                equal &= g == v
            n_bytes = s * h * w + s * (4 * 4 + 1 + 4)
            rows.append({
                "name": "ccl_largest_bbox", "route": "cuda",
                "source": CCL_CU,
                "replaces": "none: the JAX package's CCL is XLA "
                            "composition (respmon_tpu/ops/ccl.py)",
                "case": kind, "shape": [s, h, w], "path": path,
                "launches_a_batch": launches,
                "masks_bit_equal": int(equal.sum()), "masks": s,
                "found": int(got.found.sum()),
                "plain_sweeps": sum(n for _, n in parts),
                "ms": cuda_ms(lambda: ccl.largest_component_bbox_batch(fg),
                              calls=KERNEL_CALLS),
                "ms_one_call": cuda_ms(
                    lambda: ccl.largest_component_bbox_batch(fg)),
                "plain_ms": plain_s * 1e3,
                "bound_ms": n_bytes / PEAK_BYTES_S * 1e3,
                "bound_by": "bytes", "library_ms": None})
    emit({"phase": "ccl", "rows": rows})
    for r in rows:
        what = f"ccl {r['case']} {r['shape']}"
        check(r["launches_a_batch"] == 1, f"{what}: one library call a batch")
        check(r["masks_bit_equal"] == r["masks"],
              f"{what}: {r['masks_bit_equal']} of {r['masks']} masks the "
              f"plain version's bit for bit")
    return rows


def phase_kernels(dev):
    """Each stencil kernel and composition against its plain version on
    the card: equal bit for bit, and timed.  Returns the kernel rows and
    the launches of the L9/S1 parity run, the path of ``lap_level_f32``."""
    import torch

    from respmon_tpu_torch.ops import pyramid, pyramid_cuda as pc

    gen = torch.Generator(device=dev).manual_seed(0)

    def video(shape):
        return torch.rand(shape, generator=gen, device=dev)

    rows = []
    lap_path = None
    for shape, levels, skip in [((128, 480, 640), 9, 4),
                                ((128, 1080, 1920), 9, 4),
                                ((3, 135, 192), 7, 3), ((2, 5, 7), 3, 0),
                                ((4, 481, 643), 9, 4), ((4, 480, 640), 9, 1)]:
        v = video(shape)
        reset_launches()
        got = pc.laplacian_band_levels(v, levels, skip)
        torch.cuda.synchronize()
        launches = read_launches()
        planned = planned_launches(*shape[1:], levels, skip)
        check({k: launches[k] for k in planned} == planned,
              f"K1 {shape} L{levels}/S{skip} launched as planned: {launches}")
        if skip == 1:
            lap_path = launches
        err = max_abs(got, pc.laplacian_band_levels_ref(v, levels, skip))
        del got
        rows.append({"op": "laplacian_band_levels", "shape": shape,
                     "levels": levels, "skip": skip, "max_abs_err": err,
                     "plan": pc.plan(*shape[1:], levels, skip)._asdict(),
                     "launches": launches,
                     "ms": cuda_ms(lambda: pc.laplacian_band_levels(
                         v, levels, skip), calls=KERNEL_CALLS),
                     # The chain's device time without the host's.
                     "graph_ms": graph_ms(lambda: pc.laplacian_band_levels(
                         v, levels, skip), calls=KERNEL_CALLS),
                     "plain_ms": cuda_ms(lambda: pc.laplacian_band_levels_ref(
                         v, levels, skip), calls=KERNEL_CALLS)})
        del v
    for shape in [(8, 1080, 1920), (2, 135, 192)]:
        v = video(shape)
        for s1 in (1, 2, 3):
            err = max_abs([pc.gauss_level(v, s1)],
                          [pc.gauss_level_ref(v, s1)])
            rows.append({"op": "gauss_level", "shape": shape, "s1": s1,
                         "max_abs_err": err,
                         "ms": cuda_ms(lambda: pc.gauss_level(v, s1),
                                       calls=KERNEL_CALLS),
                         "plain_ms": cuda_ms(
                             lambda: pc.gauss_level_ref(v, s1),
                             calls=KERNEL_CALLS)})
        del v
    for row in rows:
        emit({"phase": "kernel_parity", **row})
        check(row["max_abs_err"] == 0.0, f"{row['op']} {row['shape']} "
              f"equals its plain version bit for bit")
    check(lap_path is not None and lap_path["lap_level"] > 0,
          f"the L9/S1 chain took the lap_level_f32 route: {lap_path}")

    # The kernels at the shapes their paths give them: A (d = 2) and B at
    # 640x480, A (d = 1) at level 2 of the 1080p locate, lap_level_f32 at
    # the kept level it would take at 640x480.
    v = video((128, 480, 640))
    g = pyramid.gaussian_pyramid(v, 9)
    g2, g4, g5 = g[2].contiguous(), g[4].contiguous(), g[5].contiguous()
    v1 = video((128, 270, 480))
    t_len = v.shape[0]

    def elems(level):
        return t_len * g[level].shape[1] * g[level].shape[2]

    # A pyrDown output: 5 column sums of 5 taps and one row sum, 9
    # operations each.  A Laplacian output: three H phases, one W phase
    # (<= 4 operations each), one subtraction.
    def down_bound(x, d):
        sizes = [x.shape[0] * hh * ww
                 for hh, ww in pyramid.pyramid_shapes(*x.shape[1:], d + 1)]
        return bound(4 * (sizes[0] + sizes[d]), 54 * sum(sizes[1:]))

    tail_bound = bound(4 * (elems(2) + sum(elems(lvl) for lvl in range(4, 8))),
                       54 * sum(elems(lvl) for lvl in range(3, 9))
                       + 17 * sum(elems(lvl) for lvl in range(4, 8)))
    lap_bound = bound(4 * (2 * g4.numel() + g5.numel()), 17 * g4.numel())

    # One pyrDown is one PyTorch call: a strided convolution whose reflect
    # padding is reflect-101, ceil(n/2) outputs from n >= 3.  Timed here
    # only (in full float32: the port turns TF32 off), to set beside A
    # (d = 1); no single call computes two levels, B or lap_level_f32.
    k5 = torch.tensor([1., 4., 6., 4., 1.], device=dev) / 16
    conv = torch.nn.Conv2d(1, 1, 5, stride=2, padding=2, bias=False,
                           padding_mode="reflect").to(dev)
    conv.weight.requires_grad_(False).copy_(torch.outer(k5, k5)[None, None])

    def library_pyr_down(x):
        return conv(x[:, None])[:, 0]

    # A with d = 2 is K1's first launch at 640x480; with d = 1 its second
    # at 1080p (and K2 at s1 = 1).
    def down_row(x, d):
        want = pc.gauss_level_ref(x, d)
        row = {"name": "pyr_down_levels_f32", "route": "cuda",
               "source": PYRAMID_CU, "replaces": f"{PALLAS}:314",
               "d": d, "counter": f"pyr_down_levels_d{d}",
               "shape": list(x.shape),
               "max_abs_err": max_abs([pc.pyr_down(x, d)], [want]),
               **kernel_times(lambda: pc.pyr_down(x, d),
                              lambda: pc.gauss_level_ref(x, d), graph=True),
               **down_bound(x, d), "library_ms": None}
        if d == 1:
            with torch.no_grad():
                row["library_max_abs_err"] = max_abs([library_pyr_down(x)],
                                                     [want])
                row["library_ms"] = cuda_ms(lambda: library_pyr_down(x),
                                            calls=KERNEL_CALLS)
            check(row["library_max_abs_err"] <= 1e-6,
                  "the convolution computes A's (d = 1) function")
        return row

    kernels = [
        down_row(v, 2),
        down_row(v1, 1),
        {"name": "pyr_tail_f32", "route": "cuda", "source": PYRAMID_CU,
         "replaces": f"{PALLAS}:314", "shape": list(g2.shape),
         "levels": 7, "first_kept": 2,
         "max_abs_err": max_abs(pc.pyr_tail(g2, 7, 2), [
             g[lvl] - pyramid.pyr_up(g[lvl + 1], tuple(g[lvl].shape[-2:]))
             for lvl in range(4, 8)]),
         **kernel_times(lambda: pc.pyr_tail(g2, 7, 2),
                        lambda: pc.laplacian_band_levels_ref(g2, 7, 2),
                        graph=True),
         **tail_bound, "library_ms": None},
        {"name": "lap_level_f32", "route": "cuda", "source": PYRAMID_CU,
         "replaces": f"{PALLAS}:314",
         "shape": list(g4.shape),
         "max_abs_err": max_abs(
             [pc.lap_level(g4, g5)],
             [g4 - pyramid.pyr_up(g5, tuple(g4.shape[-2:]))]),
         **kernel_times(
             lambda: pc.lap_level(g4, g5),
             lambda: g4 - pyramid.pyr_up(g5, tuple(g4.shape[-2:])),
             graph=True),
         **lap_bound, "library_ms": None},
    ]
    for k in kernels:
        check(k["max_abs_err"] == 0.0, f"{k['name']} equals its plain version")
    return kernels, lap_path


K3_TOL = 1e-5   # summation order differs from torch.matmul's and from K1's


def band_parity_cases(dev):
    """(name, side, (matrix or operator, video, minuend)) of the band
    kernels' corner cases: how the skipping follows the matrix's data, and
    the operands a 16-byte copy cannot take."""
    import numpy as np
    import torch

    from respmon_tpu_torch.ops import pyramid_mm as pm

    rng = np.random.default_rng(2)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def video(*shape, offset=0):
        # offset > 0: the frames start that many floats into an allocation,
        # so the first frame's base is not 16-byte aligned.
        flat = torch.from_numpy(rand(int(np.prod(shape)) + offset)).to(dev)
        return flat[offset:].view(shape)

    def band(m, k):
        # Random values in a band around the diagonal of an (m, k) matrix.
        i, j = np.mgrid[:m, :k]
        return np.where(np.abs(j - i * k / m) <= 4, rand(m, k), 0.0).astype(
            np.float32)

    def operands(side, matrix, t_len, other, offset=0, minuend=False,
                 ranges=True):
        # matrix is (m, k) as it multiplies from the left; its transpose
        # multiplies from the right.
        a = matrix if side == "left" else np.ascontiguousarray(matrix.T)
        op = (pm.band_operator(a, side, dev) if ranges
              else torch.from_numpy(a).to(dev))
        m, k = matrix.shape
        if side == "left":
            b = video(t_len, k, other, offset=offset)
            sub = video(t_len, m, other) if minuend else None
        else:
            b = video(t_len, other, k, offset=offset)
            sub = video(t_len, other, m) if minuend else None
        return op, b, sub

    cases = []
    for side in ("left", "right"):
        dense = rand(150, 200)
        holed = band(200, 300)
        holed[64:128] = 0.0
        cases += [
            ("dense matrix, no ranges", side,
             operands(side, dense, 3, 136, ranges=False)),
            ("dense matrix, ranges from its values", side,
             operands(side, dense, 3, 136)),
            ("an all-zero tile", side, operands(side, holed, 2, 72)),
            ("band, aligned widths, frames 4 bytes off", side,
             operands(side, band(96, 192), 2, 64, offset=1))]
        cases.append(("more frames than a grid's z extent", side,
                      operands(side, band(2, 4), 65_539, 6)))
        cases += [
            (f"({t_len},{k},{other}), widths not multiples of 4", side,
             operands(side, band((k + 1) // 2, k), t_len, other, offset=3))
            for t_len, k, other in [(2, 5, 7), (3, 9, 15)]]
    cases += [
        ("minuend with ranges", "right",
         operands("right", band(160, 320), 3, 100, minuend=True)),
        ("minuend, odd widths", "right",
         operands("right", band(7, 13), 2, 9, minuend=True))]
    return cases


def phase_band_parity(dev):
    """Each corner case of the band kernels against torch.matmul, to rtol
    1e-5 of the result's largest magnitude."""
    import torch

    from respmon_tpu_torch.ops import pyramid_mm as pm

    for name, side, (a, b, minuend) in band_parity_cases(dev):
        matrix = a.matrix if isinstance(a, pm.BandOperator) else a
        if side == "left":
            got, want = pm.band_left(a, b), torch.matmul(matrix, b)
        else:
            got = pm.band_right(b, a, minuend)
            want = pm._matmul_right(b, matrix, minuend)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        ranges = (a.ranges.tolist() if isinstance(a, pm.BandOperator)
                  else None)
        emit({"phase": "kernel_parity", "op": f"band_{side}", "case": name,
              "shapes": [list(matrix.shape), list(b.shape)],
              "ranges": ranges, "max_abs_err": err, "scale": scale})
        check(err <= K3_TOL * scale, f"band_{side}, {name}: within "
              f"{K3_TOL} x {scale} of torch.matmul (got {err})")


def phase_kernels_k3(dev):
    """The band-matrix pyramid (K3) against its plain version (the same
    chain through torch.matmul) and against the stencil kernels (K1)."""
    import torch

    from respmon_tpu_torch.ops import pyramid_cuda as pc, pyramid_mm as pm

    phase_band_parity(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape, levels, skip in [((128, 480, 640), 9, 4),
                                ((8, 1080, 1920), 9, 4),
                                ((3, 135, 192), 7, 3), ((2, 5, 7), 3, 0)]:
        v = torch.rand(shape, generator=gen, device=dev)
        got = pm.laplacian_band_levels_mm(v, levels, skip)
        torch.cuda.synchronize()
        row = {"op": "laplacian_band_levels_mm", "shape": shape,
               "levels": levels, "skip": skip,
               "max_abs_err": max_abs(
                   got, pm.laplacian_band_levels_mm_ref(v, levels, skip)),
               "max_abs_err_vs_k1": max_abs(
                   got, pc.laplacian_band_levels(v, levels, skip)),
               "ms": cuda_ms(lambda: pm.laplacian_band_levels_mm(
                   v, levels, skip)),
               "matmul_ms": cuda_ms(lambda: pm.laplacian_band_levels_mm_ref(
                   v, levels, skip)),
               "k1_ms": cuda_ms(lambda: pc.laplacian_band_levels(
                   v, levels, skip)),
               # The chains are 5 to 28 launches, launched more slowly than
               # the card runs them: replayed from a graph they show the
               # device's own time.
               "graph_ms": graph_ms(lambda: pm.laplacian_band_levels_mm(
                   v, levels, skip)),
               "matmul_graph_ms": graph_ms(
                   lambda: pm.laplacian_band_levels_mm_ref(v, levels, skip)),
               "k1_graph_ms": graph_ms(lambda: pc.laplacian_band_levels(
                   v, levels, skip))}
        emit({"phase": "kernel_parity", **row})
        check(row["max_abs_err"] <= K3_TOL,
              f"K3 {shape} within {K3_TOL} of its plain version")
        check(row["max_abs_err_vs_k1"] <= K3_TOL,
              f"K3 {shape} within {K3_TOL} of K1")
        del v, got

    # The two kernels at the first (largest) products of the 640x480 chain,
    # called as the chain calls them (with the operators' ranges), and the
    # minuend form at its first kept level.  The matrices are sparse (<= 5
    # nonzeros a row): the bound counts the operations their nonzeros
    # need, not those of the dense product.
    v = torch.rand((128, 480, 640), generator=gen, device=dev)
    dh, dw_t, uh, uw_t = pm._operators(480, 640, 9, 4, v.device)
    left_a, left_b = dh[0], v
    right_b, right_a = pm.band_left(left_a, left_b), dw_t[0]
    g4 = pc.gauss_level(v, 4)
    up_h = pm.band_left(uh[0], pc.pyr_down(g4))
    err_minuend = max_abs([pm.band_right(up_h, uw_t[0], g4)],
                          [g4 - torch.matmul(up_h, uw_t[0].matrix)])
    check(err_minuend <= K3_TOL, "band_right with a minuend")

    def product_bound(a, t_len, m, k, n, rows_per_nonzero):
        """Bound of a (m,k)x(k,n) product per frame with the sparse shared
        matrix ``a``: each nonzero meets ``rows_per_nonzero`` values of the
        batched operand."""
        n_bytes = 4 * (a.numel() + t_len * (m * k + k * n + m * n)
                       - t_len * a.numel())
        needed = 2.0 * int((a != 0).sum()) * rows_per_nonzero * t_len
        return bound(n_bytes, needed)

    t_len = v.shape[0]
    m, k = left_a.matrix.shape
    n = left_b.shape[2]
    n2 = right_a.matrix.shape[1]
    kernels = [
        {"name": "band_left_f32", "route": "cuda", "source": BAND_CU,
         "replaces": f"{PALLAS}:216",
         "shape": [list(left_a.matrix.shape), list(left_b.shape)],
         "max_abs_err": max_abs([pm.band_left(left_a, left_b)],
                                [torch.matmul(left_a.matrix, left_b)]),
         **kernel_times(lambda: pm.band_left(left_a, left_b),
                        lambda: torch.matmul(left_a.matrix, left_b)),
         **product_bound(left_a.matrix, t_len, m, k, n, n)},
        {"name": "band_right_f32", "route": "cuda", "source": BAND_CU,
         "replaces": f"{PALLAS}:216",
         "shape": [list(right_b.shape), list(right_a.matrix.shape)],
         "max_abs_err": max(err_minuend, max_abs(
             [pm.band_right(right_b, right_a)],
             [torch.matmul(right_b, right_a.matrix)])),
         **kernel_times(lambda: pm.band_right(right_b, right_a),
                        lambda: torch.matmul(right_b, right_a.matrix)),
         **product_bound(right_a.matrix, t_len, m, n, n2, m)},
    ]
    # What a call costs on the host: a product too small to occupy the
    # card, called many times without waiting for it.
    tiny = torch.rand((2, 8, 8), generator=gen, device=dev)
    tiny_op = pm.band_operator(pm._np_down_matrix(8), "left", dev)
    emit({"phase": "host_us_per_call",
          "band_left": host_us_per_call(
              lambda: pm.band_left(tiny_op, tiny), 2000),
          "torch.matmul": host_us_per_call(
              lambda: torch.matmul(tiny_op.matrix, tiny), 2000)})

    for kern in kernels:
        # torch.matmul is both the plain version and the one library call
        # that computes the same function.
        kern["library_ms"] = kern["plain_ms"]
        check(kern["max_abs_err"] <= K3_TOL,
              f"{kern['name']} within {K3_TOL} of torch.matmul")
    return kernels


class pyramid_route:
    """Route evm's Laplacian levels through ``fn`` (by default the plain
    version, on any device) inside the ``with`` block."""

    def __init__(self, fn=None):
        self._fn = fn

    def __enter__(self):
        from respmon_tpu_torch.ops import pyramid_cuda

        self._saved = pyramid_cuda.laplacian_band_levels
        pyramid_cuda.laplacian_band_levels = \
            self._fn or pyramid_cuda.laplacian_band_levels_ref
        return self

    def __exit__(self, *exc):
        from respmon_tpu_torch.ops import pyramid_cuda

        pyramid_cuda.laplacian_band_levels = self._saved
        return False


def _same_run(a, b, what: str, bpm_rtol: float = 1e-5) -> float:
    """Check two ClipRunResults agree; return max relative BPM gap."""
    check(a.found and b.found, f"{what}: both found an ROI")
    check(a.roi == b.roi, f"{what}: ROI {a.roi} == {b.roi}")
    ha, hb = a.measure.has_bpm.cpu(), b.measure.has_bpm.cpu()
    check(bool((ha == hb).all()), f"{what}: has_bpm equal")
    ba, bb = a.measure.bpm.cpu()[ha], b.measure.bpm.cpu()[hb]
    rel = float(((ba - bb).abs() / bb.abs()).max()) if int(ha.sum()) else 0.0
    check(rel <= bpm_rtol, f"{what}: BPM within rtol {bpm_rtol} (got {rel})")
    return rel


def _bbox(r):
    import torch

    return [int(v) for v in torch.stack([r.x, r.y, r.w, r.h]).tolist()]


def _bpm_checks(m, cfg):
    """Finite BPM estimates; (count, tail median, gap of the tail median to
    the scipy golden chain run on the same samples)."""
    import numpy as np
    # The repo's tests/ is no package; a site-packages ``tests`` would
    # shadow it, so the golden oracle package is imported from tests/.
    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    from golden import reference_numpy as golden

    has = m.has_bpm.cpu().numpy()
    bpm = m.bpm.cpu().numpy()
    check(has.any() and np.isfinite(bpm[has]).all(), "finite BPM estimates")
    tail_median = float(np.median(bpm[has][-10:]))

    samples = m.samples.cpu().numpy()
    t = m.t.cpu().numpy()
    n_ring = cfg.measure.buffer_length
    oracle = []
    for i in range(len(samples) - 10, len(samples)):
        lo = max(0, i + 1 - n_ring)
        ob, _, _, _ = golden.measure_bpm(samples[lo:i + 1], t[lo:i + 1], FPS)
        oracle.append(ob if ob is not None else np.nan)
    oracle_delta = abs(tail_median - float(np.nanmedian(oracle)))
    check(np.isfinite(oracle_delta), "finite bpm_oracle_delta")
    return int(has.sum()), tail_median, oracle_delta


def phase_small_cross_check(dev):
    """The fixture of the CPU parity tests on the card against the CPU
    (the plain path the tests hold against the JAX package), with the FFT
    and with the IIR temporal filter."""
    import dataclasses

    import torch

    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm, scan

    cfg = MonitorConfig(calibration=CalibrationConfig(
        buffer_length=64, pyramid_levels=6, skip_levels_at_top=2))
    clip = breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    on_card = scan.process_clip(clip, FPS, cfg)
    check(on_card.measure.samples.device.type == "cuda",
          "process_clip(numpy) runs on the card by default")
    on_cpu = scan.process_clip(clip, FPS, cfg, device="cpu")
    rel = _same_run(on_card, on_cpu, "120x160 card vs CPU")
    # The IIR temporal filter: the same ROI, has_bpm and BPM on the card.
    iir = dataclasses.replace(cfg, calibration=dataclasses.replace(
        cfg.calibration, temporal_filter="iir"))
    iir_card = scan.process_clip(clip, FPS, iir)
    iir_cpu = scan.process_clip(clip, FPS, iir, device="cpu")
    rel_iir = _same_run(iir_card, iir_cpu, "120x160 IIR card vs CPU")

    const = torch.full((32, 48, 64), 0.5, device=dev)
    found = bool(evm.locate(const, FPS, CalibrationConfig(
        pyramid_levels=4, skip_levels_at_top=1, buffer_length=32)).found)
    check(not found, "constant video gives found=False on the card")
    emit({"phase": "small_cross_check", "roi": on_card.roi,
          "bpm_max_rel_vs_cpu": rel, "constant_video_found": found,
          "iir_roi": iir_card.roi, "iir_bpm_max_rel_vs_cpu": rel_iir})


def _fixture(num_frames: int):
    """The 640x480 clip of bench.py:116-125, ``num_frames`` long."""
    from respmon_tpu_torch.io.synthetic import breathing_clip

    return breathing_clip(num_frames=num_frames, height=480, width=640,
                          fps=FPS, bpm=18.0, patch_center=(240, 320),
                          patch_size=(80, 100), amplitude=0.12,
                          motion_px=2.0, texture_motion=True)


def slice_frames(dev):
    """The 640x480 u8 fixture of bench.py:116-125 on the card: frame 0
    (the monitor's initialize step), 128 calibration frames, 1 dropped at
    the locate, 127 measured."""
    import torch

    from respmon_tpu_torch.config import MonitorConfig

    cal_len = MonitorConfig().calibration.buffer_length
    return torch.from_numpy(quantize(_fixture(cal_len + 1 + 128))).to(dev)


# The live monitor's clip: frame 0, 128 calibration frames, 1 dropped, 64
# measured (80 before phase_bench, for the script's time).  The fed monitor
# runs the first FEEDER_MEASURED of them (60 before phase_bench); the direct
# run's first BPM comes at about the 49th.
MONITOR_FRAMES = 1 + 128 + 1 + 64
FEEDER_MEASURED = 54
# The flow profiler pass's clip: 24 measured frames.
PROFILE_FRAMES = 1 + 128 + 1 + 24

# The recovery clip: 1 + 128 calibration frames + 1 dropped, 16 measured
# (30 before phase_bench, for the script's time), a 15-frame blackout, then
# room to recalibrate (1 + 128 + 1) and to measure until a BPM comes again.
RECOVERY_FRAMES = 400
RECOVERY_BLACKOUT_AT = 16


def recovery_frames():
    """The 640x480 u8 clip of the recovery phase, on the host."""
    return quantize(_fixture(RECOVERY_FRAMES))


def phase_slice(frames):
    """process_clip at 640x480 u8, average mode."""
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.ops import filters
    from respmon_tpu_torch.pipeline import evm, motion, scan

    cfg = MonitorConfig()
    cal_len = cfg.calibration.buffer_length

    reset_launches()
    res, first_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    launches = read_launches()
    check_k1_path(launches, "the average slice")
    with pyramid_route():
        plain = scan.process_clip(frames, FPS, cfg)
    check(pyramid_launches(read_launches()) == pyramid_launches(launches),
          "plain run launched no stencil or band kernel")
    rel = _same_run(res, plain, "640x480 kernels vs plain")

    m = res.measure
    check(m.samples.shape == (frames.shape[0] - cal_len - 2,),
          "one sample per measured frame")
    check(bool(torch.isfinite(m.samples).all()), "samples finite")
    n_has, tail_median, oracle_delta = _bpm_checks(m, cfg)

    # One warm run, split into its two stages.
    x, y, w, h = res.roi
    cal = frames[1:cal_len + 1]
    rest = frames[cal_len + 2:]
    spec = motion.MeasureSpec.for_roi(cfg, 480, 640, w, h, FPS)
    coeffs = filters.design_butter_lowpass(
        cfg.calibration.freq_max * 0.5, FPS, cfg.measure.filter_order)
    _, warm_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    _, locate_s = wall_s(lambda: evm.locate(cal, FPS, cfg.calibration).x)
    _, measure_s = wall_s(lambda: scan.measure_clip(
        rest, res.roi, spec, coeffs, 10, cfg.measure).bpm)
    emit({"phase": "slice_640x480", "frames": list(frames.shape),
          "roi": res.roi, "launches": launches, "has_bpm": n_has,
          "bpm_tail_median": tail_median, "bpm_oracle_delta": oracle_delta,
          "bpm_max_rel_vs_plain": rel, "first_process_clip_s": first_s,
          "process_clip_s": warm_s, "locate_s": locate_s,
          "measure_s": measure_s})
    return res.roi, launches


def phase_k3_locate(frames, roi):
    """One 640x480 calibration with the band-matrix pyramid (K3) in place
    of the stencil kernels: the same ROI, through K3's kernels."""
    from respmon_tpu_torch.config import CalibrationConfig
    from respmon_tpu_torch.ops import pyramid_cuda, pyramid_mm
    from respmon_tpu_torch.pipeline import evm

    cfg = CalibrationConfig()
    cal = frames[1:cfg.buffer_length + 1]
    reset_launches()
    with pyramid_route(pyramid_mm.laplacian_band_levels_mm):
        res, first_s = wall_s(lambda: evm.locate(cal, FPS, cfg))
    launches = read_launches()
    check(launches["band_left"] > 0 and launches["band_right"] > 0,
          f"the K3 calibration launched both band kernels: {launches}")
    check(not any(launches[k] for k in pyramid_cuda.KERNELS.counted),
          "the K3 calibration launched no stencil kernel")
    check(bool(res.found), "K3 locate found an ROI")
    check(tuple(_bbox(res)) == tuple(roi),
          f"K3 locate ROI {_bbox(res)} equals K1's {roi}")
    with pyramid_route(pyramid_mm.laplacian_band_levels_mm):
        _, k3_s = wall_s(lambda: evm.locate(cal, FPS, cfg).x)
    _, k1_s = wall_s(lambda: evm.locate(cal, FPS, cfg).x)
    emit({"phase": "k3_locate_640x480", "roi": _bbox(res),
          "launches": launches, "first_locate_s": first_s,
          "locate_s": k3_s, "k1_locate_s": k1_s})
    return launches


# Flow fixture of the card-vs-CPU check; see phase_flow_slice.
FLOW_SMALL = dict(num_frames=64 + 1 + 90, height=120, width=160, fps=FPS,
                  bpm=18.0, patch_center=(60, 80), patch_size=(30, 40),
                  amplitude=0.12, motion_px=2.0, texture_motion=True, seed=1)


def phase_flow_slice(frames, roi):
    """process_clip at 640x480 u8, flow mode; and the 120x160 fixture on
    the card against the CPU."""
    import numpy as np
    import torch

    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.ops import corners, filters, lk
    from respmon_tpu_torch.pipeline import evm, motion, scan

    cfg = MonitorConfig(motion_extraction_method="flow")
    cal_len = cfg.calibration.buffer_length

    reset_launches()
    res, first_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    launches = read_launches()
    check_k1_path(launches, "the flow slice")
    check(res.found and res.roi == tuple(roi),
          f"flow ROI {res.roi} equals the average slice's {roi}")
    check(res.error_frame is None, f"no tracking loss ({res.error_frame})")
    m = res.measure
    check(m.samples.shape == (frames.shape[0] - cal_len - 2,),
          "one sample per measured frame")
    check(bool(torch.isfinite(m.samples).all()), "flow samples finite")
    n_has, tail_median, oracle_delta = _bpm_checks(m, cfg)
    check(abs(tail_median - 18.0) <= 1.0,
          f"flow tail median BPM {tail_median} within 1 of 18")
    tracked = int(m.final_state.pts_valid.sum())
    check(tracked >= 1, "at least one point tracked to the end")

    # A warm run, then its stages one by one.
    cal = frames[1:cal_len + 1]
    rest = frames[cal_len + 2:]
    x, y, w, h = res.roi
    spec = motion.MeasureSpec.for_roi(cfg, 480, 640, w, h, FPS)
    coeffs = filters.design_butter_lowpass(
        cfg.calibration.freq_max * 0.5, FPS, cfg.measure.filter_order)
    crops, mask = motion.crop_clip_and_mask(rest, res.roi, spec)
    crop0 = torch.where(mask, crops[0], 0).to(torch.float32)
    _, warm_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    _, locate_s = wall_s(lambda: evm.locate(cal, FPS, cfg.calibration).x)
    cs, corners_s = wall_s(lambda: corners.good_features_to_track(
        crop0, max_corners=spec.features.max_corners,
        quality_level=spec.features.quality_level,
        min_distance=spec.features.min_distance,
        block_size=spec.features.block_size, roi_mask=mask))
    n_corners = int(cs.count)
    check(n_corners >= 1, "at least one corner on the first frame")
    # The Newton iterations that run are counted on this staged call.
    track, lk_iterations = lk.lk_track_precomputed, []

    def counted_track(*args, **kwargs):
        fr = track(*args, **kwargs)
        lk_iterations.append(fr.iterations)
        return fr

    lk.lk_track_precomputed = counted_track
    (samples, _, _), flow_s = wall_s(
        lambda: scan._flow_samples_clip(crops, mask, spec))
    lk.lk_track_precomputed = track
    check(len(lk_iterations) == rest.shape[0] - 1, "one LK call per frame")
    _, trace_s = wall_s(lambda: scan.bpm_trace(
        samples, FPS, coeffs, 10, cfg.measure)[0])

    # The 120x160 fixture on the card against the CPU.  Float32 tracking
    # amplifies rounding from frame to frame (sums run in another order on
    # the card), so samples are held to the BPM they give, not bit for bit.
    small_cfg = MonitorConfig(
        motion_extraction_method="flow", calibration=CalibrationConfig(
            buffer_length=64, pyramid_levels=6, skip_levels_at_top=2))
    clip = breathing_clip(**FLOW_SMALL)
    on_card = scan.process_clip(clip, FPS, small_cfg)
    on_cpu = scan.process_clip(clip, FPS, small_cfg, device="cpu")
    check(on_card.found and on_card.roi == on_cpu.roi,
          f"120x160 flow ROI {on_card.roi} == {on_cpu.roi}")
    check(on_card.error_frame is None and on_cpu.error_frame is None,
          "120x160 flow: no tracking loss")
    sa, sb = on_card.measure.final_state, on_cpu.measure.final_state
    check(torch.equal(sa.pts_valid.cpu(), sb.pts_valid),
          "120x160 flow: the same points survive on the card and the CPU")
    ha, hb = on_card.measure.has_bpm.cpu(), on_cpu.measure.has_bpm
    check(torch.equal(ha, hb), "120x160 flow: has_bpm equal")
    gap = float((on_card.measure.bpm.cpu()[ha]
                 - on_cpu.measure.bpm[hb]).abs().max())
    check(gap <= 0.5, f"120x160 flow: BPM within 0.5 of the CPU's ({gap})")
    sample_gaps = (on_card.measure.samples.cpu()
                   - on_cpu.measure.samples).abs()
    over = (sample_gaps > 1e-3).nonzero().flatten()

    emit({"phase": "flow_640x480", "frames": list(frames.shape),
          "roi": res.roi, "launches": launches, "corners": n_corners,
          "tracked_at_end": tracked,
          "lk_level_passes": len(lk_iterations) * (spec.lk.max_level + 1),
          "lk_iterations": sum(lk_iterations), "has_bpm": n_has,
          "bpm_tail_median": tail_median, "bpm_oracle_delta": oracle_delta,
          "first_process_clip_s": first_s, "process_clip_s": warm_s,
          "locate_s": locate_s, "corners_s": corners_s,
          "precompute_and_lk_loop_s": flow_s - corners_s,
          "bpm_trace_s": trace_s,
          "small_120x160": {"roi": on_card.roi,
                            "tracked_at_end": int(sa.pts_valid.sum()),
                            "bpm_max_abs_vs_cpu": gap,
                            "samples_max_abs_vs_cpu": float(
                                sample_gaps.max()),
                            "first_frame_over_1e-3_vs_cpu":
                                int(over[0]) if len(over) else None,
                            "samples_max_abs": float(np.abs(
                                on_cpu.measure.samples.numpy()).max())}})
    return launches


def phase_flow_profile(frames):
    """One profiler pass over a warm flow-mode process_clip: launches and
    the device's busy share.  The profiler records the device's activity
    only: the host ops' events would add a million more for it to gather
    and take minutes, and nothing here reads them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.pipeline import scan

    cfg = MonitorConfig(motion_extraction_method="flow")
    _, plain_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, profiled_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    n_kernels = 0
    device_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            device_us += ev.time_range.elapsed_us()
    check(device_us > 0, "the profiler saw device activity")
    emit({"phase": "flow_profile", "frames": list(frames.shape),
          "process_clip_s": plain_s,
          "profiled_process_clip_s": profiled_s,
          "device_kernels_and_copies": n_kernels,
          "device_busy_s": device_us / 1e6,
          "device_idle_share_unprofiled": 1.0 - device_us / 1e6 / plain_s})


def check_k1_calibrations(launches, calibrations: int, what: str) -> None:
    """Each 640x480 calibration of a monitor ran K1 as its plan says: one
    A (d = 2) and one B, and nothing else of the chain."""
    check(calibrations >= 1
          and launches["pyr_down_levels_d2"] == calibrations
          and launches["pyr_tail"] == calibrations
          and launches["pyr_down_levels_d1"] == 0
          and launches["lap_level"] == 0,
          f"{what}: A (d = 2) and B once per calibration "
          f"({calibrations}): {launches}")


def _ms_stats(seconds) -> dict:
    import numpy as np

    ms = np.asarray(seconds) * 1e3
    return {"median": float(np.median(ms)),
            "p95": float(np.percentile(ms, 95)), "max": float(ms.max()),
            "n": int(ms.size)}


def drive_monitor(mon, after_step=None):
    """Step a monitor to the end of its stream, or until
    ``after_step(mon, steps)`` returns true.  Per step: the state it
    started in, the state it ended in, ``step()``'s host time (it ends in a
    host read of the frame's results) and the time a device synchronise
    takes right after it (device work the step left behind)."""
    import torch

    steps = []
    torch.cuda.synchronize()
    while True:
        before = mon.state
        t0 = time.perf_counter()
        more = mon.step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not more:
            break
        steps.append({"before": before, "after": mon.state,
                      "step_s": t1 - t0, "left_s": t2 - t1})
        if after_step is not None and after_step(mon, steps):
            break
    mon.stop_feeder()
    mon.cap.release()
    return steps


def monitor_report(mon, steps) -> dict:
    """The live loop's numbers: the calibration stall (the step that ran
    ``locate``), per measured frame the step's host time, the measured
    frames per second, and the Benchmarker's tags."""
    import numpy as np

    cal = [s["step_s"] for s in steps
           if s["before"] == "calibration" and s["after"] != "calibration"]
    measured = [s["step_s"] for s in steps if s["before"] == "measure"]
    left = [s["left_s"] for s in steps]
    tags = {tag: {"mean_ms": float(np.mean(v)) * 1e3 if v else None,
                  "count": len(v)}
            for tag, v in mon.benchmarker.ticks.items()}
    return {"calibration_step_ms": [c * 1e3 for c in cal],
            "measured_step_ms": _ms_stats(measured),
            "measured_fps": len(measured) / sum(measured),
            "sync_after_step_ms": _ms_stats(left),
            "benchmarker": tags}


class split_timer:
    """Inside the ``with`` block, time each call of the monitor's motion
    step, its BPM estimate and the estimate's two Gaussian-fit loops (the
    float32 fit and the float64 refit of wild fits), and in streaming-ROI
    mode each absorb into the rings, each localize over them and each
    re-lock, each to the end of its device work; and count each fit's LM
    steps (the ``steps`` count of its ``bpm.fit`` span: the most any lane
    ran).
    With ``fleet``, the same of the fleet's batched functions (the motion
    step of S streams, with or without the carried LK cache; the absorb of
    S frames; the localize of S rings; the masked re-lock).
    ``report()`` gives each one's ms per call and the LM steps per fit."""

    def __init__(self, fleet: bool = False):
        self.fleet = fleet
        self.seconds = {"motion_step": [], "estimate_bpm": [],
                        "gauss_fit_f32": [], "gauss_fit_f64": [],
                        "absorb": [], "localize": [], "relock": []}
        self.lm_steps = {"gauss_fit_f32": [], "gauss_fit_f64": []}

    def _timed(self, fn, name_of):
        import torch

        from respmon_tpu_torch.utils import bench

        def timed(*args, **kwargs):
            name = name_of(args)
            counted = name in self.lm_steps
            if counted:
                bench.enable()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                if counted:
                    bench.disable()
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            if counted:
                # The newest record is the fit's own bpm.fit span.
                self.lm_steps[name].append(bench._ring[-1].counts["steps"])
            return out
        return timed

    def __enter__(self):
        import torch

        from respmon_tpu_torch.ops import gaussfit
        from respmon_tpu_torch.pipeline import bpm, motion, streaming

        if self.fleet:
            timed = [(motion, "measure_step_batch", "motion_step"),
                     (motion, "measure_step_cached", "motion_step"),
                     (streaming, "streaming_absorb_batch", "absorb"),
                     (streaming, "localize_batch", "localize"),
                     (motion, "relock_state_batch", "relock")]
        else:
            timed = [(motion, "measure_step", "motion_step"),
                     (streaming, "streaming_absorb", "absorb"),
                     (streaming, "_localize_window", "localize"),
                     (motion, "relock_state", "relock")]
        timed.append((bpm, "estimate_bpm", "estimate_bpm"))
        self._saved = [(module, name, getattr(module, name))
                       for module, name, _ in timed]
        self._saved.append((gaussfit, "gaussian_fit_batch",
                            gaussfit.gaussian_fit_batch))
        for module, name, tag in timed:
            setattr(module, name, self._timed(getattr(module, name),
                                              lambda a, tag=tag: tag))
        gaussfit.gaussian_fit_batch = self._timed(
            gaussfit.gaussian_fit_batch,
            lambda a: "gauss_fit_f64" if a[0].dtype == torch.float64
            else "gauss_fit_f32")
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        return False

    def report(self) -> dict:
        out = {name: _ms_stats(v) for name, v in self.seconds.items() if v}
        for name, steps in self.lm_steps.items():
            if steps:
                out[f"{name}_lm_steps"] = {
                    "median": float(statistics.median(steps)),
                    "max": max(steps), "total": sum(steps)}
        return out


def make_monitor(frames, method, cfg, capture=None, **kw):
    """The port's monitor over ``frames`` (a host numpy clip) on the card,
    as a headless offline replay: no UI, no recording, no fps sync."""
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.runtime import RespiratoryMonitor

    return RespiratoryMonitor(
        capture_target="chip_smoke", save_all_data=False, visualize=None,
        motion_extraction_method=method, config=cfg,
        capture=capture or ArrayCapture(frames, fps=FPS), auto_run=False,
        sync_fps=False, **kw)


def phase_monitor(frames, cfg=None, device=None):
    """The live monitor on the 640x480 u8 clip (a host numpy array) in
    average and in flow mode, against ``process_clip`` on the same card
    (``device=None``).  Returns the launches of each run and the average
    run's monitor."""
    import dataclasses

    import numpy as np

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.pipeline import scan

    cfg = cfg or MonitorConfig()
    launches, monitors = {}, {}
    for method in ("average", "flow"):
        mcfg = dataclasses.replace(cfg, motion_extraction_method=method)
        clip = scan.process_clip(frames, FPS, mcfg, device=device)
        mon = make_monitor(frames, method, mcfg, device=device)
        reset_launches()
        with count_estimates() as estimates:
            steps = drive_monitor(mon)
        launches[method] = read_launches()
        calibrations = len(mon.benchmarker.ticks["Calibration Measurement"])
        check_k1_calibrations(launches[method], calibrations,
                              f"the {method} monitor")
        check_fit_launches(launches[method], estimates.n,
                           2 if mcfg.measure.f64_refine else 1,
                           f"the {method} monitor")
        check(calibrations == 1, f"{method} monitor calibrated once")
        check(mon.state == "measure", f"{method} monitor ends measuring")
        roi = (mon.x, mon.y, mon.w, mon.h)
        check(roi == clip.roi, f"{method} monitor ROI {roi} equals "
              f"process_clip's {clip.roi}")
        check(len(mon.freq) > 0 and np.isfinite(list(mon.freq)).all(),
              f"{method} monitor: finite BPM estimates")
        freq = np.asarray(mon.freq)
        has = clip.measure.has_bpm.cpu().numpy()
        clip_bpm = clip.measure.bpm.cpu().numpy()[has]
        row = {"phase": f"monitor_{method}", "frames": list(frames.shape),
               "roi": list(roi), "launches": launches[method],
               "calibrations": calibrations, "estimates": estimates.n,
               "bpm_count": len(freq),
               "last_bpm": float(freq[-1]),
               "process_clip_final_bpm": clip.final_bpm}
        if method == "average":
            rel = abs(freq[-1] - clip.final_bpm) / abs(clip.final_bpm)
            check(rel <= 1e-5, f"average monitor's last BPM {freq[-1]} "
                  f"within rtol 1e-5 of process_clip's {clip.final_bpm}")
            row["last_bpm_rel_vs_process_clip"] = float(rel)
        else:
            check(mon.error_message is None,
                  f"flow monitor: no error ({mon.error_message})")
            tail = float(np.median(freq[-10:]))
            clip_tail = float(np.median(clip_bpm[-10:]))
            check(abs(tail - 18.0) <= 1.0,
                  f"flow monitor tail median BPM {tail} within 1 of 18")
            check(abs(tail - clip_tail) <= 0.5,
                  f"flow monitor tail median BPM {tail} within 0.5 of "
                  f"process_clip's {clip_tail}")
            row.update(bpm_tail_median=tail,
                       process_clip_bpm_tail_median=clip_tail)
        report = monitor_report(mon, steps)
        # The bracket of each tag ends in a host read of the device's
        # results, so little device work is left after a step.
        check(report["sync_after_step_ms"]["median"] <= 1.0,
              f"{method} monitor: steps end with the device done "
              f"({report['sync_after_step_ms']})")
        emit({**row, **report})
        monitors[method] = mon
    return launches, monitors["average"]


def phase_monitor_recovery(frames, cfg=None, device=None, blackout_at=30,
                           blackout_len=15):
    """Flow mode through a blackout ``blackout_at`` measured frames in,
    ``blackout_len`` frames long, with no reset delay: the error state, a
    recalibration and BPM again.  Returns the run's launches and the
    frames from the fault to the first BPM after it."""
    import dataclasses

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.io.faults import FaultInjector, FaultSchedule

    cfg = dataclasses.replace(cfg or MonitorConfig(),
                              motion_extraction_method="flow")
    start = 1 + cfg.calibration.buffer_length + 1 + blackout_at
    src = FaultInjector(
        ArrayCapture(frames, fps=FPS),
        [FaultSchedule("blackout", start=start, end=start + blackout_len)])
    mon = make_monitor(None, "flow", cfg, capture=src,
                       error_reset_delay=0.0, device=device)
    seen = {"error": None, "bpm_again": None, "measure_again": None}

    def after_step(mon, steps):
        i = len(steps) - 1
        if seen["error"] is None and mon.state == "error":
            seen["error"] = i
        elif seen["error"] is not None:
            if seen["measure_again"] is None and mon.state == "measure":
                seen["measure_again"] = i
                seen["freq_at_recovery"] = len(mon.freq)
            if (seen["measure_again"] is not None
                    and seen["bpm_again"] is None
                    and len(mon.freq) > seen["freq_at_recovery"]):
                seen["bpm_again"] = i
        return seen["bpm_again"] is not None   # the run ends there

    reset_launches()
    # The run also times the parts of each measured frame; their extra
    # device synchronises add little to a step of tens of milliseconds.
    with split_timer() as split:
        steps = drive_monitor(mon, after_step)
    launches = read_launches()
    calibrations = len(mon.benchmarker.ticks["Calibration Measurement"])
    check(seen["error"] is not None, "the blackout led to the error state")
    check(seen["error"] >= start, "the error came with the blackout")
    check(seen["bpm_again"] is not None,
          f"measuring again with a new BPM after the error: {seen}")
    check(calibrations >= 2, f"recalibrated ({calibrations} calibrations)")
    check_k1_calibrations(launches, calibrations, "the recovery run")
    check_ccl_launches(launches, calibrations, "the recovery run")
    recover_s = sum(s["step_s"] for s in steps[start:seen["bpm_again"] + 1])
    report = monitor_report(mon, steps)
    emit({"phase": "monitor_recovery_flow", "frames": list(frames.shape),
          "blackout_frames": [start, start + blackout_len],
          "error_step": seen["error"],
          "measure_again_step": seen["measure_again"],
          "first_bpm_again_step": seen["bpm_again"],
          "fault_to_bpm_frames": seen["bpm_again"] - start + 1,
          "frames_stepped": len(steps),
          "fault_to_bpm_s": recover_s, "calibrations": calibrations,
          "launches": launches, "roi_after": [mon.x, mon.y, mon.w, mon.h],
          "error_message": mon.error_message, **report,
          "split_ms": split.report()})
    return launches, seen["bpm_again"] - start + 1


def phase_feeder(frames, average_mon, cfg=None, device=None, measured=60):
    """The native frame ring under the monitor: the library built from the
    checkout, every frame through a lossless ``FrameFeeder`` in order, and
    the average monitor fed through it over the clip's first ``measured``
    measured frames, where it must be where the direct run was then."""
    import numpy as np

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.io.native import load_native
    from respmon_tpu_torch.runtime.feeder import FrameFeeder

    lib = load_native()
    check(lib is not None, "the native frame ring library loaded")
    feeder = FrameFeeder(ArrayCapture(frames, fps=FPS), capacity=4,
                         lossless=True, dtype=frames.dtype).start()
    check(feeder.ring._lib is not None, "the feeder's ring is native")
    n, t0 = 0, time.perf_counter()
    while True:
        frame, seq = feeder.next_frame(latest=False)
        if frame is None:
            break
        check(seq == n and np.array_equal(frame, frames[n]),
              f"frame {n} arrived in order, intact (seq {seq})")
        n += 1
    ring_s = time.perf_counter() - t0
    feeder.stop()
    check(n == len(frames), f"all {len(frames)} frames arrived ({n})")

    cfg = cfg or MonitorConfig()
    head = frames[:1 + cfg.calibration.buffer_length + 1 + measured]
    mon = make_monitor(head, "average", cfg, use_feeder=True,
                       feeder_latest=False, device=device)
    # The run also times the parts of each measured frame, as the recovery
    # phase does in flow mode.
    with split_timer() as split:
        steps = drive_monitor(mon)
    roi = (mon.x, mon.y, mon.w, mon.h)
    want = (average_mon.x, average_mon.y, average_mon.w, average_mon.h)
    check(roi == want, f"fed monitor ROI {roi} equals the direct one's "
          f"{want}")
    check(0 < len(mon.freq) <= len(average_mon.freq)
          and list(mon.freq) == list(average_mon.freq)[:len(mon.freq)],
          "fed monitor BPM trace equals the direct one's up to its end")
    check(mon.frames_dropped == 0, "lossless feeder dropped nothing")
    emit({"phase": "feeder", "library": lib._name, "frames": n,
          "ring_s": ring_s, "roi": list(roi),
          "last_bpm": float(mon.freq[-1]),
          "measured_step_ms": monitor_report(mon, steps)[
              "measured_step_ms"], "split_ms": split.report()})


def k1_bound(t_len: int, h: int, w: int, levels: int, skip: int) -> dict:
    """The bound of one K1 call: the frames read once and the kept levels
    written once; 54 operations per pyrDown output of every level, 17 per
    kept Laplacian output (as ``phase_kernels`` counts them)."""
    from respmon_tpu_torch.ops.pyramid import pyramid_shapes

    sizes = [t_len * hh * ww for hh, ww in pyramid_shapes(h, w, levels)]
    kept = sum(sizes[skip:levels - 1])
    return bound(4 * (sizes[0] + kept), 54 * sum(sizes[1:]) + 17 * kept)


def phase_streaming_kernels(dev):
    """K1 at T = 1, the call of every frame the streaming rings absorb, at
    640x480 and 1080p (L9/S4): the plan's launches, bit-equality with the
    plain version, ms from CUDA events and from a graph, the host's time
    per call.  Returns the two kernel rows and the 1080p call's
    launches."""
    import torch

    from respmon_tpu_torch.ops import pyramid_cuda as pc

    gen = torch.Generator(device=dev).manual_seed(3)
    rows, launches_1080p = [], None
    for h, w, path in [(480, 640, "monitor_streaming_640x480_average"),
                       (1080, 1920, "streaming_kernels_1x1080x1920")]:
        levels, skip = 9, 4
        v = torch.rand((1, h, w), generator=gen, device=dev)
        reset_launches()
        got = pc.laplacian_band_levels(v, levels, skip)
        torch.cuda.synchronize()
        launches = read_launches()
        planned = planned_launches(h, w, levels, skip)
        check({k: launches[k] for k in planned} == planned
              and launches["pyr_down_levels_d2"] == 1
              and launches["pyr_tail"] == 1
              and launches["pyr_down_levels_d1"] == int(h == 1080),
              f"K1 (1,{h},{w}) launched A (d = 2){' + A (d = 1)' * (h == 1080)}"
              f" + B, as planned: {launches}")
        if h == 1080:
            launches_1080p = launches
        err = max_abs(got, pc.laplacian_band_levels_ref(v, levels, skip))
        check(err == 0.0, f"K1 (1,{h},{w}) equals its plain version bit "
              f"for bit (max |d| {err})")

        def call():
            return pc.laplacian_band_levels(v, levels, skip)

        row = {"name": "laplacian_band_levels (K1 at T = 1)",
               "kernels": ["pyr_down_levels_f32", "pyr_tail_f32"],
               "route": "cuda", "source": PYRAMID_CU,
               "replaces": f"{PALLAS}:314", "counter": "pyr_tail",
               "path": path, "shape": [1, h, w], "levels": levels,
               "skip": skip, "plan": pc.plan(h, w, levels, skip)._asdict(),
               "plan_launches": launches, "max_abs_err": err,
               **kernel_times(call, lambda: pc.laplacian_band_levels_ref(
                   v, levels, skip), graph=True),
               "host_us_per_call": host_us_per_call(call),
               **k1_bound(1, h, w, levels, skip), "library_ms": None}
        emit({"phase": "streaming_kernels", **row})
        rows.append(row)
        del v, got
    return rows, launches_1080p


# The streaming clips: the 640x480 u8 fixture's breathing patch drifting
# (dy, dx) = (30, 60) px over MONITOR_STREAM_FRAMES frames (frame 0, 128
# calibration frames, 1 dropped, 64 measured), from (225, 290) to
# (255, 350).
MONITOR_STREAM_FRAMES = 1 + 128 + 1 + 64
# The streaming monitors' clip: the same drift over 40 measured frames (64
# before phase_bench, for the script's time).
STREAM_MONITOR_FRAMES = 1 + 128 + 1 + 40
STREAM_START = (225, 290)
STREAM_DRIFT = (30.0, 60.0)


def streaming_frames(num_frames=MONITOR_STREAM_FRAMES, height=480,
                     width=640, start=STREAM_START, drift=STREAM_DRIFT,
                     patch_size=(80, 100)):
    """The u8 moving-subject clip of the streaming phases, on the host."""
    from respmon_tpu_torch.io.synthetic import breathing_clip

    return quantize(breathing_clip(
        num_frames=num_frames, height=height, width=width, fps=FPS,
        bpm=18.0, patch_center=start, patch_size=patch_size, amplitude=0.12,
        motion_px=2.0, texture_motion=True, drift_px=drift))


def phase_streaming(dev, cfg=None, static=None, moving=None):
    """The streaming localizer on the card: over a static 128-frame window
    it finds ``locate``'s bbox; over the moving clip every localize equals
    the plain-pyramid route in bbox and heatmap, and the coarse localize's
    box holds the full-resolution box's centre.  Times an absorb and a
    localize.  Returns the launches of the moving run."""
    import torch

    from respmon_tpu_torch.config import CalibrationConfig
    from respmon_tpu_torch.pipeline import evm, streaming

    cfg = cfg or CalibrationConfig()
    t_len = cfg.buffer_length
    if static is None:
        static = quantize(_fixture(t_len))
    if moving is None:
        moving = streaming_frames()[1:]
    static = torch.from_numpy(static).to(dev)
    h, w = static.shape[1:]
    state = streaming.init_streaming_state(h, w, cfg, device=dev)
    for frame in static[:-1]:
        state = streaming.streaming_absorb(state, frame, cfg)
    state, res = streaming.streaming_update(state, static[-1], FPS, cfg)
    want = evm.locate(static, FPS, cfg)
    check(bool(res.ready) and bool(res.found) and bool(want.found)
          and _bbox(res) == _bbox(want),
          f"streaming bbox {_bbox(res)} over a static window equals "
          f"locate's {_bbox(want)}")
    static_bbox = _bbox(res)
    del static, state

    frames = torch.from_numpy(moving).to(dev)
    reset_launches()
    state = streaming.init_streaming_from_buffer(frames[:t_len], cfg)
    with pyramid_route():
        plain = streaming.init_streaming_from_buffer(frames[:t_len], cfg)
    boxes, absorb_s, localize_s = [], [], []
    for i in range(t_len, frames.shape[0]):
        state, absorb = wall_s(lambda: streaming.streaming_absorb(
            state, frames[i], cfg))
        absorb_s.append(absorb)
        with pyramid_route():
            plain = streaming.streaming_absorb(plain, frames[i], cfg)
        if (i - t_len + 1) % 8:
            continue
        res, seconds = wall_s(lambda: streaming._localize_window(
            state, (h, w), torch.float32, FPS, cfg, False))
        localize_s.append(seconds)
        ref = streaming._localize_window(plain, (h, w), torch.float32, FPS,
                                         cfg, False)
        check(bool(res.found) and _bbox(res) == _bbox(ref)
              and torch.equal(res.heatmap_u8, ref.heatmap_u8),
              f"localize at frame {i}: {_bbox(res)} equals the plain "
              f"route's {_bbox(ref)}, heatmap too")
        boxes.append(_bbox(res))
    launches = read_launches()
    calls = 1 + frames.shape[0] - t_len
    planned = planned_launches(h, w, cfg.pyramid_levels,
                               cfg.skip_levels_at_top)
    check({k: launches[k] for k in planned}
          == {k: n * calls for k, n in planned.items()},
          f"one K1 warm start and one K1 per absorbed frame ({calls} "
          f"calls, each {planned}): {launches}")
    coarse = streaming._localize_window(state, (h, w), torch.float32, FPS,
                                        cfg, True)
    x, y, bw, bh = _bbox(coarse)
    fx, fy, fw, fh = boxes[-1]
    check(bool(coarse.found) and x <= fx + fw / 2 <= x + bw
          and y <= fy + fh / 2 <= y + bh,
          f"the coarse box {_bbox(coarse)} holds the centre of the full "
          f"box {boxes[-1]}")
    emit({"phase": "streaming_640x480", "static_bbox": static_bbox,
          "moving_frames": list(frames.shape), "bboxes": boxes,
          "coarse_bbox": _bbox(coarse), "launches": launches,
          "absorb_ms": _ms_stats(absorb_s),
          "localize_ms": _ms_stats(localize_s)})
    return launches


def check_k1_streaming(launches, mon, what: str) -> None:
    """A streaming monitor ran K1 once per cold locate and per warm start
    of its rings (T = 128) and once per frame its rings absorbed (T = 1),
    as read from the monitor's own counters; each call launched what its
    plan makes (A d = 2 and B at 640x480)."""
    cal = mon.config.calibration
    cold = (len(mon.benchmarker.ticks["Calibration Measurement"])
            - mon.streaming_absorbed["calibration"])
    calls = cold + mon.streaming_starts + sum(
        mon.streaming_absorbed.values())
    planned = planned_launches(mon.height, mon.width, cal.pyramid_levels,
                               cal.skip_levels_at_top)
    check(cold >= 1 and mon.streaming_starts == cold
          and {k: launches[k] for k in planned}
          == {k: n * calls for k, n in planned.items()},
          f"{what}: K1 {calls} times (2 x {cold} cold calibrations + "
          f"{mon.streaming_absorbed} frames absorbed), each {planned}: "
          f"{launches}")


def phase_monitor_streaming(frames, cfg=None, device=None,
                            final=(STREAM_START[0] + STREAM_DRIFT[0],
                                   STREAM_START[1] + STREAM_DRIFT[1])):
    """The monitor in streaming-ROI mode (default interval 8, drift 4 px)
    on the drifting clip (a host numpy array), in average and flow mode:
    it re-locks (at least twice in average mode, once in flow mode), keeps
    the subject's final centre inside the final ROI (average mode) and
    finite samples (flow mode), never errs, and K1 launches as the
    monitor's counters imply.  ``final`` is the subject's (y, x) centre on
    the last frame.  Returns the launches of each run."""
    import dataclasses

    import numpy as np

    from respmon_tpu_torch.config import MonitorConfig

    cfg = dataclasses.replace(cfg or MonitorConfig(), streaming_roi=True)
    launches = {}
    for method in ("average", "flow"):
        mcfg = dataclasses.replace(cfg, motion_extraction_method=method)
        mon = make_monitor(frames, method, mcfg, device=device)
        trail = []

        def after_step(mon, steps):
            trail.append((mon.relocks, [mon.x, mon.y, mon.w, mon.h]))
            return False

        reset_launches()
        with split_timer() as split:
            steps = drive_monitor(mon, after_step)
        launches[method] = read_launches()
        check_k1_streaming(launches[method], mon, f"the {method} monitor")
        check(mon.state == "measure" and mon.error_message is None,
              f"{method} streaming monitor: no error ({mon.error_message})")
        roi = [mon.x, mon.y, mon.w, mon.h]
        if method == "average":
            check(mon.relocks >= 2, f"average: {mon.relocks} re-locks")
            fy, fx = final
            check(mon.x <= fx <= mon.x + mon.w and mon.y <= fy
                  <= mon.y + mon.h,
                  f"the subject's final centre {final} lies in the final "
                  f"ROI {roi}")
        else:
            check(mon.relocks >= 1, f"flow: {mon.relocks} re-locks")
            check(np.isfinite(np.asarray(mon.data, float)).all(),
                  "flow streaming monitor: every sample finite")
        relock_steps = [i for i in range(1, len(trail))
                        if trail[i][0] > trail[i - 1][0]]
        measuring = next(i for i, s in enumerate(steps)
                         if s["after"] == "measure")
        emit({"phase": f"monitor_streaming_{method}",
              "frames": list(frames.shape), "relocks": mon.relocks,
              "relock_steps": relock_steps,
              # The calibrated ROI, then the ROI after each re-lock.
              "rois": [trail[measuring][1]]
              + [trail[i][1] for i in relock_steps],
              "final_subject_centre_yx": list(final),
              "streaming_absorbed": mon.streaming_absorbed,
              "streaming_starts": mon.streaming_starts,
              "launches": launches[method], "bpm_count": len(mon.freq),
              "last_bpm": float(mon.freq[-1]) if mon.freq else None,
              **monitor_report(mon, steps), "split_ms": split.report()})
    return launches


def phase_monitor_warm_recovery(frames, cfg=None, device=None,
                                blackout_at=30, blackout_len=15,
                                cold_fault_to_bpm=None):
    """``phase_monitor_recovery``'s blackout in streaming-ROI mode: the
    rings absorb the error wait's frames and the recalibration localizes
    from them (warm).  Records the frames and seconds from the fault to
    measurement and to the first BPM beside the cold recovery's
    (``cold_fault_to_bpm`` frames), and the ROI before and after.
    Returns the run's launches."""
    import dataclasses

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.io.faults import FaultInjector, FaultSchedule

    cfg = dataclasses.replace(cfg or MonitorConfig(),
                              motion_extraction_method="flow",
                              streaming_roi=True)
    start = 1 + cfg.calibration.buffer_length + 1 + blackout_at
    src = FaultInjector(
        ArrayCapture(frames, fps=FPS),
        [FaultSchedule("blackout", start=start, end=start + blackout_len)])
    mon = make_monitor(None, "flow", cfg, capture=src,
                       error_reset_delay=0.0, device=device)
    seen = {"error": None, "bpm_again": None, "measure_again": None,
            "roi_before": None}

    def after_step(mon, steps):
        i = len(steps) - 1
        if seen["error"] is None:
            if mon.state == "error":
                seen["error"] = i
            else:
                seen["roi_before"] = [mon.x, mon.y, mon.w, mon.h]
        else:
            if seen["measure_again"] is None and mon.state == "measure":
                seen["measure_again"] = i
                seen["freq_at_recovery"] = len(mon.freq)
            if (seen["measure_again"] is not None
                    and seen["bpm_again"] is None
                    and len(mon.freq) > seen["freq_at_recovery"]):
                seen["bpm_again"] = i
        return seen["bpm_again"] is not None   # the run ends there

    reset_launches()
    with split_timer() as split:
        steps = drive_monitor(mon, after_step)
    launches = read_launches()
    check(seen["error"] is not None and seen["error"] >= start,
          f"the blackout led to the error state: {seen}")
    check(seen["bpm_again"] is not None,
          f"measuring again with a new BPM after the error: {seen}")
    check(mon.streaming_absorbed["error"] >= 1,
          f"the rings absorbed the error wait: {mon.streaming_absorbed}")
    check_k1_streaming(launches, mon, "the warm recovery run")
    emit({"phase": "monitor_warm_recovery_flow",
          "frames": list(frames.shape),
          "blackout_frames": [start, start + blackout_len],
          "error_step": seen["error"],
          "measure_again_step": seen["measure_again"],
          "first_bpm_again_step": seen["bpm_again"],
          "fault_to_measure_frames": seen["measure_again"] - start + 1,
          "fault_to_measure_s": sum(s["step_s"] for s in
                                    steps[start:seen["measure_again"] + 1]),
          "fault_to_bpm_frames": seen["bpm_again"] - start + 1,
          "fault_to_bpm_s": sum(s["step_s"] for s in
                                steps[start:seen["bpm_again"] + 1]),
          "cold_fault_to_bpm_frames": cold_fault_to_bpm,
          "warm_calibration_steps": mon.streaming_absorbed["calibration"],
          "streaming_absorbed": mon.streaming_absorbed,
          "frames_stepped": len(steps), "relocks": mon.relocks,
          "roi_before": seen["roi_before"],
          "roi_after": [mon.x, mon.y, mon.w, mon.h],
          "launches": launches, "error_message": mon.error_message,
          **monitor_report(mon, steps), "split_ms": split.report()})
    return launches


def phase_iir_locate(frames, fft_roi):
    """One 640x480 calibration with ``temporal_filter="iir"``: its bbox
    beside the FFT calibration's, its time, K1's launches, and the device
    kernels and copies that its ``sosfilt`` over the kept levels issues
    (counted by the profiler)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from respmon_tpu_torch.config import CalibrationConfig
    from respmon_tpu_torch.ops.dtype import uint8_to_float
    from respmon_tpu_torch.pipeline import evm

    cfg = dataclasses.replace(CalibrationConfig(), temporal_filter="iir")
    cal = frames[1:cfg.buffer_length + 1]
    reset_launches()
    res, first_s = wall_s(lambda: evm.locate(cal, FPS, cfg))
    launches = read_launches()
    check_k1_path(launches, "the IIR calibration")
    check(bool(res.found), "the 640x480 IIR calibration found an ROI")
    _, locate_s = wall_s(lambda: evm.locate(cal, FPS, cfg).x)
    lap = evm._band_laplacian_levels(uint8_to_float(cal), cfg)
    _, sosfilt_s = wall_s(lambda: evm._bandpass_iir_levels(lap, FPS, cfg))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        evm._bandpass_iir_levels(lap, FPS, cfg)
        torch.cuda.synchronize()
    kernels = sum(1 for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    check(kernels > 0, "the profiler saw the IIR bandpass's kernels")
    emit({"phase": "iir_locate_640x480", "roi": _bbox(res),
          "fft_roi": list(fft_roi), "launches": launches,
          "first_locate_s": first_s, "locate_s": locate_s,
          "bandpass_iir_s": sosfilt_s,
          "bandpass_iir_columns": sum(v[0].numel() for v in lap.values()),
          "bandpass_iir_device_kernels_and_copies": kernels})


def phase_1080p(dev):
    import torch

    from respmon_tpu_torch.config import CalibrationConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm

    cfg = CalibrationConfig()
    clip = breathing_clip(num_frames=cfg.buffer_length, height=1080,
                          width=1920, fps=FPS, bpm=18.0,
                          patch_center=(540, 960), patch_size=(180, 225),
                          amplitude=0.12)
    frames = torch.from_numpy(quantize(clip)).to(dev)
    del clip

    reset_launches()
    res = evm.locate(frames, FPS, cfg)
    launches = read_launches()
    planned = planned_launches(1080, 1920, cfg.pyramid_levels,
                               cfg.skip_levels_at_top)
    check({k: launches[k] for k in planned} == planned
          and planned["pyr_down_levels_d1"] == 1
          and planned["pyr_down_levels_d2"] == 1 and planned["pyr_tail"] == 1,
          f"the 1080p locate launched A (d = 2), A (d = 1) and B once each, "
          f"as planned: {launches}")
    check_ccl_launches(launches, 1, "the 1080p locate")
    check(bool(res.found), "1080p locate found an ROI")
    with pyramid_route():
        plain = evm.locate(frames, FPS, cfg)
    check(_bbox(res) == _bbox(plain), "1080p ROI equals the plain path's")
    roi = _bbox(res)
    _, locate_s = wall_s(lambda: evm.locate(frames, FPS, cfg).x)
    with pyramid_route():
        _, plain_s = wall_s(lambda: evm.locate(frames, FPS, cfg).x)
    emit({"phase": "locate_1080p", "frames": list(frames.shape),
          "roi": _bbox(res), "launches": launches, "locate_s": locate_s,
          "plain_locate_s": plain_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, roi, frames


# The fleet: 4 streams at 640x480, one breathing patch each at its own
# centre (y, x) and rate; frame 0, 128 calibration frames, 1 dropped, then
# FLEET_MEASURED measured.  Below 18 BPM two periods do not fit in so few
# frames and the estimate misses by more than 1: over 96 frames the JAX
# fleet reads 14.3 for 12 BPM and 17.1 for 15 at stream 0, as the port does
# on the CPU and on the card (tests/jax_fleet_fixture_bpm.py).  Cut from 80
# to 72 for the script's time: over 72 the port reads 18.18, 20.69, 23.53
# and 26.67 on the CPU (over 64, 23.08 for 24: too near the bound).
FLEET_BPMS = (18.0, 21.0, 24.0, 27.0)
FLEET_CENTRES = ((150, 190), (150, 450), (330, 190), (330, 450))
FLEET_MEASURED = 72
# The streaming fleet: each subject drifts (dy, dx) over its clip.
FLEET_DRIFTS = ((30.0, 60.0), (30.0, -60.0), (-30.0, 60.0), (-30.0, -60.0))
FLEET_STREAM_MEASURED = 24
# The deployment of bench.py's main_multistream: 64 streams of 1080p.
FLEET_1080P_STREAMS = 64


def fleet_clips(num_frames, drifts=None, height=480, width=640,
                centres=FLEET_CENTRES, bpms=FLEET_BPMS,
                patch_size=(80, 100)):
    """The fleet's u8 clips, (S, T, H, W) on the host: the 640x480 fixture
    of bench.py:116-125 with one breathing patch per stream at its centre
    and rate (``centres``, ``bpms``), moving by ``drifts`` over the clip
    when given.  One thread per stream makes them."""
    import numpy as np

    from respmon_tpu_torch.io.synthetic import breathing_clip

    drifts = drifts or [(0.0, 0.0)] * len(bpms)

    def one(i):
        return quantize(breathing_clip(
            num_frames=num_frames, height=height, width=width, fps=FPS,
            bpm=bpms[i], patch_center=centres[i], patch_size=patch_size,
            amplitude=0.12, motion_px=2.0, texture_motion=True,
            drift_px=drifts[i], seed=i))

    with ThreadPoolExecutor(len(bpms)) as pool:
        return np.stack(list(pool.map(one, range(len(bpms)))))


def fleet_step(mon, frames, stale=None):
    """One fleet step ending in one host read of its (S,) results: a
    (4, S) float64 array of samples, BPM, has_bpm and error."""
    import torch

    res = mon.step(frames, stale=stale)
    return torch.stack([res.samples.double(), res.bpm.double(),
                        res.has_bpm.double(),
                        res.error.double()]).cpu().numpy()


def check_k1_fleet(launches, mon, what: str) -> None:
    """A fleet ran K1 once per single-stream locate, once per chunk of each
    warm start of its rings (T = S * 128 frames in chunks) and once per
    absorbed (S, H, W) batch, as read from the monitor's own counters;
    each call launched what its plan makes."""
    from respmon_tpu_torch.pipeline import streaming

    cal = mon.cfg.calibration
    h, w = mon.frame_hw
    s = len(mon._rois)
    chunk = max(1, streaming.WARM_START_CHUNK_BYTES // (4 * h * w))
    calls = (mon.locates
             + mon.streaming_starts * -(-s * cal.buffer_length // chunk)
             + mon.streaming_absorbed)
    planned = planned_launches(h, w, cal.pyramid_levels,
                               cal.skip_levels_at_top)
    check(calls >= 1 and {k: launches[k] for k in planned}
          == {k: n * calls for k, n in planned.items()},
          f"{what}: K1 {calls} times ({mon.locates} locates, "
          f"{mon.streaming_starts} warm starts, {mon.streaming_absorbed} "
          f"absorbs), each {planned}: {launches}")


def _fleet_fits(cfg) -> int:
    """The Gaussian fits of one fleet estimate: the float32 fit, and the
    float64 refit only with ``fleet_f64_refine``."""
    return 2 if cfg.fleet_f64_refine and cfg.measure.f64_refine else 1


def phase_fleet(clips, cfg=None, device=None, bpms=FLEET_BPMS):
    """The multi-stream fleet in flow mode on the 4 x 640x480 u8 clips (a
    host array, staged on the device first): ``calibrate`` on frames
    1..128, then one ``step`` per measured frame.  Each box equals the
    single-stream ``locate`` of that stream's buffer, on the kernels and
    on the plain pyramid; every stream reaches a BPM whose tail median is
    within 1 of its fixture's rate (``bpms``).  Returns the run's
    launches, each step's (4, S) results and the boxes."""
    import numpy as np
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import streams
    from respmon_tpu_torch.pipeline import evm

    cfg = cfg or MonitorConfig(motion_extraction_method="flow")
    cal_len = cfg.calibration.buffer_length
    frames = torch.from_numpy(clips).to(device or "cuda")
    s = frames.shape[0]
    mon = streams.MultiStreamMonitor(cfg, None, tuple(frames.shape[2:]),
                                     FPS, device=device)
    reset_launches()
    with count_estimates() as estimates:
        loc, cal_s = wall_s(lambda: mon.calibrate(frames[:, 1:cal_len + 1]))
        rows, step_s = [], []
        with split_timer(fleet=True) as split:
            for f in range(cal_len + 2, frames.shape[1]):
                t0 = time.perf_counter()
                rows.append(fleet_step(mon, frames[:, f]))
                step_s.append(time.perf_counter() - t0)
    launches = read_launches()
    check_k1_fleet(launches, mon, "the fleet")
    check_fit_launches(launches, estimates.n, _fleet_fits(cfg), "the fleet")
    boxes = loc.boxes.cpu().tolist()
    check(bool(loc.found.all()), f"every stream found an ROI: {boxes}")
    for i in range(s):
        one = _bbox(evm.locate(frames[i, 1:cal_len + 1], FPS,
                               cfg.calibration))
        with pyramid_route():
            plain = _bbox(evm.locate(frames[i, 1:cal_len + 1], FPS,
                                     cfg.calibration))
        check(boxes[i] == one == plain,
              f"stream {i}: fleet box {boxes[i]} equals the single-stream "
              f"locate's {one} and the plain route's {plain}")
    res = np.stack(rows)                      # (steps, 4, S)
    bpm, has, err = res[:, 1], res[:, 2] > 0, res[:, 3] > 0
    tails = [float(np.median(bpm[has[:, i], i][-10:]))
             if has[:, i].any() else None for i in range(s)]
    stats = _ms_stats(step_s)
    emit({"phase": "fleet_640x480_flow", "streams": s,
          "frames": list(frames.shape), "boxes": boxes,
          "launches": launches, "locates": mon.locates,
          "estimates": estimates.n, "calibrate_s": cal_s, "step_ms": stats,
          "stream_frames_per_s": s / (stats["median"] / 1e3),
          "bpm_tail_median": tails, "fixture_bpm": list(bpms),
          "bpm_count": has.sum(axis=0).tolist(),
          "errors": err.sum(axis=0).tolist(), "split_ms": split.report()})
    check(not err.any(), f"no stream lost tracking: {err.sum(axis=0)}")
    for i in range(s):
        check(tails[i] is not None and abs(tails[i] - bpms[i]) <= 1.0,
              f"stream {i}: tail median BPM {tails[i]} within 1 of "
              f"{bpms[i]}")
    return launches, res, boxes


def _full_rings(mon, s, n, device, seed=0):
    """Install full signal rings in a fleet's states (a sine at 0.3 Hz a
    stream, its phase from a seed, and a little noise), as bench.py's
    fleet bench does before timing: a deployed fleet's every step fits
    the peaks of 128-sample rings."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / FPS
    phases = rng.uniform(0, 2 * np.pi, s).astype(np.float32)
    ring = (0.15 * np.sin(2 * np.pi * 0.3 * t[None, :] + phases[:, None])
            + 0.01 * rng.standard_normal((s, n)).astype(np.float32))
    full = torch.full((s,), n, dtype=torch.int32, device=device)
    mon.states = mon.states._replace(
        data=torch.from_numpy(ring).to(device),
        t=torch.from_numpy(np.broadcast_to(t, (s, n)).copy()).to(device),
        count=full, motion_count=full)


def phase_fleet_cross_check(device=None, steps=2):
    """A small fleet (3 streams at 120x160) on the card against the CPU,
    after the same calibration and with the same full rings installed: in
    average mode equal ROIs and has_bpm and BPM within rtol 1e-5, in
    float32 flow mode equal ROIs and BPM within 1 (float32 tracking
    drifts between the two, ROADMAP.md queue 3)."""
    import numpy as np

    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.parallel import streams

    cal = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    clips = np.stack([breathing_clip(
        num_frames=64 + 1 + steps, height=120, width=160, fps=FPS, bpm=bpm,
        patch_center=(60, 80), patch_size=(30, 40), amplitude=0.12,
        motion_px=2.0, texture_motion=True, seed=i)
        for i, bpm in enumerate((15.0, 18.0, 21.0))])
    out = {}
    for method in ("average", "flow"):
        cfg = MonitorConfig(calibration=cal, motion_extraction_method=method)
        runs = {}
        for where in (device, "cpu"):
            mon = streams.MultiStreamMonitor(cfg, None, (120, 160), FPS,
                                             device=where)
            mon.calibrate(clips[:, :64])
            _full_rings(mon, 3, cfg.measure.buffer_length, mon.device)
            runs[where] = (mon, [fleet_step(mon, clips[:, 65 + k])
                                 for k in range(steps)])
        (card, a), (cpu, b) = runs[device], runs["cpu"]
        check(device is not None or card.device.type == "cuda",
              "the fleet runs on the card by default")
        check(np.array_equal(card._rois, cpu._rois)
              and np.array_equal(card.states.roi.cpu().numpy(),
                                 cpu.states.roi.numpy()),
              f"{method}: ROIs {card._rois.tolist()} equal the CPU's")
        a, b = np.stack(a), np.stack(b)
        has = a[:, 2] > 0
        check(has.any(), f"{method}: the small fleet reached a BPM")
        if method == "average":
            check(np.array_equal(has, b[:, 2] > 0),
                  f"{method}: has_bpm equal")
            gap = float(np.max(np.abs(a[:, 1][has] - b[:, 1][has])
                               / np.abs(b[:, 1][has])))
            check(gap <= 1e-5, f"{method}: BPM within rtol 1e-5 ({gap})")
        else:
            both = has & (b[:, 2] > 0)
            gap = float(np.max(np.abs(a[:, 1][both] - b[:, 1][both])))
            check(gap <= 1.0, f"{method}: BPM within 1 of the CPU's ({gap})")
        out[method] = {"rois": card._rois.tolist(), "bpm_gap": gap,
                       "samples_max_abs_vs_cpu": float(np.nanmax(
                           np.abs(a[:, 0] - b[:, 0])))}
    emit({"phase": "fleet_cross_check_120x160", "streams": 3,
          "steps": steps, **out})


class absorb_checker:
    """Inside the ``with`` block, hold every fleet warm start and every
    absorb (``streaming.init_streaming_from_buffers_batch``,
    ``streaming_absorb_batch``) against the same call on the plain pyramid,
    bit for bit; ``calls`` counts them, and ``absorb_s`` holds each
    absorb's own time (to the end of its device work, the check left
    out)."""

    def __enter__(self):
        import torch

        from respmon_tpu_torch.pipeline import streaming

        self.calls = 0
        self.absorb_s = []
        self._saved = [(name, getattr(streaming, name)) for name in
                       ("init_streaming_from_buffers_batch",
                        "streaming_absorb_batch")]

        def checked(name, fn):
            def call(*args, **kwargs):
                out, seconds = wall_s(lambda: fn(*args, **kwargs))
                if name == "streaming_absorb_batch":
                    self.absorb_s.append(seconds)
                with pyramid_route():
                    ref = fn(*args, **kwargs)
                check(all(torch.equal(a, b) for a, b in
                          zip(out.levels, ref.levels)),
                      f"{name} equals its plain version bit for bit")
                self.calls += 1
                return out
            return call

        for name, fn in self._saved:
            setattr(streaming, name, checked(name, fn))
        return self

    def __exit__(self, *exc):
        from respmon_tpu_torch.pipeline import streaming

        for name, fn in self._saved:
            setattr(streaming, name, fn)
        return False


def phase_fleet_streaming(clips, cfg=None, device=None,
                          centres=FLEET_CENTRES, drifts=FLEET_DRIFTS):
    """The fleet in streaming-ROI mode (coarse localize every 8 steps,
    drift 4 px) on 4 drifting 640x480 u8 subjects (a host array), in
    average and in flow mode: no stream errs, the fleet re-locks at least
    4 times, each subject's final centre lies in its final ROI, the
    device's ROIs equal the host's mirror, the warm start and every absorb
    equal their plain versions bit for bit, and K1 launches as the
    monitor's counters imply.  Returns the launches of each run."""
    import dataclasses

    import numpy as np
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import streams

    cfg = dataclasses.replace(cfg or MonitorConfig(), streaming_roi=True)
    cal_len = cfg.calibration.buffer_length
    frames = torch.from_numpy(clips).to(device or "cuda")
    s = frames.shape[0]
    finals = [(c[0] + d[0], c[1] + d[1]) for c, d in zip(centres, drifts)]
    launches = {}
    for method in ("average", "flow"):
        mcfg = dataclasses.replace(cfg, motion_extraction_method=method)
        mon = streams.MultiStreamMonitor(mcfg, None,
                                         tuple(frames.shape[2:]), FPS,
                                         device=device)
        reset_launches()
        errors, step_s, trail = 0, [], []
        # The checker wraps first, so the split's absorb times wrap it.
        with absorb_checker() as absorbs, split_timer(fleet=True) as split:
            _, cal_s = wall_s(lambda: mon.calibrate(
                frames[:, 1:cal_len + 1]))
            trail.append(mon._rois.tolist())
            for f in range(cal_len + 2, frames.shape[1]):
                t0 = time.perf_counter()
                res = fleet_step(mon, frames[:, f])
                step_s.append(time.perf_counter() - t0)
                errors += int((res[3] > 0).sum())
                if mon._rois.tolist() != trail[-1]:
                    trail.append(mon._rois.tolist())
        launches[method] = read_launches()
        check_k1_fleet(launches[method], mon, f"the {method} fleet")
        check(absorbs.calls == 1 + mon.streaming_absorbed,
              f"{method}: the warm start and {mon.streaming_absorbed} "
              f"absorbs held to the plain pyramid ({absorbs.calls})")
        check(errors == 0, f"{method}: no stream erred ({errors})")
        check(mon.relocks >= 4, f"{method}: {mon.relocks} re-locks")
        for i, (fy, fx) in enumerate(finals):
            x, y, w, h = mon._rois[i]
            check(x <= fx <= x + w and y <= fy <= y + h,
                  f"{method}: stream {i}'s final centre {(fy, fx)} lies in "
                  f"its final ROI {mon._rois[i].tolist()}")
        check(np.array_equal(mon.states.roi.cpu().numpy(), mon._rois),
              f"{method}: the device's ROIs equal the host's mirror")
        # The split's absorb holds the plain check too; the checker times
        # the absorb alone.
        split_ms = split.report()
        split_ms["absorb"] = _ms_stats(absorbs.absorb_s)
        emit({"phase": f"fleet_streaming_640x480_{method}", "streams": s,
              "frames": list(frames.shape), "relocks": mon.relocks,
              "rois": trail, "final_subject_centres_yx": finals,
              "launches": launches[method], "calibrate_s": cal_s,
              "streaming_absorbed": mon.streaming_absorbed,
              "step_ms": _ms_stats(step_s), "split_ms": split_ms})
    return launches


def phase_fleet_1080p(roi, buffer, device=None,
                      streams_n=FLEET_1080P_STREAMS, cfg=None):
    """bench.py's main_multistream (bench.py:771-899) on the card: the
    1080p locate's box tiled over 64 streams, three u8 (64,1080,1920)
    batches rolled by 0, 1 and 2 px so LK does real work, full rings
    installed before timing.  Times the step over 4 steps with one host
    read at the end (``phase_bench``'s ``--multistream`` times 10) and over
    2 with a read after every step, the float64
    refit tier over 3 steps (its LM steps counted), and in streaming-ROI mode
    the step with an absorb (K1 at (64,1080,1920), held to the plain
    pyramid on one batch) and with a coarse update, on rings warm-started
    from ``buffer`` (the 1080p locate's u8 (128, 1080, 1920) clip) tiled
    over the streams, so every ring is full and ready as a deployment's
    are.  Returns the streaming run's launches."""
    import dataclasses

    import numpy as np
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import streams
    from respmon_tpu_torch.pipeline import motion, streaming

    cfg = dataclasses.replace(cfg or MonitorConfig(),
                              motion_extraction_method="flow")
    h_f, w_f = buffer.shape[1:]
    s = streams_n
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    boxes = np.tile(np.asarray([roi], np.int32), (s, 1))
    spec = motion.MeasureSpec.for_roi(cfg, h_f, w_f, roi[2], roi[3], FPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.trunc((torch.rand((s, h_f, w_f), generator=gen,
                                   device=dev) * 0.2 + 0.4) * 255.0)
    batches = [torch.roll(base, k, dims=2).to(torch.uint8) for k in range(3)]
    del base

    def fleet(c):
        mon = streams.MultiStreamMonitor(c, None, (h_f, w_f), FPS,
                                         device=device)
        mon.spec = spec
        mon.states = streams.init_stream_states(spec, boxes, device=device)
        mon._rois = boxes.copy()
        return mon

    def steps(mon, n, read_each, first=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            res = mon.step(batches[(first + i) % 3])
            if read_each:
                res.samples.cpu()
        res.samples.cpu()
        return (time.perf_counter() - t0) / n

    mon = fleet(cfg)
    first_s = [steps(mon, 1, True, i) for i in range(3)]   # corners first
    _full_rings(mon, s, cfg.measure.buffer_length, dev)
    steps(mon, 1, True)              # the LK cache's rebuild step
    pipelined = steps(mon, 4, False, 1)
    read_each = steps(mon, 2, True, 2)

    # The float64 refit tier from the same states.
    cfg64 = dataclasses.replace(cfg, fleet_f64_refine=True)
    mon64 = fleet(cfg64)
    mon64.states, mon64._needs_init = mon.states, False
    with split_timer(fleet=True) as split64:
        f64_steps = [steps(mon64, 1, True, i) for i in range(3)]
    lm64 = split64.report()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 \
        if dev.type == "cuda" else None

    # Streaming ROI every 4 steps: 3 steps with an absorb, then one with a
    # coarse update, on rings warm-started from the tiled calibration clip
    # (K1 over the (64 * 128, 1080, 1920) stack in chunks).
    mons = fleet(dataclasses.replace(cfg, streaming_roi=True,
                                     streaming_interval=4))
    mons.states, mons._needs_init = mon.states, False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mons._streaming, warm_s = wall_s(
        lambda: streams.init_fleet_streaming_from_buffers(
            buffer[None].expand((s,) + tuple(buffer.shape)),
            cfg.calibration))
    check(bool((mons._streaming.count == cfg.calibration.buffer_length)
               .all()), "the 64 x 1080p rings are full after the warm start")
    reset_launches()
    with count_estimates() as estimates, \
            split_timer(fleet=True) as splits:
        stream_steps = [steps(mons, 1, True, i)
                        for i in range(mons.cfg.streaming_interval)]
    launches = read_launches()
    check_k1_fleet(launches, mons, "the 64 x 1080p streaming fleet")
    check_fit_launches(launches, estimates.n, _fleet_fits(mons.cfg),
                       "the 64 x 1080p streaming fleet")
    check_ccl_launches(launches, len(splits.seconds["localize"])
                       + mons.locates, "the 64 x 1080p streaming fleet")
    ring0 = streams.init_fleet_streaming((h_f, w_f), cfg.calibration, s,
                                         device=device)
    got = streaming.streaming_absorb_batch(ring0, batches[0],
                                           cfg.calibration)
    with pyramid_route():
        ref = streaming.streaming_absorb_batch(ring0, batches[0],
                                               cfg.calibration)
    err = max_abs(got.levels, ref.levels)
    check(err == 0.0, f"K1 at ({s},{h_f},{w_f}) equals its plain version "
          f"bit for bit (max |d| {err})")
    rep = splits.report()
    emit({"phase": "fleet_1080p_flow", "streams": s, "roi": list(roi),
          "crop": [spec.crop_h, spec.crop_w],
          "first_steps_ms": [x * 1e3 for x in first_s],
          "step_ms_pipelined": pipelined * 1e3,
          "step_ms_read_each": read_each * 1e3,
          "stream_frames_per_s": s / pipelined,
          "realtime_margin_at_10fps": (1.0 / FPS) / pipelined,
          "f64_refine": {"step_ms": [x * 1e3 for x in f64_steps],
                         "stream_frames_per_s": s / statistics.median(
                             f64_steps),
                         "realtime_margin_at_10fps": (1.0 / FPS)
                         / statistics.median(f64_steps),
                         "split_ms": lm64},
          "streaming": {"warm_start_s": warm_s,
                        "absorb_step_ms": [x * 1e3
                                           for x in stream_steps[:-1]],
                        "update_step_ms": stream_steps[-1] * 1e3,
                        "relocks": mons.relocks, "launches": launches,
                        "estimates": estimates.n,
                        "split_ms": rep,
                        "peak_mem_gb": torch.cuda.max_memory_allocated()
                        / 1e9 if dev.type == "cuda" else None},
          "k1_absorb_max_abs_err": err, "peak_mem_gb": peak_gb})
    return launches


def phase_fleet_kernels(dev):
    """K1 at the fleet's shapes: the absorb of 4 640x480 frames and of 64
    1080p frames (T = S), and the warm start of 4 streams' 128 frames
    (T = S * 128, one chunk): bit-equality with the plain version, ms from
    CUDA events, the plain version's ms and the bound."""
    import torch

    from respmon_tpu_torch.ops import pyramid_cuda as pc

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for t_len, h, w, path in [
            (4, 480, 640, "fleet_streaming_640x480_flow"),
            (512, 480, 640, "fleet_streaming_640x480_flow"),
            (FLEET_1080P_STREAMS, 1080, 1920, "fleet_1080p_streaming")]:
        levels, skip = 9, 4
        v = torch.rand((t_len, h, w), generator=gen, device=dev)
        got = pc.laplacian_band_levels(v, levels, skip)
        err = max_abs(got, pc.laplacian_band_levels_ref(v, levels, skip))
        check(err == 0.0, f"K1 ({t_len},{h},{w}) equals its plain version "
              f"bit for bit (max |d| {err})")
        del got

        def call():
            return pc.laplacian_band_levels(v, levels, skip)

        def plain():
            return pc.laplacian_band_levels_ref(v, levels, skip)

        row = {"name": f"laplacian_band_levels (K1 at T = {t_len})",
               "kernels": ["pyr_down_levels_f32", "pyr_tail_f32"],
               "route": "cuda", "source": PYRAMID_CU,
               "replaces": f"{PALLAS}:314", "counter": "pyr_tail",
               "path": path, "shape": [t_len, h, w], "levels": levels,
               "skip": skip, "max_abs_err": err,
               "ms": cuda_ms(call, repeats=5, calls=2),
               "plain_ms": cuda_ms(plain, repeats=3),
               **k1_bound(t_len, h, w, levels, skip), "library_ms": None}
        emit({"phase": "fleet_kernels", **row})
        rows.append(row)
        del v
    return rows


def phase_fleet_feeder(clips, fleet_rows, fleet_boxes, cfg=None,
                       device=None, ticks=8, live_ticks=4):
    """``FleetFeeder`` over 4 ``ArrayCapture`` sources of the fleet's clips
    (frame 0 left out, as the monitor's initialize step eats it).  Lossless:
    ``collect_buffer(128)`` is the clips' calibration frames and calibrates
    the fleet to ``phase_fleet``'s boxes; after the dropped frame, ``ticks``
    batches give ``phase_fleet``'s first ``ticks`` steps bit for bit.  Live:
    ``live_ticks`` freshest-frame batches, gathered by the C++
    ``rings_collect_latest``; prints the stale rows fed and the frames
    dropped.  Returns nothing."""
    import numpy as np

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.io import native
    from respmon_tpu_torch.io.capture import ArrayCapture
    from respmon_tpu_torch.parallel import streams
    from respmon_tpu_torch.runtime.fleet_feeder import FleetFeeder

    cfg = cfg or MonitorConfig(motion_extraction_method="flow")
    cal_len = cfg.calibration.buffer_length
    check(native.load_native() is not None, "the native library loaded")

    def feeder(lossless, fps_limit=None):
        f = FleetFeeder([ArrayCapture(c[1:], fps=FPS) for c in clips],
                        capacity=4, lossless=lossless, dtype=np.uint8,
                        fps_limit=fps_limit)
        check(all(r._lib is not None for r in f._rings),
              "every ring of the fleet feeder is native")
        return f.start()

    fed = feeder(lossless=True)
    buf, collect_s = wall_s(lambda: fed.collect_buffer(cal_len,
                                                       timeout=30.0))
    check(buf is not None and np.array_equal(buf, clips[:, 1:cal_len + 1]),
          "collect_buffer gave the clips' calibration frames")
    mon = streams.MultiStreamMonitor(cfg, None, clips.shape[2:], FPS,
                                     device=device)
    boxes = mon.calibrate(buf).boxes.cpu().tolist()
    check(boxes == fleet_boxes, f"fed calibration {boxes} equals the "
          f"direct one's {fleet_boxes}")
    fed.next_batch(timeout=30.0)              # the frame dropped at locate
    for k in range(ticks):
        b = fed.next_batch(timeout=30.0)
        got = fleet_step(mon, b.frames, stale=b.stale)
        check(np.array_equal(got, fleet_rows[k], equal_nan=True),
              f"fed step {k} equals the direct step bit for bit")
    fed.stop()
    check(mon.stale_rows == 0, "lossless ticks are never stale")

    live = feeder(lossless=False, fps_limit=FPS)
    collects = native.NATIVE_COLLECTS
    live_s = []
    for _ in range(live_ticks):
        b = live.next_batch(timeout=30.0)
        t0 = time.perf_counter()
        fleet_step(mon, b.frames, stale=b.stale)
        live_s.append(time.perf_counter() - t0)
    dropped = live.dropped.tolist()
    live.stop()
    check(native.NATIVE_COLLECTS > collects,
          "the C++ rings_collect_latest gathered the live batches")
    emit({"phase": "fleet_feeder_640x480", "streams": len(clips),
          "collect_buffer_s": collect_s, "lossless_ticks": ticks,
          "live_ticks": live_ticks,
          "native_collects": native.NATIVE_COLLECTS - collects,
          "live_stale_rows": mon.stale_rows, "live_dropped": dropped,
          "live_step_ms": _ms_stats(live_s)})


# The checkpoint phase's live monitor: frame 0, 128 calibration frames, 1
# dropped, 18 measured (BPM estimates from the 13th; too few breaths for a
# BPM), saved after the 14th.
CKPT_MEASURED = 18
CKPT_SPLIT = 14
# The fleet's steps (full rings installed: a BPM every step) before its
# save and after it; the sharded fleet repeats all of them.
CKPT_FLEET_STEPS = (2, 3)


def _monitor_trace(mon):
    """Step a monitor to the end of its clip: after each step its state,
    ROI and BPM count, and its signal and BPM history at the end."""
    import numpy as np

    trace = []
    while mon.step():
        trace.append((mon.state, (mon.x, mon.y, mon.w, mon.h),
                      len(mon.freq)))
    mon.cap.release()
    return trace, np.asarray(mon.data), np.asarray(mon.freq)


def _fleet_with_rings(cfg, mesh, fleet_host, device):
    """A fleet calibrated on ``fleet_host``'s frames 1..128 with full
    signal rings installed (``_full_rings``)."""
    from respmon_tpu_torch.parallel import streams

    fleet = streams.MultiStreamMonitor(cfg, mesh, tuple(fleet_host.shape[2:]),
                                       FPS, device=device)
    boxes = fleet.calibrate(
        fleet_host[:, 1:cfg.calibration.buffer_length + 1])
    _full_rings(fleet, len(fleet_host), cfg.measure.buffer_length,
                fleet.device)
    return fleet, boxes


def phase_checkpoint(frames, fleet_host, cfg=None, device=None):
    """Checkpoint / resume on the card.  The 640x480 u8 flow monitor
    (``frames``, a host clip of ``CKPT_MEASURED`` measured frames) saved
    after ``CKPT_SPLIT`` of them and restored into a fresh monitor on
    cuda:0 goes on as the uninterrupted one does, bit for bit: states,
    ROIs, BPM counts and signal.  The 4 x 640x480 flow fleet
    (``fleet_host``, full rings installed) saved after
    ``CKPT_FLEET_STEPS[0]`` steps and restored into a fresh fleet gives the
    uninterrupted fleet's next steps bit for bit: samples, BPMs, has_bpm
    and errors.  Prints the save and load times, the file sizes and the
    uninterrupted fleet's step times.  Returns the uninterrupted fleet's
    rows (every step's (4, S) results)."""
    import tempfile

    import numpy as np
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import streams
    from respmon_tpu_torch.runtime import checkpoint

    cfg = cfg or MonitorConfig(motion_extraction_method="flow")
    cal_len = cfg.calibration.buffer_length
    split = 1 + cal_len + 1 + CKPT_SPLIT
    card = torch.device(device or "cuda:0")
    (want, want_data, want_freq), whole_s = wall_s(
        lambda: _monitor_trace(make_monitor(frames, "flow", cfg,
                                            device=device)))
    first = make_monitor(frames[:split], "flow", cfg, device=device)
    head, _, _ = _monitor_trace(first)
    before, after = CKPT_FLEET_STEPS
    row = {"phase": "checkpoint_640x480_flow", "monitor_measured":
           CKPT_MEASURED, "monitor_saved_after": CKPT_SPLIT,
           "fleet_steps": [before, after], "whole_monitor_s": whole_s}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "monitor.npz")
        _, row["monitor_save_s"] = wall_s(
            lambda: checkpoint.save_checkpoint(path, first))
        resumed = make_monitor(frames[split:], "flow", cfg, device=device)
        _, row["monitor_load_s"] = wall_s(
            lambda: checkpoint.load_checkpoint(path, resumed))
        row["monitor_file_bytes"] = os.path.getsize(path)
        check(all(f.device == card for f in resumed._measure_state),
              f"the restored monitor state lies on {card}")
        tail, data, freq = _monitor_trace(resumed)
        check(head + tail == want, "the resumed monitor's states, ROIs and "
              "BPM counts equal the uninterrupted monitor's")
        check(len(data) == len(want_data) == CKPT_MEASURED
              and np.array_equal(data, want_data, equal_nan=True)
              and np.array_equal(freq, want_freq),
              "the resumed monitor's signal and BPMs equal the "
              "uninterrupted monitor's")

        first_step = cal_len + 2
        fleet, _ = _fleet_with_rings(cfg, None, fleet_host, device)
        timed_rows = [wall_s(lambda: fleet_step(
            fleet, fleet_host[:, first_step + k])) for k in range(before)]
        path = os.path.join(tmp, "fleet.npz")
        _, row["fleet_save_s"] = wall_s(
            lambda: checkpoint.save_fleet_checkpoint(path, fleet))
        timed_rows += [wall_s(lambda: fleet_step(
            fleet, fleet_host[:, first_step + k]))
            for k in range(before, before + after)]
        rows = [r for r, _ in timed_rows]
        # The unsharded steps' times, beside phase_sharded's.
        row["fleet_step_ms"] = _ms_stats([t for _, t in timed_rows])
        resumed = streams.MultiStreamMonitor(
            cfg, None, tuple(fleet_host.shape[2:]), FPS, device=device)
        _, row["fleet_load_s"] = wall_s(
            lambda: checkpoint.load_fleet_checkpoint(path, resumed))
        row["fleet_file_bytes"] = os.path.getsize(path)
    check(all(f.device == card for f in resumed.states),
          f"the restored fleet state lies on {card}")
    rows = np.stack(rows)
    got = np.stack([fleet_step(resumed, fleet_host[:, first_step + k])
                    for k in range(before, before + after)])
    check((rows[:, 2] > 0).all(), "every fleet step gave every stream a BPM")
    check(np.array_equal(got, rows[before:], equal_nan=True),
          "the resumed fleet's samples, BPMs, has_bpm and errors equal "
          "the uninterrupted fleet's bit for bit")
    row.update(monitor_samples=data.tolist(),
               fleet_bpm_rows=got[:, 1].tolist())
    emit(row)
    return rows


def phase_sharded(frames, fleet_host, fleet_rows, cfg=None, device=None,
                  backend="nccl"):
    """The sharded paths in a one-rank NCCL group on the card: every
    collective on CUDA tensors, K1 on the T-sharded shard (and on the
    fleet's stream-sharded locates).  ``locate_tsharded`` of the 640x480
    u8 calibration buffer (``frames[1:129]``, T = 128) has the bbox and
    ``thresh > 0`` of ``evm.locate`` and a heatmap within 1;
    ``locate_wsharded`` equals it bit for bit; the stream-sharded 4 x
    640x480 flow fleet (full rings installed) gives ``phase_checkpoint``'s
    uninterrupted fleet steps (``fleet_rows``) bit for bit, with one
    results gather a step.  Prints the time of each (the unsharded
    fleet's steps: ``phase_checkpoint``'s line).  Returns each path's
    launches.  One rank measures no scaling.  (``device="cpu"`` with
    ``backend="gloo"`` rehearses it on the CPU.)"""
    import numpy as np
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import launch, spatial, streams, temporal
    from respmon_tpu_torch.parallel.mesh import make_mesh
    from respmon_tpu_torch.pipeline import evm

    cfg = cfg or MonitorConfig(motion_extraction_method="flow")
    cal = cfg.calibration
    cal_len = cal.buffer_length
    card = torch.device(device or "cuda:0")
    buf = torch.from_numpy(frames[1:cal_len + 1]).to(card)

    def timed3(fn):
        out = fn()
        return out, statistics.median(wall_s(fn)[1] for _ in range(3))

    want, locate_s = timed3(lambda: evm.locate(buf, FPS, cal))
    launches = {}
    with launch.single_rank(backend):
        mesh_t = make_mesh(axis_names=("time",), device=device)
        check(mesh_t.device == card,
              f"the mesh's device is {card} ({mesh_t.device})")
        got_t, t_s = timed3(lambda: temporal.locate_tsharded(
            buf, mesh_t, FPS, cal))
        reset_launches()
        temporal.locate_tsharded(buf, mesh_t, FPS, cal)
        launches["tsharded"] = read_launches()
        planned = planned_launches(*buf.shape[1:], cal.pyramid_levels,
                                   cal.skip_levels_at_top)
        check({k: launches["tsharded"][k] for k in planned} == planned,
              f"the T-sharded locate ran K1 on its shard as planned "
              f"({planned}): {launches['tsharded']}")
        heat_gap = int((got_t.heatmap_u8.int() - want.heatmap_u8.int())
                       .abs().max())
        check(_bbox(got_t) == _bbox(want) and heat_gap <= 1
              and torch.equal(got_t.thresh > 0, want.thresh > 0),
              f"T-sharded bbox {_bbox(got_t)} equals locate's "
              f"{_bbox(want)}, heatmap within 1 ({heat_gap})")

        mesh_w = make_mesh(axis_names=("space",), device=device)
        got_w, w_s = timed3(lambda: spatial.locate_wsharded(
            buf, mesh_w, FPS, cal))
        reset_launches()
        spatial.locate_wsharded(buf, mesh_w, FPS, cal)
        launches["wsharded"] = read_launches()
        check(not any(pyramid_launches(launches["wsharded"]).values())
              and launches["wsharded"]["ccl"] == 1,
              f"the W-sharded locate runs its own stencils, no stencil "
              f"kernel, and one ccl call: {launches['wsharded']}")
        check(all(torch.equal(a, b) for a, b in zip(got_w, want)),
              "the W-sharded locate equals evm.locate bit for bit")

        mesh_s = make_mesh(axis_names=("streams",), device=device)
        first_step = cal_len + 2
        reset_launches()
        (fleet, boxes), cal_s = wall_s(
            lambda: _fleet_with_rings(cfg, mesh_s, fleet_host, device))
        mesh_s.collectives.clear()
        rows, step_s = [], []
        for k in range(len(fleet_rows)):
            t0 = time.perf_counter()
            rows.append(fleet_step(fleet, fleet_host[:, first_step + k]))
            step_s.append(time.perf_counter() - t0)
        launches["fleet"] = read_launches()
        check_k1_fleet(launches["fleet"], fleet, "the stream-sharded fleet")
        check(dict(mesh_s.collectives) == {"all_gather": len(fleet_rows)},
              f"one results gather a step: {dict(mesh_s.collectives)}")
        rows = np.stack(rows)
        check(np.array_equal(rows, fleet_rows, equal_nan=True),
              "the stream-sharded fleet's steps equal the unsharded "
              "fleet's bit for bit")
        counts = [dict(m.collectives) for m in (mesh_t, mesh_w)]
    emit({"phase": "sharded_one_rank_nccl", "ranks": 1,
          "locate_s": locate_s, "tsharded_locate_s": t_s,
          "wsharded_locate_s": w_s, "tsharded_heatmap_gap": heat_gap,
          "tsharded_collectives": counts[0],
          "wsharded_collectives": counts[1],
          "fleet_calibrate_s": cal_s, "fleet_boxes": boxes.boxes.tolist(),
          "fleet_step_ms": _ms_stats(step_s), "launches": launches})
    return launches


# The detect_peaks cases of the JAX package's tests (mpd, edge), on rings of
# MeasureConfig().buffer_length samples.
PEAK_CASES = ((1, "rising"), (5, "rising"), (3, None), (4, "both"))
AUX_RING = 128


def phase_aux(dev, cal_u8):
    """The auxiliary modules on the card at the sizes their users meet,
    each against the port's CPU result on the same input: ``bgr_to_gray``
    of a 640x480 and a 1080p BGR frame (bit-equal, and its bytes widened
    equal to ``io/native.bgr_to_gray_f32``'s), ``pixel_sum_series`` of the
    640x480 u8 calibration buffer ``cal_u8`` (exact against numpy's int64
    sums), ``normalize`` and ``float_to_int8`` of a 640x480 float32 frame
    (bit-equal), ``detect_peaks`` on 128-sample rings in the JAX tests'
    (mpd, edge) cases (equal indices), ``wavelet_filter(iterations=5)``
    and ``wavelet_decompose`` of a 256-sample motion trace (within 1e-5
    relative) and ``freq_from_fft`` of it (within 1e-4 Hz).  Each
    reading's ms: CUDA events, median of 10."""
    import numpy as np
    import torch

    from respmon_tpu_torch.io import native
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import dtype, wavelets
    from respmon_tpu_torch.ops.detect_peaks import detect_peaks
    from respmon_tpu_torch.utils import diagnostics

    rng = np.random.default_rng(10)
    ms, errors = {}, {}

    def run(name, fn, *host):
        """(the card's result, the CPU's) of ``fn`` on the same host
        inputs; the card's call is timed into ``ms[name]``."""
        on_card = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in host]
        got = fn(*on_card)
        ms[name] = cuda_ms(lambda: fn(*on_card), repeats=10)
        want = fn(*(torch.from_numpy(np.ascontiguousarray(a))
                    for a in host))
        return got, want

    for h, w in ((480, 640), (1080, 1920)):
        bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, want = run(f"bgr_to_gray_{h}x{w}", dtype.bgr_to_gray, bgr)
        got = got.cpu().numpy()
        check(np.array_equal(got, want.numpy()),
              f"bgr_to_gray {h}x{w} on the card equals the CPU's")
        widened = (got.astype(np.float64) * (1.0 / 255.0)).astype(
            np.float32)
        check(np.array_equal(widened.view(np.uint32),
                             native.bgr_to_gray_f32(bgr).view(np.uint32)),
              f"bgr_to_gray {h}x{w} equals io/native's bytes")

    got, want = run("pixel_sum_series_128x480x640_u8",
                    diagnostics.pixel_sum_series, cal_u8)
    sums = cal_u8.astype(np.int64).sum(axis=(1, 2))[1:-1]
    check(np.array_equal(got.cpu().numpy(), sums - sums.min())
          and np.array_equal(want.numpy(), sums - sums.min()),
          "pixel_sum_series of the u8 buffer equals numpy's int64 sums")

    frame = rng.uniform(-0.2, 1.3, (480, 640)).astype(np.float32)
    for name, fn in (("normalize", dtype.normalize),
                     ("float_to_int8", dtype.float_to_int8)):
        got, want = run(f"{name}_480x640", fn, frame)
        check(torch.equal(got.cpu(), want),
              f"{name} 480x640 on the card equals the CPU's bit for bit")

    rings = np.random.default_rng(0).standard_normal((5, AUX_RING))
    peaks = {}
    for mpd, edge in PEAK_CASES:
        def call(x, mpd=mpd, edge=edge):
            return [detect_peaks(r, mpd=mpd, edge=edge) for r in x]

        got, want = run(f"detect_peaks_5_rings_mpd{mpd}_{edge}", call, rings)
        for (gi, gm), (wi, wm) in zip(got, want):
            check(torch.equal(gi.cpu(), wi) and torch.equal(gm.cpu(), wm),
                  f"detect_peaks (mpd {mpd}, edge {edge}) on the card "
                  "equals the CPU's")
        peaks[f"{mpd},{edge}"] = int(sum(int(m.sum()) for _, m in want))

    _, trace = motion_trace(num_samples=256, fps=FPS, bpm=18.0, noise=0.3)
    trace = trace.astype(np.float32)

    def rel(g, w):
        return float((g.cpu() - w).abs().max() / w.abs().max())

    got, want = run("wavelet_filter_256", lambda x: wavelets.wavelet_filter(
        x, iterations=5), trace)
    errors["wavelet_filter_rel"] = rel(got, want)
    got, want = run("wavelet_decompose_256",
                    lambda x: wavelets.wavelet_decompose(x, 5), trace)
    errors["wavelet_decompose_rel"] = max(
        rel(g, w) for g, w in zip(got[0] + got[1], want[0] + want[1]))
    check(got[0][-1].dtype == torch.float32, "wavelets keep float32")
    got, want = run("freq_from_fft_256",
                    lambda x: diagnostics.freq_from_fft(x, FPS), trace)
    errors["freq_from_fft_hz"] = abs(float(got) - float(want))
    check(errors["wavelet_filter_rel"] <= 1e-5
          and errors["wavelet_decompose_rel"] <= 1e-5
          and errors["freq_from_fft_hz"] <= 1e-4,
          f"wavelets within 1e-5 relative, freq_from_fft within 1e-4 Hz "
          f"of the CPU's: {errors}")
    emit({"phase": "aux", "ms": ms, "errors": errors,
          "peaks_found": peaks, "freq_from_fft_hz": float(got)})


# The port's demos as phase_examples runs them: each its defaults, but the
# fleet cut from 8 x 120 frames (55 fleet steps) to 8 x 80 (15), and its
# feeder run to the tests' 2 x 70.
EXAMPLES = (("signal_measurement_demo", ()), ("filter_explorer", ()),
            ("gaussian_explorer", ()), ("wavelet_demo", ()),
            ("temporal_analysis_demo", ()), ("multiaxis_demo", ()),
            ("locating_demo", ()), ("flow_demo", ()),
            ("multistream_demo", ("--streams", "8", "--frames", "80")),
            ("multistream_demo", ("--streams", "2", "--frames", "70",
                                  "--feeder")))
# Compared with a --device cpu run of the same demo in this process.
EXAMPLES_VS_CPU = ("signal_measurement_demo", "filter_explorer",
                   "gaussian_explorer", "wavelet_demo",
                   "temporal_analysis_demo", "multiaxis_demo",
                   "locating_demo")


def run_demo(name: str, args=(), device=None):
    """(printed output, seconds) of the port's demo ``name`` run in this
    process, as ``python -m respmon_tpu_torch.examples.<name> *args``
    (with ``--device`` when ``device`` is given)."""
    import contextlib
    import io
    import runpy

    argv = [name, *args] + (["--device", device] if device else [])
    out = io.StringIO()
    saved, sys.argv = sys.argv, argv
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(f"respmon_tpu_torch.examples.{name}",
                             run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue(), time.perf_counter() - t0


def _planned_demo_launches(name: str, args) -> dict:
    """The stencil kernels' launches that a K1 demo's run makes: its
    locates and, in the locating demo, one streaming absorb a frame (48
    frames unless ``--frames`` says otherwise, as in the demo)."""
    def arg(flag, default):
        return int(args[args.index(flag) + 1]) if flag in args else default

    if name == "locating_demo":      # (32, 60, 80) L4/S1, then T = 1
        geometry, calls = (60, 80, 4, 1), 1 + arg("--frames", 48)
    elif name == "flow_demo":        # (64, 120, 160) L6/S2
        geometry, calls = (120, 160, 6, 2), 1
    else:                            # a (64, 60, 80) L4/S1 locate a stream
        geometry, calls = (60, 80, 4, 1), arg("--streams", 8)
    return {k: n * calls
            for k, n in planned_launches(*geometry).items()}


def phase_examples(device=None):
    """The port's nine demos (``EXAMPLES``) run in this process on the card
    (``device=None``, as a user runs them), each read by its printed
    lines: each exits normally and prints; the locating demo's batch
    locate finds the patch, the flow demo prints an ROI, the fleet demo
    calibrates every stream; the 1-D demos and the locating demo print
    what their --device cpu runs print (``examples.mismatches``).  K1's
    launches are read around each K1 demo and must be what its locates
    and absorbs plan.  Returns the three K1 demos' launches.
    (``device="cpu"`` rehearses it on the CPU.)"""
    from respmon_tpu_torch.examples import mismatches, printed_lines

    rows, launches = [], {}
    for name, args in EXAMPLES:
        reset_launches()
        out, seconds = run_demo(name, args, device)
        counts = read_launches()
        check(out.strip() != "", f"{name} printed its lines")
        row = {"demo": name, "args": list(args), "seconds": seconds,
               "numbers": [nums for _, nums in printed_lines(out)]}
        if name in EXAMPLES_VS_CPU:
            cpu_out, row["cpu_seconds"] = run_demo(name, args, "cpu")
            wrong = mismatches(name, out, cpu_out)
            check(not wrong, f"{name} on the card prints what it prints on "
                  f"the CPU: {wrong}")
        if name in ("locating_demo", "flow_demo", "multistream_demo"):
            planned = _planned_demo_launches(name, args)
            got = {k: counts[k] for k in planned}
            check(got == planned and not any(
                v for k, v in pyramid_launches(counts).items()
                if k not in planned),
                f"{name} launched K1 as its locates plan ({planned}): "
                f"{counts}")
            row["launches"] = counts
            launches.setdefault(name, counts)
        if name == "locating_demo":
            check("batch locate:     found=True" in out,
                  "the locating demo's batch locate found the patch")
        if name == "flow_demo":
            check(out.startswith("ROI: (") and "ROI: None" not in out,
                  f"the flow demo found an ROI: {out.splitlines()[0]}")
        if name == "multistream_demo":
            n = int(args[args.index("--streams") + 1])
            check(f"calibrated: {[True] * n}" in out,
                  f"every stream of the fleet demo calibrated: {out}")
        rows.append(row)
        emit({"phase": "examples", **row})
    return {"example_locating_60x80": launches["locating_demo"],
            "example_flow_120x160": launches["flow_demo"],
            "example_multistream_60x80": launches["multistream_demo"]}


# phase_bench: respmon_tpu_torch.bench's nine modes, run in this process
# on the card, each at the sizes that keep the script inside its budget:
# the headline at its full size (640x480, 5 timed iterations, the 16 x 720p
# fleet segment, 2 of its 8 timed steps), the others cut as named here.
# The corpus's first 4 traces hold its 4 kinds, at one fps as its first 35.
# The recovery soak runs cold: its warm variant's path (the streaming
# rings through the error state) is phase_monitor_warm_recovery's, at full
# calibration size, and tests/test_torch_bench_modes.py runs it.
BENCH_MODES = (
    ("headline", "main_headline", {"fleet_steps": 2}),
    ("bpm_corpus", "main_bpm_corpus", {"n_traces": 4}),
    ("streaming", "main_streaming", {}),
    ("live", "main_live", {"measure_frames": 16}),
    ("fleet_live", "main_fleet_live",
     {"streams": 4, "measure_frames": 8, "height": 480, "width": 640}),
    ("recovery", "main_recovery", {"cycles": 1, "smoke": True}),
    ("breakdown", "main_fleet_breakdown",
     {"streams": 4, "calls": 1, "windows": 1, "production_steps": 1}),
    ("multistream", "main_multistream",
     {"streams": 64, "sync_steps": 1, "streaming_interval": 1,
      "batch_iters": 1}),
)
# The top-level keys of each mode's line: bench.py's, plus "device".
BENCH_KEYS = {
    "main_headline": (
        "metric", "value", "unit", "vs_baseline", "value_with_upload",
        "upload_ingest", "u8_widen_exact_on_device",
        "value_with_upload_pcie16GBps_estimate", "h2d_overlap",
        "config3_locate_ms", "config3_geometry", "config3_found",
        "config3_realtime_x", "gaussfit_device_agreement_realistic",
        "gaussfit_device_agreement_noise", "bpm_tail_median", "bpm_true",
        "bpm_oracle_delta", "fleet_streams", "fleet_geometry",
        "fleet_step_ms", "fleet_sfps", "fleet_realtime_margin_at_10fps"),
    "main_bpm_corpus": (
        "metric", "value", "unit", "vs_baseline", "n_traces", "n_steps",
        "n_both_have_bpm", "has_bpm_mismatch_rate", "delta_p50",
        "delta_p99", "delta_p999", "traces_within_half_bpm",
        "per_kind_max", "per_kind_p99"),
    "main_streaming": (
        "metric", "unit", "interval", "value", "vs_baseline",
        *(f"{k}_{g}" for g in ("640_480", "1080p") for k in (
            "absorb_ms", "update_ms", "update_coarse_ms",
            "amortized_ms_per_frame", "amortized_coarse_ms_per_frame",
            "realtime_x"))),
    "main_live": (
        "metric", "value", "unit", "vs_baseline", "sync_fps",
        "overlap_gain", "dropped", "u8_upload_live_fps",
        "u8_upload_sync_fps", "simulated_capture_ms"),
    "main_fleet_live": (
        "metric", "value", "unit", "vs_baseline", "ticks", "tick_rate_hz",
        "stale_rate", "dropped_total", "simulated_capture_ms"),
    "main_recovery": (
        "metric", "streaming_roi", "relocks", "value", "unit",
        "vs_baseline", "cycles", "max_latency_s", "compute_latency_s",
        "error_reset_delay_s", "pre_fault_bpm_tail_median", "bpm_true",
        "state_sequence_ok"),
    "main_fleet_breakdown": (
        "metric", "value", "unit", "vs_baseline", "production_step_ms",
        "stages_ms", "derived_ms"),
    "main_multistream": (
        "metric", "value", "unit", "vs_baseline", "step_ms",
        "step_ms_sync_fetch", "realtime_margin_at_10fps",
        "batch4_ms_per_frame", "batch4_realtime_margin",
        "recalibration_1080p_ms", "streaming_step_ms",
        "streaming_overhead_ms_per_step",
        "streaming_overhead_ms_per_stream_frame", "streaming_interval"),
}


class k1_plans:
    """Inside it, every K1 call (``evm._band_laplacian_levels``: each
    ``locate``, absorb and warm start) adds to ``planned`` the launches its
    plan makes at its geometry, and to ``calls`` one."""

    def __enter__(self):
        import collections

        from respmon_tpu_torch.pipeline import evm

        self._evm, self._k1 = evm, evm._band_laplacian_levels
        self.planned = collections.Counter()
        self.calls = 0

        def counted(vid, cfg):
            self.calls += 1
            self.planned.update(planned_launches(
                vid.shape[-2], vid.shape[-1], cfg.pyramid_levels,
                cfg.skip_levels_at_top))
            return self._k1(vid, cfg)

        evm._band_laplacian_levels = counted
        return self

    def __exit__(self, *exc):
        self._evm._band_laplacian_levels = self._k1


def _finite_numbers(obj) -> bool:
    import math

    if isinstance(obj, dict):
        return all(_finite_numbers(v) for v in obj.values())
    if isinstance(obj, (bool, str)):
        return True
    return isinstance(obj, (int, float)) and math.isfinite(obj)


def phase_bench(device=None, modes=BENCH_MODES):
    """``respmon_tpu_torch.bench``'s modes (``BENCH_MODES``) through their
    in-process functions, on the card unless ``device`` says otherwise.
    Each prints exactly one JSON line with bench.py's keys for its mode
    (``BENCH_KEYS``) and the card's name, every number finite.  The
    headline's BPM tail lies within 1 of its 18 BPM; the corpus's has-BPM
    decisions all equal the scipy chain's, as the JAX estimator's did on
    the full corpus.  Every K1 call of a mode launched what its plan says
    (``k1_plans``), no other stencil or band kernel ran, and the modes
    that calibrate or absorb ran K1: the 1080p unit of ``--multistream``
    its A (d = 1), the first level of the 1080p plan and K2's port.  Returns each mode's
    launches, by path."""
    import contextlib
    import io

    from respmon_tpu_torch import bench

    paths = {}
    for name, fn_name, kwargs in modes:
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with k1_plans() as k1, contextlib.redirect_stdout(buf):
            ret = getattr(bench, fn_name)(device=device, **kwargs)
        seconds = time.perf_counter() - t0
        counts = read_launches()
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        check(len(lines) == 1, f"bench {name} printed one line: {lines}")
        line = json.loads(lines[0])
        check(line == ret, f"bench {name} returned its line")
        want = set(BENCH_KEYS[fn_name]) | {"device"}
        check(set(line) == want, f"bench {name} has bench.py's keys and "
              f"the device: {sorted(set(line) ^ want)} differ")
        check(_finite_numbers(line), f"bench {name}: finite numbers {line}")
        k_counts = pyramid_launches(counts)
        expected = {k: k1.planned.get(k, 0) for k in k_counts}
        check(k_counts == expected, f"bench {name}: every K1 call launched "
              f"its plan ({expected}): {k_counts}")
        if fn_name == "main_bpm_corpus":
            check(k1.calls == 0 and line["has_bpm_mismatch_rate"] == 0,
                  f"bench {name}: every has-BPM decision equals the scipy "
                  f"chain's, no kernel: {line}")
        else:
            check(k1.calls > 0 and counts["pyr_tail"] > 0,
                  f"bench {name} launched K1: {counts}")
        if fn_name == "main_headline":
            check(abs(line["bpm_tail_median"] - 18.0) <= 1.0
                  and line["u8_widen_exact_on_device"]
                  and line["config3_found"],
                  f"bench headline: BPM tail within 1 of 18, exact u8 "
                  f"widen, config 3 found: {line}")
        if fn_name == "main_multistream":
            check(counts["pyr_down_levels_d1"] > 0,
                  f"bench multistream's 1080p unit launched K2: {counts}")
        if fn_name == "main_recovery":
            check(line["state_sequence_ok"] and line["cycles"] == 1,
                  f"bench {name} recovered: {line}")
        paths[f"bench_{name}"] = counts
        emit({"phase": "bench", "mode": name, "seconds": seconds,
              "k1_calls": k1.calls, "launches": counts, "line": line})
    return paths


# phase_surface: measured frames of the single-stream cached step, and the
# BPM stage's peak-finding arguments (MeasureConfig at 10 fps).
SURFACE_FRAMES = 20
SURFACE_PEAKS = dict(min_dist=10, thres=0.3, max_peaks=32)


def event_ms(fn):
    """(result, ms) of one ``fn`` between two CUDA events, ending in the
    end event's synchronise: the call's span, host stalls included."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _window_of(ring, coeffs, cfg):
    """The first window with at least 3 points that ``estimate_bpm`` fits
    on the host ``ring`` (its f32 Gaussian fit's inputs), as host arrays
    (t, y, mask)."""
    import torch

    from respmon_tpu_torch.ops import gaussfit
    from respmon_tpu_torch.pipeline import bpm

    seen = []
    fit = gaussfit.gaussian_fit_batch

    def capture(t, y, mask, **kw):
        seen.append((t, y, mask))
        return fit(t, y, mask, **kw)

    gaussfit.gaussian_fit_batch = capture
    try:
        bpm.estimate_bpm(*(torch.from_numpy(ring[k][None])
                           for k in ("data", "t", "count")),
                         coeffs, SURFACE_PEAKS["min_dist"], cfg)
    finally:
        gaussfit.gaussian_fit_batch = fit
    t, y, mask = (a[0].numpy() for a in seen[0])
    lane = int((mask.sum(axis=-1) >= 3).argmax())
    check(mask[lane].sum() >= 3, "the monitor's ring has a window to fit")
    return t[lane], y[lane], mask[lane]


def phase_surface(frames, roi, ring, device=None):
    """The functions that completed the port's public surface, on the card
    at the sizes their users meet, each against its reference:

    - the single-stream ``measure_step_cached`` over ``frames`` (measured
      640x480 u8 frames) at the calibrated ``roi``, flow and average,
      frame for frame bit-equal to ``measure_step`` on the card, hinted
      (``initialized_hint=True`` after the first frame) or not; each step's
      ms (CUDA events) beside the uncached step's, with and without the
      hint;
    - ``filtfilt`` (within 1e-5 of the CPU's) and ``peak_indexes`` (equal
      indices and mask) of 128-sample rings;
    - ``gaussian_fit_single`` in float32 and float64 on the first window
      that the live monitor's (a) estimate fits on its ``ring``: the
      decision equal to the CPU's, converged parameters within rtol 1e-4 /
      atol 1e-6 (float32) and 1e-6 relative (float64);
    - ``entry()``: its box equal to the CPU's, its K1 launches those one
      (64,120,160) L6/S2 ``locate`` plans.

    Every result is emitted before the checks.  Returns the entry's
    launches.  (``device="cpu"`` rehearses it on the CPU.)"""
    import numpy as np
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.entry import entry
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import filters, gaussfit, peaks
    from respmon_tpu_torch.pipeline import motion

    dev = torch.device(device or "cuda:0")
    cpu = torch.device("cpu")
    row, ms, checks = {"phase": "surface"}, {}, []
    h, w = frames.shape[1:]

    for method in ("flow", "average"):
        cfg = MonitorConfig(motion_extraction_method=method)
        spec = motion.MeasureSpec.for_roi(cfg, h, w, roi[2], roi[3], FPS)
        cached = plain = hinted = motion.init_state(spec, roi, device=dev)
        cache = motion.init_flow_cache(spec, device=dev)
        times = {"cached_hinted": [], "uncached": [], "uncached_hinted": []}
        equal = True
        for i, frame in enumerate(frames):
            frame = torch.from_numpy(frame).to(dev)
            (cached, cache, s_c), t_c = event_ms(
                lambda: motion.measure_step_cached(
                    cached, cache, frame, spec, initialized_hint=i > 0,
                    cache_valid=i > 0))
            (plain, s_p), t_p = event_ms(
                lambda: motion.measure_step(plain, frame, spec))
            (hinted, s_h), t_h = event_ms(
                lambda: motion.measure_step(hinted, frame, spec,
                                            initialized_hint=i > 0))
            for name, t in zip(times, (t_c, t_p, t_h)):
                times[name].append(t)
            equal &= bool(torch.equal(s_c, s_p) and torch.equal(s_h, s_p))
        equal &= all(bool(torch.equal(a, b)) and bool(torch.equal(b, c))
                     for a, b, c in zip(cached, plain, hinted))
        checks.append((equal and cached.data.dim() == 1,
                       f"the {method} cached step equals measure_step on "
                       "the card bit for bit, frame for frame"))
        checks.append((method == "average" or not bool(plain.error),
                       f"the {method} steps raise no error"))
        row[f"step_{method}_ms"] = {
            name: {"first": v[0], "median": statistics.median(v[1:])}
            for name, v in times.items()}

    # filtfilt and peak_indexes on 128-sample rings.
    rings = np.stack([motion_trace(num_samples=AUX_RING, fps=FPS, bpm=bpm,
                                   noise=0.05, seed=k)[1]
                      for k, bpm in enumerate((12.0, 15.0, 18.0, 21.0,
                                               24.0))]).astype(np.float32)
    coeffs = filters.design_butter_lowpass(0.5, FPS, 3)
    host = torch.from_numpy(rings)
    on_card = host.to(dev)
    want = filters.filtfilt(coeffs, host)
    got = filters.filtfilt(coeffs, on_card)
    got_one = filters.filtfilt(coeffs, on_card[0])
    ms["filtfilt_5x128"] = cuda_ms(lambda: filters.filtfilt(coeffs, on_card),
                                   repeats=10)
    ms["filtfilt_128"] = cuda_ms(lambda: filters.filtfilt(coeffs,
                                                          on_card[0]),
                                 repeats=10)
    row["filtfilt_max_abs_err"] = max(
        float((got.cpu() - want).abs().max()),
        float((got_one.cpu() - want[0]).abs().max()))
    checks.append((torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5)
                   and torch.allclose(got_one.cpu(), want[0], rtol=1e-5,
                                      atol=1e-5),
                   "filtfilt on the card within 1e-5 of the CPU's"))
    filtered = want.to(dev)
    idx, mask = peaks.peak_indexes(filtered, **SURFACE_PEAKS)
    want_idx, want_mask = peaks.peak_indexes(want, **SURFACE_PEAKS)
    ms["peak_indexes_5x128"] = cuda_ms(
        lambda: peaks.peak_indexes(filtered, **SURFACE_PEAKS), repeats=10)
    ms["peak_indexes_128"] = cuda_ms(
        lambda: peaks.peak_indexes(filtered[0], **SURFACE_PEAKS),
        repeats=10)
    one_idx, _ = peaks.peak_indexes(filtered[0], **SURFACE_PEAKS)
    row["peaks_found"] = [int(m.sum()) for m in want_mask]
    checks.append((torch.equal(idx.cpu(), want_idx)
                   and torch.equal(mask.cpu(), want_mask)
                   and torch.equal(one_idx.cpu(), want_idx[0])
                   and min(row["peaks_found"]) > 0,
                   "peak_indexes on the card equals the CPU's"))

    # gaussian_fit_single on a window of the live monitor's ring.
    mcfg = MonitorConfig().measure
    t, y, m = _window_of(ring, filters.design_butter_lowpass(
        0.5, FPS, mcfg.filter_order), mcfg)
    row["window_points"] = int(m.sum())
    for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-6),
                              (torch.float64, 1e-6, 1e-9)):
        args = [torch.from_numpy(t).to(dtype), torch.from_numpy(y).to(dtype),
                torch.from_numpy(m)]
        name = f"gaussian_fit_single_{str(dtype)[6:]}"
        fit_want = gaussfit.gaussian_fit_single(*args)
        runs = [event_ms(lambda: gaussfit.gaussian_fit_single(
            *(a.to(dev) for a in args))) for _ in range(3)]
        ms[name] = statistics.median(r[1] for r in runs)
        fit_got = runs[0][0]
        params = [(float(getattr(fit_got, k)), float(getattr(fit_want, k)))
                  for k in ("ampl", "center", "dev")]
        row[name] = {"converged": bool(fit_got.converged),
                     "cpu_converged": bool(fit_want.converged),
                     "params": [g for g, _ in params],
                     "cpu_params": [c for _, c in params]}
        checks.append((bool(fit_got.converged) == bool(fit_want.converged)
                       and (not bool(fit_want.converged) or all(
                           abs(g - c) <= atol + rtol * abs(c)
                           for g, c in params)),
                       f"{name} on the card agrees with the CPU's"))

    # entry(): K1 on the card, its box against the CPU's.
    fn, args = entry(device)
    reset_launches()
    (found, *box, heat), ms["entry_locate_64x120x160"] = event_ms(
        lambda: fn(*args))
    launches = read_launches()
    planned = planned_launches(120, 160, 6, 2)
    cpu_fn, cpu_args = entry(cpu)
    cpu_found, *cpu_box, cpu_heat = cpu_fn(*cpu_args)
    ms["entry_locate_64x120x160"] = cuda_ms(lambda: fn(*args), repeats=10)
    row.update(entry_box=[int(v) for v in box],
               entry_cpu_box=[int(v) for v in cpu_box],
               entry_found=bool(found), entry_launches=launches,
               entry_heatmap_max_abs_diff=int(
                   (heat.cpu().int() - cpu_heat.int()).abs().max()))
    checks.append((bool(found) == bool(cpu_found) and bool(found)
                   and row["entry_box"] == row["entry_cpu_box"],
                   "entry() on the card finds the CPU's box"))
    checks.append(({k: launches[k] for k in planned} == planned
                   and not any(v for k, v in pyramid_launches(launches)
                               .items() if k not in planned),
                   f"entry() launched K1 as one (64,120,160) locate plans "
                   f"({planned}): {launches}"))
    checks.append((launches["ccl"] == 1,
                   f"entry() made one ccl call: {launches}"))
    emit({**row, "ms": ms})
    for ok, what in checks:
        check(ok, what)
    return launches


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import respmon_tpu_torch  # noqa: F401  (sets the precision policy)

    dev = torch.device("cuda", 0)
    seconds = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[fn.__name__] = time.perf_counter() - t0
        print(f"chip_smoke: {fn.__name__} {seconds[fn.__name__]:.1f} s, "
              f"{time.perf_counter() - start:.1f} s in all", file=sys.stderr,
              flush=True)
        return out

    card = timed(phase_device)
    timed(phase_build)
    timed(phase_widen, dev)
    gaussfit_rows = timed(phase_gaussfit, dev)
    ccl_rows = timed(phase_ccl, dev)
    kernels, lap_path = timed(phase_kernels, dev)
    kernels += timed(phase_kernels_k3, dev)
    stream_rows, stream_1080p = timed(phase_streaming_kernels, dev)
    kernels += stream_rows
    timed(phase_small_cross_check, dev)
    frames = slice_frames(dev)
    roi, avg_launches = timed(phase_slice, frames)
    k3_launches = timed(phase_k3_locate, frames, roi)
    timed(phase_iir_locate, frames, roi)
    flow_launches = timed(phase_flow_slice, frames, roi)
    # The profiler pass over the clip's first PROFILE_FRAMES frames (24
    # measured), for the script's time.
    timed(phase_flow_profile, frames[:PROFILE_FRAMES])
    host_frames = frames.cpu().numpy()
    cal_u8 = host_frames[1:129].copy()   # the calibration buffer
    surface_frames = host_frames[130:130 + SURFACE_FRAMES].copy()
    del frames
    # The live monitor over the clip's first MONITOR_FRAMES frames (64
    # measured), and the fed one over its first 54.
    monitor_launches, average_mon = timed(phase_monitor,
                                          host_frames[:MONITOR_FRAMES])
    surface_ring = {k: getattr(average_mon._measure_state, k).cpu().numpy()
                    for k in ("data", "t", "count")}
    timed(phase_feeder, host_frames, average_mon, measured=FEEDER_MEASURED)
    ckpt_frames = host_frames[:1 + 128 + 1 + CKPT_MEASURED].copy()
    del host_frames
    streaming_launches = timed(phase_streaming, dev)
    stream_monitor_launches = timed(phase_monitor_streaming,
                                    streaming_frames(STREAM_MONITOR_FRAMES))
    recovery = recovery_frames()
    recovery_launches, cold_frames = timed(phase_monitor_recovery, recovery,
                                           blackout_at=RECOVERY_BLACKOUT_AT)
    warm_launches = timed(phase_monitor_warm_recovery, recovery,
                          blackout_at=RECOVERY_BLACKOUT_AT,
                          cold_fault_to_bpm=cold_frames)
    del recovery
    launches_1080p, roi_1080p, clip_1080p = timed(phase_1080p, dev)
    fleet = fleet_clips(1 + 128 + 1 + FLEET_MEASURED)
    fleet_launches, fleet_rows, fleet_boxes = timed(phase_fleet, fleet)
    timed(phase_fleet_feeder, fleet, fleet_rows, fleet_boxes)
    ckpt_rows = timed(phase_checkpoint, ckpt_frames, fleet)
    sharded_launches = timed(phase_sharded, ckpt_frames, fleet, ckpt_rows)
    del fleet, ckpt_frames
    timed(phase_fleet_cross_check)
    drifting = fleet_clips(1 + 128 + 1 + FLEET_STREAM_MEASURED, FLEET_DRIFTS)
    fleet_stream_launches = timed(phase_fleet_streaming, drifting)
    del drifting
    fleet_1080p_launches = timed(phase_fleet_1080p, roi_1080p, clip_1080p)
    del clip_1080p
    kernels += timed(phase_fleet_kernels, dev)
    timed(phase_aux, dev, cal_u8)
    del cal_u8
    surface_launches = timed(phase_surface, surface_frames, roi,
                             surface_ring)
    del surface_frames
    example_launches = timed(phase_examples)
    bench_launches = timed(phase_bench)

    # Each path was driven with every count at 0 just before it and read
    # just after.  ``launches`` is the count on the kernel's own path: the
    # flow slice for A (d = 2) and B, the 1080p locate for A (d = 1), the
    # L9/S1 parity run for lap_level_f32 (no default configuration takes
    # its route), the K3 calibration for the band kernels, the flow
    # monitor (2 an estimate) and the 64 x 1080p streaming fleet (1 an
    # estimate) for the Gaussian fit's rows, and the streaming fleet (1 a
    # localize), the recovery run (1 a calibration) and the 1080p locate
    # for the CCL's rows (their ``path``).
    paths = {"slice_640x480": avg_launches, "flow_640x480": flow_launches,
             "k3_locate_640x480": k3_launches,
             "k1_parity_4x480x640_l9s1": lap_path,
             "locate_1080p": launches_1080p,
             "monitor_640x480_average": monitor_launches["average"],
             "monitor_640x480_flow": monitor_launches["flow"],
             "monitor_recovery_640x480": recovery_launches,
             "streaming_kernels_1x1080x1920": stream_1080p,
             "streaming_640x480": streaming_launches,
             "monitor_streaming_640x480_average":
                 stream_monitor_launches["average"],
             "monitor_streaming_640x480_flow":
                 stream_monitor_launches["flow"],
             "monitor_warm_recovery_640x480": warm_launches,
             "fleet_640x480_flow": fleet_launches,
             "fleet_streaming_640x480_average":
                 fleet_stream_launches["average"],
             "fleet_streaming_640x480_flow": fleet_stream_launches["flow"],
             "fleet_1080p_streaming": fleet_1080p_launches,
             "tsharded_locate_640x480": sharded_launches["tsharded"],
             "wsharded_locate_640x480": sharded_launches["wsharded"],
             "fleet_sharded_640x480_flow": sharded_launches["fleet"],
             **example_launches, "entry_120x160": surface_launches,
             **bench_launches}
    own_path = {"pyr_down_levels_d2": "flow_640x480",
                "pyr_down_levels_d1": "locate_1080p",
                "pyr_tail": "flow_640x480",
                "lap_level": "k1_parity_4x480x640_l9s1",
                "band_left": "k3_locate_640x480",
                "band_right": "k3_locate_640x480"}
    for k in kernels:
        key = k.pop("counter", k["name"].removesuffix("_f32"))
        k["launches_by_path"] = {name: counts[key]
                                 for name, counts in paths.items()}
        k["path"] = k.get("path", own_path[key])
        k["launches"] = paths[k["path"]][key]
        check(k["launches"] > 0, f"{k['name']} launched on its path")
    for rows, key in ((gaussfit_rows, "gauss_fit"), (ccl_rows, "ccl")):
        for k in rows:
            k["launches_by_path"] = {name: counts[key]
                                     for name, counts in paths.items()}
            k["launches"] = paths[k["path"]][key]
            check(k["launches"] > 0, f"{k['name']} launched on {k['path']}")
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - start,
          "budget_s": TIME_BUDGET_S})
    emit({"kernels": kernels + gaussfit_rows + ccl_rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
