#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``respmon_tpu_torch/csrc`` (into
``build/``), checks each against its plain PyTorch version on the card,
drives the whole-clip path ``process_clip`` at 640x480 and one 1080p
calibration, and checks what comes out.  Each phase prints one JSON line;
then the kernel table, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.  Without a CUDA device it exits 1.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

FPS = 10.0
REPEATS = 20
PYRAMID_CU = "respmon_tpu_torch/csrc/pyramid.cu"
PALLAS = "respmon_tpu/ops/pyramid_pallas.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def max_abs(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


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
    from respmon_tpu_torch.ops import _build, pyramid_cuda

    t0 = time.perf_counter()
    lib = _build.build("pyramid")
    pyramid_cuda._lib()
    emit({"phase": "build", "library": str(lib.relative_to(
        _build.BUILD_DIR.parent.parent)), "seconds": time.perf_counter() - t0})


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


def phase_kernels(dev):
    """Each kernel and composition against its plain version on the card:
    equal bit for bit, and timed."""
    import torch

    from respmon_tpu_torch.ops import pyramid, pyramid_cuda as pc

    gen = torch.Generator(device=dev).manual_seed(0)

    def video(shape):
        return torch.rand(shape, generator=gen, device=dev)

    rows = []
    for shape, levels, skip in [((128, 480, 640), 9, 4),
                                ((128, 1080, 1920), 9, 4),
                                ((3, 135, 192), 7, 3), ((2, 5, 7), 3, 0)]:
        v = video(shape)
        err = max_abs(pc.laplacian_band_levels(v, levels, skip),
                      pc.laplacian_band_levels_ref(v, levels, skip))
        rows.append({"op": "laplacian_band_levels", "shape": shape,
                     "levels": levels, "skip": skip, "max_abs_err": err,
                     "ms": cuda_ms(lambda: pc.laplacian_band_levels(
                         v, levels, skip)),
                     "plain_ms": cuda_ms(lambda: pc.laplacian_band_levels_ref(
                         v, levels, skip))})
        del v
    for shape in [(8, 1080, 1920), (2, 135, 192)]:
        v = video(shape)
        for s1 in (1, 2):
            err = max_abs([pc.gauss_level(v, s1)],
                          [pc.gauss_level_ref(v, s1)])
            rows.append({"op": "gauss_level", "shape": shape, "s1": s1,
                         "max_abs_err": err,
                         "ms": cuda_ms(lambda: pc.gauss_level(v, s1)),
                         "plain_ms": cuda_ms(
                             lambda: pc.gauss_level_ref(v, s1))})
        del v
    for row in rows:
        emit({"phase": "kernel_parity", **row})
        check(row["max_abs_err"] == 0.0, f"{row['op']} {row['shape']} "
              f"equals its plain version bit for bit")

    # The two kernels at the shapes the 640x480 path gives them.
    v = video((128, 480, 640))
    g = pyramid.gaussian_pyramid(v, 6)
    g4, g5 = g[4].contiguous(), g[5].contiguous()
    kernels = [
        {"name": "pyr_down_f32", "route": "cuda", "source": PYRAMID_CU,
         "replaces": f"{PALLAS}:244",
         "shape": list(v.shape),
         "max_abs_err": max_abs([pc.pyr_down(v)], [pyramid.pyr_down(v)]),
         "ms": cuda_ms(lambda: pc.pyr_down(v)),
         "plain_ms": cuda_ms(lambda: pyramid.pyr_down(v))},
        {"name": "lap_level_f32", "route": "cuda", "source": PYRAMID_CU,
         "replaces": f"{PALLAS}:294",
         "shape": list(g4.shape),
         "max_abs_err": max_abs(
             [pc.lap_level(g4, g5)],
             [g4 - pyramid.pyr_up(g5, tuple(g4.shape[-2:]))]),
         "ms": cuda_ms(lambda: pc.lap_level(g4, g5)),
         "plain_ms": cuda_ms(
             lambda: g4 - pyramid.pyr_up(g5, tuple(g4.shape[-2:])))},
    ]
    for k in kernels:
        check(k["max_abs_err"] == 0.0, f"{k['name']} equals its plain version")
    return kernels


class plain_pyramid:
    """Route evm's Laplacian levels through the plain version (on any
    device) inside the ``with`` block."""

    def __enter__(self):
        from respmon_tpu_torch.ops import pyramid_cuda

        self._saved = pyramid_cuda.laplacian_band_levels
        pyramid_cuda.laplacian_band_levels = \
            pyramid_cuda.laplacian_band_levels_ref
        return self

    def __exit__(self, *exc):
        from respmon_tpu_torch.ops import pyramid_cuda

        pyramid_cuda.laplacian_band_levels = self._saved
        return False


def _same_run(a, b, what: str) -> float:
    """Check two ClipRunResults agree; return max relative BPM gap."""
    check(a.found and b.found, f"{what}: both found an ROI")
    check(a.roi == b.roi, f"{what}: ROI {a.roi} == {b.roi}")
    ha, hb = a.measure.has_bpm.cpu(), b.measure.has_bpm.cpu()
    check(bool((ha == hb).all()), f"{what}: has_bpm equal")
    ba, bb = a.measure.bpm.cpu()[ha], b.measure.bpm.cpu()[hb]
    rel = float(((ba - bb).abs() / bb.abs()).max()) if int(ha.sum()) else 0.0
    check(rel <= 1e-5, f"{what}: BPM within rtol 1e-5 (got {rel})")
    return rel


def phase_small_cross_check(dev):
    """The fixture of the CPU parity tests on the card against the CPU
    (the plain path the tests hold against the JAX package)."""
    import torch

    from respmon_tpu.config import CalibrationConfig, MonitorConfig
    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm, scan

    cfg = MonitorConfig(calibration=CalibrationConfig(
        buffer_length=64, pyramid_levels=6, skip_levels_at_top=2))
    clip = breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    on_card = scan.process_clip(torch.from_numpy(clip).to(dev), FPS, cfg)
    on_cpu = scan.process_clip(clip, FPS, cfg)
    rel = _same_run(on_card, on_cpu, "120x160 card vs CPU")

    const = torch.full((32, 48, 64), 0.5, device=dev)
    found = bool(evm.locate(const, FPS, CalibrationConfig(
        pyramid_levels=4, skip_levels_at_top=1, buffer_length=32)).found)
    check(not found, "constant video gives found=False on the card")
    emit({"phase": "small_cross_check", "roi": on_card.roi,
          "bpm_max_rel_vs_cpu": rel, "constant_video_found": found})


def phase_slice(dev):
    """process_clip at 640x480 u8 (the bench.py headline fixture)."""
    import numpy as np
    import torch

    from respmon_tpu.config import MonitorConfig
    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu_torch.ops import filters, pyramid_cuda
    from respmon_tpu_torch.pipeline import evm, motion, scan
    # The repo's tests/ is no package; a site-packages ``tests`` would
    # shadow it, so the golden oracle package is imported from tests/.
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from golden import reference_numpy as golden

    cfg = MonitorConfig()
    cal_len = cfg.calibration.buffer_length
    clip = breathing_clip(num_frames=cal_len + 1 + 128, height=480,
                          width=640, fps=FPS, bpm=18.0,
                          patch_center=(240, 320), patch_size=(80, 100),
                          amplitude=0.12, motion_px=2.0, texture_motion=True)
    frames = torch.from_numpy(quantize(clip)).to(dev)
    del clip

    pyramid_cuda.reset_launches()
    res, first_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    launches = dict(pyramid_cuda.LAUNCHES)
    check(launches["pyr_down"] > 0 and launches["lap_level"] > 0,
          f"the path launched both kernels: {launches}")
    with plain_pyramid():
        plain = scan.process_clip(frames, FPS, cfg)
    check(pyramid_cuda.LAUNCHES == launches, "plain run launched nothing")
    rel = _same_run(res, plain, "640x480 kernels vs plain")

    m = res.measure
    check(m.samples.shape == (frames.shape[0] - cal_len - 2,),
          "one sample per measured frame")
    check(bool(torch.isfinite(m.samples).all()), "samples finite")
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
          "roi": res.roi, "launches": launches, "has_bpm": int(has.sum()),
          "bpm_tail_median": tail_median, "bpm_oracle_delta": oracle_delta,
          "bpm_max_rel_vs_plain": rel, "first_process_clip_s": first_s,
          "process_clip_s": warm_s, "locate_s": locate_s,
          "measure_s": measure_s})
    return launches


def phase_1080p(dev):
    import torch

    from respmon_tpu.config import CalibrationConfig
    from respmon_tpu.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm

    cfg = CalibrationConfig()
    clip = breathing_clip(num_frames=cfg.buffer_length, height=1080,
                          width=1920, fps=FPS, bpm=18.0,
                          patch_center=(540, 960), patch_size=(180, 225),
                          amplitude=0.12)
    frames = torch.from_numpy(quantize(clip)).to(dev)
    del clip

    def bbox(r):
        return [int(v) for v in torch.stack([r.x, r.y, r.w, r.h]).tolist()]

    res = evm.locate(frames, FPS, cfg)
    check(bool(res.found), "1080p locate found an ROI")
    with plain_pyramid():
        plain = evm.locate(frames, FPS, cfg)
    check(bbox(res) == bbox(plain), "1080p ROI equals the plain path's")
    _, locate_s = wall_s(lambda: evm.locate(frames, FPS, cfg).x)
    with plain_pyramid():
        _, plain_s = wall_s(lambda: evm.locate(frames, FPS, cfg).x)
    emit({"phase": "locate_1080p", "frames": list(frames.shape),
          "roi": bbox(res), "locate_s": locate_s, "plain_locate_s": plain_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import respmon_tpu_torch  # noqa: F401  (sets the precision policy)

    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    phase_widen(dev)
    kernels = phase_kernels(dev)
    phase_small_cross_check(dev)
    launches = phase_slice(dev)
    phase_1080p(dev)

    for k in kernels:
        k["launches"] = launches[k["name"].removesuffix("_f32")]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
