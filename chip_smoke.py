#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``respmon_tpu_torch/csrc`` (one nvcc
per source, into ``build/``; the build line also holds what ptxas says of
each kernel), checks each against its plain
PyTorch version on the card (the stencil kernels bit for bit, along the
launches their plan makes for each parity geometry; the band kernels also
on dense, all-zero-tile, unaligned and minuend operands), and drives the
whole-clip path
``process_clip`` at 640x480 in average mode and in flow mode (Shi-Tomasi
corners, pyramidal LK, 2x2 PCA), one 640x480 calibration with the
band-matrix pyramid (K3) in place of the stencil one (K1), and one 1080p
calibration, checking what comes out.  Then the live monitor
(``runtime.RespiratoryMonitor``) on the same 640x480 clip, frame by frame,
in average and in flow mode (``phase_monitor``), fed by the native frame
ring (``phase_feeder``), and through a blackout, the error state and a
recalibration (``phase_monitor_recovery``); the last two also split each
measured frame's time between the motion step and the BPM estimate.  Each
phase prints one JSON line; then the kernel table, the card's name and
power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
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
    from respmon_tpu_torch.ops import pyramid_cuda, pyramid_mm

    pyramid_cuda.reset_launches()
    pyramid_mm.reset_launches()


def read_launches() -> dict:
    """Every kernel's launch count since ``reset_launches``."""
    from respmon_tpu_torch.ops import pyramid_cuda, pyramid_mm

    return {**pyramid_cuda.LAUNCHES, **pyramid_mm.LAUNCHES}


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
    counts = dict.fromkeys(pyramid_cuda.LAUNCHES, 0)
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
    from respmon_tpu_torch.ops import _build, pyramid_cuda, pyramid_mm

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

    # One nvcc per source, both started together.
    names = ("pyramid", "band_mm")
    with ThreadPoolExecutor(len(names)) as pool:
        libraries = dict(zip(names, pool.map(build, names)))
    pyramid_cuda._lib()
    pyramid_mm._lib()
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
    host_us = {}
    for what, call in [
            ("band_left", lambda: pm.band_left(tiny_op, tiny)),
            ("torch.matmul", lambda: torch.matmul(tiny_op.matrix, tiny))]:
        call()
        _, seconds = wall_s(lambda: [call() for _ in range(2000)])
        host_us[what] = seconds / 2000 * 1e6
    emit({"phase": "host_us_per_call", **host_us})

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
    (the plain path the tests hold against the JAX package)."""
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

    const = torch.full((32, 48, 64), 0.5, device=dev)
    found = bool(evm.locate(const, FPS, CalibrationConfig(
        pyramid_levels=4, skip_levels_at_top=1, buffer_length=32)).found)
    check(not found, "constant video gives found=False on the card")
    emit({"phase": "small_cross_check", "roi": on_card.roi,
          "bpm_max_rel_vs_cpu": rel, "constant_video_found": found})


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


# The recovery clip: 1 + 128 calibration frames + 1 dropped, 30 measured,
# a 15-frame blackout, then room to recalibrate (1 + 128 + 1) and to
# measure until a BPM comes again.
RECOVERY_FRAMES = 400


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
    check(read_launches() == launches, "plain run launched nothing")
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
    check(not any(launches[k] for k in pyramid_cuda.LAUNCHES),
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
    the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.pipeline import scan

    cfg = MonitorConfig(motion_extraction_method="flow")
    _, plain_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, profiled_s = wall_s(lambda: scan.process_clip(frames, FPS, cfg))
    n_kernels = 0
    device_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            device_us += ev.time_range.elapsed_us()
    check(device_us > 0, "the profiler saw device activity")
    emit({"phase": "flow_profile", "process_clip_s": plain_s,
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
    float32 fit and the float64 refit of wild fits), each to the end of
    its device work, and count each fit's LM steps (each step solves
    ``2 * _TR_NEWTON_ITERS + 2`` 3x3 systems).  ``report()`` gives each
    one's ms per call and the LM steps per fit."""

    def __init__(self):
        self.seconds = {"motion_step": [], "estimate_bpm": [],
                        "gauss_fit_f32": [], "gauss_fit_f64": []}
        self.lm_steps = {"gauss_fit_f32": [], "gauss_fit_f64": []}
        self._solves = 0

    def _timed(self, fn, name_of):
        import torch

        from respmon_tpu_torch.ops import gaussfit

        def timed(*args, **kwargs):
            name = name_of(args)
            solves, t0 = self._solves, time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            if name in self.lm_steps:
                self.lm_steps[name].append(
                    (self._solves - solves)
                    // (2 * gaussfit._TR_NEWTON_ITERS + 2))
            return out
        return timed

    def __enter__(self):
        import torch

        from respmon_tpu_torch.ops import gaussfit
        from respmon_tpu_torch.pipeline import bpm, motion

        self._saved = [(motion, "measure_step", motion.measure_step),
                       (bpm, "estimate_bpm", bpm.estimate_bpm),
                       (gaussfit, "gaussian_fit_batch",
                        gaussfit.gaussian_fit_batch),
                       (gaussfit, "_solve3", gaussfit._solve3)]
        solve3 = gaussfit._solve3

        def counted_solve3(*args, **kwargs):
            self._solves += 1
            return solve3(*args, **kwargs)

        gaussfit._solve3 = counted_solve3
        motion.measure_step = self._timed(motion.measure_step,
                                          lambda a: "motion_step")
        bpm.estimate_bpm = self._timed(bpm.estimate_bpm,
                                       lambda a: "estimate_bpm")
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
        steps = drive_monitor(mon)
        launches[method] = read_launches()
        calibrations = len(mon.benchmarker.ticks["Calibration Measurement"])
        check_k1_calibrations(launches[method], calibrations,
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
               "calibrations": calibrations, "bpm_count": len(freq),
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
    recalibration and BPM again.  Returns the run's launches."""
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
    return launches


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
    check(bool(res.found), "1080p locate found an ROI")
    with pyramid_route():
        plain = evm.locate(frames, FPS, cfg)
    check(_bbox(res) == _bbox(plain), "1080p ROI equals the plain path's")
    _, locate_s = wall_s(lambda: evm.locate(frames, FPS, cfg).x)
    with pyramid_route():
        _, plain_s = wall_s(lambda: evm.locate(frames, FPS, cfg).x)
    emit({"phase": "locate_1080p", "frames": list(frames.shape),
          "roi": _bbox(res), "launches": launches, "locate_s": locate_s,
          "plain_locate_s": plain_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


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
    kernels, lap_path = phase_kernels(dev)
    kernels += phase_kernels_k3(dev)
    phase_small_cross_check(dev)
    frames = slice_frames(dev)
    roi, avg_launches = phase_slice(frames)
    k3_launches = phase_k3_locate(frames, roi)
    flow_launches = phase_flow_slice(frames, roi)
    phase_flow_profile(frames)
    host_frames = frames.cpu().numpy()
    del frames
    monitor_launches, average_mon = phase_monitor(host_frames)
    phase_feeder(host_frames, average_mon)
    del host_frames
    recovery_launches = phase_monitor_recovery(recovery_frames())
    launches_1080p = phase_1080p(dev)

    # Each path was driven with every count at 0 just before it and read
    # just after.  ``launches`` is the count on the kernel's own path: the
    # flow slice for A (d = 2) and B, the 1080p locate for A (d = 1), the
    # L9/S1 parity run for lap_level_f32 (no default configuration takes
    # its route), the K3 calibration for the band kernels.
    paths = {"slice_640x480": avg_launches, "flow_640x480": flow_launches,
             "k3_locate_640x480": k3_launches,
             "k1_parity_4x480x640_l9s1": lap_path,
             "locate_1080p": launches_1080p,
             "monitor_640x480_average": monitor_launches["average"],
             "monitor_640x480_flow": monitor_launches["flow"],
             "monitor_recovery_640x480": recovery_launches}
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
        k["path"] = own_path[key]
        k["launches"] = paths[own_path[key]][key]
        check(k["launches"] > 0, f"{k['name']} launched on its path")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
