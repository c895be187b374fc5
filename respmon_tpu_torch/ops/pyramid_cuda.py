"""The pyramid kernels of the EVM calibration: CUDA on the GPU, plain
PyTorch on the CPU.

Counterpart of ``respmon_tpu/ops/pyramid_pallas.py``:

  - ``laplacian_band_levels`` (its K1): Laplacian levels
    [skip_top, levels-2] of a (T, H, W) video, run by the launches of
    ``plan``: at 640x480 L9/S4 one ``pyr_down_levels_f32`` (A, two fused
    pyrDowns) and one ``pyr_tail_f32`` (B, the rest of the pyramid per
    frame in shared memory, the kept levels out);
  - ``gauss_level`` (its K2, ``gauss_level_tiled``): Gaussian level ``s1``
    — A in steps of at most two levels.  The TPU split 1080p frames into
    W-strips to fit VMEM; A tiles every frame size by thread block.

The kernels live in ``csrc/pyramid.cu``.  ``pyr_down``, ``pyr_tail`` and
``lap_level`` are the wrappers: for a CPU tensor they run the plain version
(``ops/pyramid.py``); for a CUDA tensor they launch the kernel or raise.
``ops/_build.LAUNCHES`` counts their launches per kernel, A's per
instantiation (``pyr_down_levels_d1``, ``pyr_down_levels_d2``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from respmon_tpu_torch.ops import _build, pyramid
from respmon_tpu_torch.ops.pyramid import pyramid_shapes

MAX_FUSED = 2                 # pyrDowns that one launch of A fuses
TAIL_BUDGET_BYTES = 200 * 1024  # B's shared memory, of a block's 227 KB

KERNELS = _build.Kernels(
    "pyramid", {"pyr_down_levels_f32": "ppiiii", "pyr_tail_f32": "ppiiiii",
                "lap_level_f32": "pppiiiii"},
    counted=[f"pyr_down_levels_d{d}" for d in range(1, MAX_FUSED + 1)]
    + ["pyr_tail", "lap_level"])


class Plan(NamedTuple):
    """The launches of ``laplacian_band_levels`` for one geometry."""
    tail_from: int     # s: B computes levels s..levels-1 of each frame
    downs: Tuple[Tuple[int, int], ...]  # (level, d) of each A, in order
    laps: Tuple[int, ...]  # kept levels above s: one lap_level_f32 each
    tail: bool         # whether B runs (a kept level lies at s or below)


def tail_bytes(h: int, w: int, levels: int, first: int) -> int:
    """Bytes of levels ``first``..``levels-1`` of one (h, w) frame."""
    return 4 * sum(a * b for a, b in pyramid_shapes(h, w, levels)[first:])


def _fused(lo: int, hi: int) -> Tuple[Tuple[int, int], ...]:
    """A's launches from level ``lo`` to level ``hi``, d <= MAX_FUSED."""
    steps = []
    while lo < hi:
        d = min(MAX_FUSED, hi - lo)
        steps.append((lo, d))
        lo += d
    return tuple(steps)


def plan(h: int, w: int, levels: int, skip_top: int) -> Plan:
    """s is the first level whose remaining pyramid fits B's budget.  A
    reaches it in fused steps; a kept level above it (``skip_top < s``)
    takes A with d = 1 for each level down to s and a ``lap_level_f32``."""
    s = next((lvl for lvl in range(levels)
              if tail_bytes(h, w, levels, lvl) <= TAIL_BUDGET_BYTES),
             levels - 1)
    if skip_top >= levels - 1:
        return Plan(s, (), (), False)
    if skip_top < s:
        downs = _fused(0, skip_top) + tuple(
            (lvl, 1) for lvl in range(skip_top, s))
        laps = tuple(range(skip_top, s))
    else:
        downs, laps = _fused(0, s), ()
    return Plan(s, downs, laps, s <= levels - 2)


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{name}: expected (T, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def pyr_down(x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """cv2.pyrDown applied ``d`` times (1 <= d <= MAX_FUSED) to a
    (T, H, W) f32 video, in one launch of the ``pyr_down_levels_f32``
    kernel (A)."""
    if not 1 <= d <= MAX_FUSED:
        raise ValueError(f"pyr_down: d = {d} is not in [1, {MAX_FUSED}]")
    if x.device.type == "cpu":
        for _ in range(d):
            x = pyramid.pyr_down(x)
        return x
    _check(x, "pyr_down")
    t_len, h, w = x.shape
    out = torch.empty((t_len,) + pyramid_shapes(h, w, d + 1)[d],
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    KERNELS.launch("pyr_down_levels_f32", x.device, x.data_ptr(),
                   out.data_ptr(), t_len, h, w, d,
                   count=f"pyr_down_levels_d{d}")
    return out


def pyr_tail(g: torch.Tensor, levels: int,
             first_kept: int) -> Tuple[torch.Tensor, ...]:
    """Laplacian levels [first_kept, levels-2] of the ``levels``-level
    pyramid of a (T, h, w) f32 video, in one launch of the ``pyr_tail_f32``
    kernel (B); the pyramid of a frame must fit ``TAIL_BUDGET_BYTES``."""
    if g.device.type == "cpu":
        return laplacian_band_levels_ref(g, levels, first_kept)
    _check(g, "pyr_tail")
    t_len, h, w = g.shape
    if not 0 <= first_kept <= levels - 2:
        raise ValueError(f"pyr_tail: levels {levels}, first kept "
                         f"{first_kept}")
    if tail_bytes(h, w, levels, 0) > TAIL_BUDGET_BYTES:
        raise ValueError(f"pyr_tail: the {levels}-level pyramid of a "
                         f"{h}x{w} frame exceeds {TAIL_BUDGET_BYTES} bytes")
    # The kept levels, one after another in one buffer.
    shapes = [(t_len,) + hw for hw in
              pyramid_shapes(h, w, levels)[first_kept:levels - 1]]
    sizes = [a * b * c for a, b, c in shapes]
    flat = torch.empty(sum(sizes), dtype=g.dtype, device=g.device)
    outs = tuple(part.view(shape) for part, shape in
                 zip(flat.split(sizes), shapes))
    if g.numel() == 0:
        return outs
    KERNELS.launch("pyr_tail_f32", g.device, g.data_ptr(), flat.data_ptr(),
                   t_len, h, w, levels, first_kept, count="pyr_tail")
    return outs


def lap_level(g: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
    """``g - pyrUp(gn, g's size)`` for (T, h, w) / (T, hn, wn) f32 videos
    (the ``lap_level_f32`` kernel)."""
    if g.device.type == "cpu" and gn.device.type == "cpu":
        return g - pyramid.pyr_up(gn, tuple(g.shape[-2:]))
    _check(g, "lap_level")
    _check(gn, "lap_level")
    if g.device != gn.device:
        raise ValueError("lap_level: g and gn on different devices")
    t_len, h, w = g.shape
    tn, hn, wn = gn.shape
    if tn != t_len or not (h <= 2 * hn and w <= 2 * wn and hn > 0 and wn > 0):
        raise ValueError(f"lap_level: {tuple(gn.shape)} does not pyrUp to "
                         f"{tuple(g.shape)}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    KERNELS.launch("lap_level_f32", g.device, g.data_ptr(), gn.data_ptr(),
                   out.data_ptr(), t_len, h, w, hn, wn, count="lap_level")
    return out


def gauss_level(vid: torch.Tensor, s1: int) -> torch.Tensor:
    """Gaussian pyramid level ``s1`` of a (T, H, W) video (K2)."""
    g = vid
    for _, d in _fused(0, s1):
        g = pyr_down(g, d)
    return g


def laplacian_band_levels(vid: torch.Tensor, levels: int,
                          skip_top: int) -> Tuple[torch.Tensor, ...]:
    """Laplacian levels [skip_top, levels-2] of a (T, H, W) video (K1)."""
    if vid.ndim != 3:
        raise ValueError(f"expected (T, H, W), got {tuple(vid.shape)}")
    p = plan(vid.shape[1], vid.shape[2], levels, skip_top)
    gauss = {0: vid}
    for lvl, d in p.downs:
        gauss[lvl + d] = pyr_down(gauss[lvl], d)
    out = tuple(lap_level(gauss[lvl], gauss[lvl + 1]) for lvl in p.laps)
    if p.tail:
        out += pyr_tail(gauss[p.tail_from], levels - p.tail_from,
                        max(skip_top - p.tail_from, 0))
    return out


def gauss_level_ref(vid: torch.Tensor, s1: int) -> torch.Tensor:
    """Plain version of ``gauss_level`` on any device."""
    return pyramid.gaussian_pyramid(vid, s1 + 1)[s1]


def laplacian_band_levels_ref(vid: torch.Tensor, levels: int,
                              skip_top: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``laplacian_band_levels`` on any device."""
    gauss = pyramid.gaussian_pyramid(vid, levels)
    return tuple(gauss[lvl] - pyramid.pyr_up(gauss[lvl + 1],
                                             tuple(gauss[lvl].shape[-2:]))
                 for lvl in range(skip_top, levels - 1))
