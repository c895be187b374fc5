"""The pyramid kernels of the EVM calibration: CUDA on the GPU, plain
PyTorch on the CPU.

Counterpart of ``respmon_tpu/ops/pyramid_pallas.py``:

  - ``laplacian_band_levels`` (its K1): Laplacian levels
    [skip_top, levels-2] of a (T, H, W) video — ``levels-1`` launches of
    ``pyr_down_f32`` and one ``lap_level_f32`` per kept level;
  - ``gauss_level`` (its K2, ``gauss_level_tiled``): Gaussian level ``s1``
    — ``s1`` launches of ``pyr_down_f32``.  The TPU split 1080p frames into
    W-strips to fit VMEM; a Hopper kernel tiles by thread block and takes
    every frame size whole.

The kernels live in ``csrc/pyramid.cu``.  ``pyr_down`` and ``lap_level``
are the wrappers: for a CPU tensor they run the plain version
(``ops/pyramid.py``); for a CUDA tensor they launch the kernel or raise.
``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from respmon_tpu_torch.ops import pyramid

LAUNCHES = {"pyr_down": 0, "lap_level": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from respmon_tpu_torch.ops import _build

    lib = _build.load("pyramid")
    if not getattr(lib, "_respmon_bound", False):
        lib.pyr_down_f32.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.pyr_down_f32.restype = _I
        lib.lap_level_f32.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.lap_level_f32.restype = _I
        lib._respmon_bound = True
    return lib


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


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown of a (T, H, W) f32 video (the ``pyr_down_f32`` kernel)."""
    if x.device.type == "cpu":
        return pyramid.pyr_down(x)
    _check(x, "pyr_down")
    t_len, h, w = x.shape
    out = torch.empty((t_len, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_lib().pyr_down_f32(x.data_ptr(), out.data_ptr(), t_len, h, w,
                                  stream), "pyr_down_f32")
    LAUNCHES["pyr_down"] += 1
    return out


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
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _raise_on(_lib().lap_level_f32(g.data_ptr(), gn.data_ptr(),
                                   out.data_ptr(), t_len, h, w, hn, wn,
                                   stream), "lap_level_f32")
    LAUNCHES["lap_level"] += 1
    return out


def gauss_level(vid: torch.Tensor, s1: int) -> torch.Tensor:
    """Gaussian pyramid level ``s1`` of a (T, H, W) video (K2)."""
    g = vid
    for _ in range(s1):
        g = pyr_down(g)
    return g


def laplacian_band_levels(vid: torch.Tensor, levels: int,
                          skip_top: int) -> Tuple[torch.Tensor, ...]:
    """Laplacian levels [skip_top, levels-2] of a (T, H, W) video (K1)."""
    gauss = [vid]
    for _ in range(1, levels):
        gauss.append(pyr_down(gauss[-1]))
    return tuple(lap_level(gauss[lvl], gauss[lvl + 1])
                 for lvl in range(skip_top, levels - 1))


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
