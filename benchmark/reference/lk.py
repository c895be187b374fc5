# Frozen copy of respmon_tpu_torch/ops/lk.py:1-337 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package; calc_optical_flow_pyr_lk left out).
"""Pyramidal Lucas-Kanade sparse optical flow (cv2.calcOpticalFlowPyrLK
semantics).

Port of ``respmon_tpu/ops/lk.py``, of its ``"slices"`` window sampling
only: the JAX package's other sampling modes are gather strategies for the
TPU, documented there as bit-identical or ulp-close to ``"slices"``, its
bitwise reference.  The port has this one path and no sampling argument.

The reference tracks Shi-Tomasi corners with ``cv2.calcOpticalFlowPyrLK(prev,
next, pts, None, winSize=(15,15), maxLevel=2, criteria=(EPS|COUNT, 10, 0.03))``
(base.py:96-98, 371-372).  OpenCV's algorithm, reproduced:

  - 3-level image pyramids (pyrDown), Scharr derivatives of the prev level
    (smooth [3,10,3], diff [-1,0,1]; replicate border), derivative samples
    outside the image read as zero (cv2 pads derivatives BORDER_CONSTANT).
  - Per point, coarse-to-fine: at each level gather the 15x15 window around
    the point by bilinear interpolation (reflect-101 image border), form the
    2x2 normal matrix G from the prev window gradients, then Newton-iterate
    ``nextPt += -G^{-1} sum((J-I) * grad)`` up to 10 times or until
    ``||delta||^2 <= 0.03^2`` (cv2 squares epsilon), with cv2's oscillation
    damper (averaging back half a step when successive deltas cancel).
  - Status drops to 0 at level 0 when the window leaves the image, when
    ``det(G) < FLT_EPSILON``, or when the normalized min eigenvalue of G is
    below ``minEigThreshold=1e-4`` (cv2 units: gradients are Scharr x32 and
    accumulators scaled 2^-20, i.e. true-gradient G / 1024, then / winArea).

Each point's bilinear window is cut from a (win+1, win+1) support grid of
the padded level image, fetched for all points with one advanced-index
gather.  The Newton iterations run for the whole point set at once with
masked convergence (no per-point control flow); the loop stops early once no
point is active, which reads one flag from the device per iteration and is
bit-identical to running all iterations.  ``lk_track_precomputed`` also
takes a leading stream axis (the fleet's S streams, each point gathering
from its own stream's images): one Newton loop and one flag read per
iteration serve all streams, where the JAX package ``vmap``s the tracker.  ``FlowResult.iterations`` counts
the iterations run.  Images are expected on the uint8 [0,255] value scale (the reference
converts crops with float_to_uint8 before LK, base.py:364-371), which the
minEig threshold depends on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.pyramid import _reflect101_indices, _take, pyr_down

class FlowResult(NamedTuple):
    pts: torch.Tensor     # (N, 2) float32 tracked positions (x, y)
    status: torch.Tensor  # (N,) bool
    # Newton iterations run over all levels; each cost one device-to-host
    # read of the "any point still active" flag.
    iterations: int = 0


def _scharr_derivs(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """True-gradient Scharr derivatives (cv2 calcScharrDeriv / 32) of a
    (..., H, W) image, replicate border."""
    h, w = img.shape[-2:]
    p = _take(img, np.clip(np.arange(-1, h + 1), 0, h - 1), img.ndim - 2)
    p = _take(p, np.clip(np.arange(-1, w + 1), 0, w - 1), img.ndim - 1)
    sm = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)
    df = (-0.5, 0.0, 0.5)

    def conv(a, taps_y, taps_x):
        acc = None
        for i, wy in enumerate(taps_y):
            for j, wx in enumerate(taps_x):
                c = wy * wx
                if c == 0.0:
                    continue
                term = a[..., i:i + h, j:j + w] * c
                acc = term if acc is None else acc + term
        return acc

    dx = conv(p, sm, df)
    dy = conv(p, df, sm)
    return dx, dy


def _pad_for_windows(img: torch.Tensor, win: int, border: str) -> torch.Tensor:
    """Pre-pad the last two axes so any window with integer base in
    [-win-1, dim-1] is in bounds.  border: 'reflect101' (cv2 image
    pyramids) or 'zero' (cv2 derivative padding)."""
    pad = win + 2
    if border == "reflect101":
        h, w = img.shape[-2:]
        out = _take(img, _reflect101_indices(h, pad), img.ndim - 2)
        return _take(out, _reflect101_indices(w, pad), img.ndim - 1)
    return torch.nn.functional.pad(img, (pad, pad, pad, pad))


def _support_grid(padded: torch.Tensor, pad: int, by: torch.Tensor,
                  bx: torch.Tensor, win: int) -> torch.Tensor:
    """(S, N, ..., win+1, win+1) support grids of padded (S, ..., Hp, Wp)
    arrays at (S, N) integer window bases (unpadded coordinates); point
    (s, n) reads stream s.  The start is clamped into the array as
    ``jax.lax.dynamic_slice`` clamps it: an advanced-index gather does not,
    and a point whose window has left the image (flagged by the caller, its
    window never reaches the output) would read out of range."""
    s = win + 1
    hp, wp = padded.shape[-2:]
    k = torch.arange(s, device=padded.device)
    rows = (by + pad).clamp(0, hp - s)[..., None] + k      # (S, N, s)
    cols = (bx + pad).clamp(0, wp - s)[..., None] + k
    sidx = torch.arange(padded.shape[0],
                        device=padded.device)[:, None, None, None]
    rows = rows[..., :, None]
    cols = cols[..., None, :]
    if padded.ndim == 3:
        return padded[sidx, rows, cols]                    # (S, N, s, s)
    # Advanced indices around a slice put the broadcast (S, N, s, s) first
    # and the channel last.
    return padded[sidx, :, rows, cols].movedim(-1, 2)     # (S, N, C, s, s)


def _bilinear(grid: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor):
    """4-corner bilinear windows (S, N, ..., win*win) of (S, N, ...,
    win+1, win+1) support grids; the weight and add order of the JAX
    package."""
    shape = fy.shape + (1,) * (grid.ndim - fy.ndim)
    fy = fy.reshape(shape)
    fx = fx.reshape(shape)
    out = (grid[..., :-1, :-1] * (1 - fy) * (1 - fx)
           + grid[..., :-1, 1:] * (1 - fy) * fx
           + grid[..., 1:, :-1] * fy * (1 - fx)
           + grid[..., 1:, 1:] * fy * fx)
    return out.flatten(-2)


def _window_slices3(stack: torch.Tensor, pad: int, by, bx, fy, fx, win: int):
    """Three (S, N, win*win) bilinear windows (image, dx, dy) from the
    channel-stacked (S, 3, Hp, Wp) arrays, one support grid per point."""
    w3 = _bilinear(_support_grid(stack, pad, by, bx, win), fy, fx)
    return w3[:, :, 0], w3[:, :, 1], w3[:, :, 2]


def _window_slices1(img_pad: torch.Tensor, pad: int, by, bx, fy, fx,
                    win: int) -> torch.Tensor:
    """Bilinear (S, N, win*win) windows of padded (S, Hp, Wp) images."""
    return _bilinear(_support_grid(img_pad, pad, by, bx, win), fy, fx)


def _bases(pts: torch.Tensor, half: float):
    """Integer window bases and bilinear fractions of (S, N, 2) positions."""
    ip = torch.floor(pts - half)
    fx = (pts[..., 0] - half) - ip[..., 0]
    fy = (pts[..., 1] - half) - ip[..., 1]
    return ip[..., 0].to(torch.int32), ip[..., 1].to(torch.int32), fx, fy


def _track_level(prev_stack: torch.Tensor, next_img: torch.Tensor, hw,
                 prev_pts, next_pts, status, level: int, win: int,
                 max_iters: int, eps2: float, min_eig_thresh: float, dtype):
    """One pyramid level for ALL points of all streams at once (batched
    Newton loop).

    ``prev_stack`` is the level's padded (S, 3, Hp, Wp) (image, dx, dy) of
    each stream's previous frame, ``next_img`` the padded (S, Hp, Wp) image
    of its next frame, ``hw`` the unpadded level shape; points are
    (S, N, 2).  Without the stream axis on any input it tracks one
    stream.  Returns (points, status, the number of iterations run)."""
    if prev_pts.ndim == 2:
        pts, status, ran = _track_level(
            prev_stack[None], next_img[None], hw, prev_pts[None],
            next_pts[None], status[None], level, win, max_iters, eps2,
            min_eig_thresh, dtype)
        return pts[0], status[0], ran
    h, w = hw
    half = (win - 1) * 0.5
    pad = win + 2

    bx, by, fx, fy = _bases(prev_pts, half)
    out_prev = (bx < -win) | (bx >= w) | (by < -win) | (by >= h)
    iw, ixw, iyw = _window_slices3(prev_stack, pad, by, bx, fy, fx, win)

    a11 = (ixw * ixw).sum(dim=-1)
    a12 = (ixw * iyw).sum(dim=-1)
    a22 = (iyw * iyw).sum(dim=-1)
    # cv2-scale checks: accumulators correspond to (32 g)^2 / 2^20.
    sa11, sa12, sa22 = a11 / 1024.0, a12 / 1024.0, a22 / 1024.0
    det_s = sa11 * sa22 - sa12 * sa12
    min_eig = (sa22 + sa11
               - torch.sqrt((sa11 - sa22) ** 2 + 4.0 * sa12 ** 2)) \
        / (2.0 * win * win)
    bad_g = (min_eig < min_eig_thresh) | (det_s < 1.19209290e-07)

    det = a11 * a22 - a12 * a12
    inv_det = torch.where(det.abs() > 0, 1.0 / det, 0.0)

    pts = next_pts
    prev_delta = torch.zeros(pts.shape, dtype=dtype, device=pts.device)
    done = out_prev | bad_g
    lost = torch.zeros(done.shape, dtype=torch.bool, device=pts.device)
    iterations = 0
    for j in range(max_iters):
        # The body freezes finished points, so stopping once none is
        # active (in any stream) is bit-identical to running all
        # max_iters.
        if not bool((~(done | lost)).any()):
            break
        iterations += 1
        jbx, jby, jfx, jfy = _bases(pts, half)
        out_next = (jbx < -win) | (jbx >= w) | (jby < -win) | (jby >= h)
        jw = _window_slices1(next_img, pad, jby.clamp(-pad, h - 1),
                             jbx.clamp(-pad, w - 1), jfy, jfx, win)
        diff = jw - iw
        b1 = (diff * ixw).sum(dim=-1)
        b2 = (diff * iyw).sum(dim=-1)
        # delta = -G^{-1} b (cv2's closed form).
        dxs = (a12 * b2 - a22 * b1) * inv_det
        dys = (a12 * b1 - a11 * b2) * inv_det
        delta = torch.stack([dxs, dys], dim=-1).to(dtype)

        new_pts = pts + delta
        small = (delta * delta).sum(dim=-1) <= eps2
        # cv2 oscillation damper: successive deltas cancel -> half step
        # back.  It compares with the previous iteration's delta of every
        # point, frozen ones included.
        osc = (delta[..., 0] + prev_delta[..., 0]).abs() < 0.01
        osc = osc & ((delta[..., 1] + prev_delta[..., 1]).abs() < 0.01)
        if j == 0:
            osc = torch.zeros_like(osc)
        new_pts = torch.where(osc[..., None], new_pts - delta * 0.5, new_pts)

        active = ~(done | lost)
        pts = torch.where((active & ~out_next)[..., None], new_pts, pts)
        done = done | small | osc | out_next
        lost = lost | (active & out_next)
        prev_delta = delta

    # Status drops only at level 0 (cv2 `if level == 0` convention).
    if level == 0:
        status = status & ~(out_prev | bad_g | lost)
    return pts, status, iterations


class LKFrameInputs(NamedTuple):
    """Everything LK needs about ONE frame, precomputable and batchable.

    ``stacks``: per-level padded (3, Hp, Wp) (image, dx, dy), used when
    this frame plays the *prev* role.  ``images``: per-level padded
    (Hp, Wp) images, the *next* role.  With a leading frame axis on the
    input, every array carries it too: the whole-clip path builds all
    frames' inputs as one batch before its frame loop.
    """

    stacks: Tuple[torch.Tensor, ...]
    images: Tuple[torch.Tensor, ...] = ()


def level_geometry(h: int, w: int, max_level: int):
    """Static per-level shapes of the pyramid of (h, w) images."""
    shapes = [(h, w)]
    for _ in range(max_level):
        hh, ww = shapes[-1]
        shapes.append(((hh + 1) // 2, (ww + 1) // 2))
    return shapes


def precompute_frame_inputs(img: torch.Tensor, win: int = 15,
                            max_level: int = 2, with_stacks: bool = True,
                            with_images: bool = False) -> LKFrameInputs:
    """Pyramid + Scharr + padding of one (H, W) frame, or of a (T, H, W)
    batch of frames.  ``with_stacks``/``with_images`` select the prev-role /
    next-role structures for callers that need only one."""
    pyr = [img]
    for _ in range(max_level):
        pyr.append(pyr_down(pyr[-1]))
    stacks = []
    images = []
    for p in pyr:
        padded = _pad_for_windows(p, win, "reflect101")
        if with_stacks:
            dxm, dym = _scharr_derivs(p)
            stacks.append(torch.stack([
                padded,
                _pad_for_windows(dxm, win, "zero"),
                _pad_for_windows(dym, win, "zero")], dim=-3))
        if with_images:
            images.append(padded)
    return LKFrameInputs(stacks=tuple(stacks), images=tuple(images))


def lk_track_precomputed(prev: LKFrameInputs, nxt: LKFrameInputs,
                         pts: torch.Tensor, valid: torch.Tensor,
                         shapes, win: int = 15, max_level: int = 2,
                         max_iters: int = 10, eps: float = 0.03,
                         min_eig_thresh: float = 1e-4) -> FlowResult:
    """LK tracking from precomputed single-frame inputs (``prev.stacks``
    and ``nxt.images``, see LKFrameInputs); ``shapes`` comes from
    ``level_geometry``.

    With a leading stream axis on every input (stacks (S, 3, Hp, Wp),
    images (S, Hp, Wp), ``pts`` (S, N, 2), ``valid`` (S, N)) it tracks the
    S streams' points in one Newton loop per level, and the result carries
    the stream axis too."""
    dtype = prev.stacks[0].dtype
    eps2 = min(max(eps, 0.0), 10.0) ** 2      # cv2 clamps, then squares

    pts = pts.to(dtype)
    next_pts = pts / (2.0 ** (max_level + 1))
    status = valid
    iterations = 0
    for level in range(max_level, -1, -1):
        prev_pts = pts / (2.0 ** level)
        next_pts = next_pts * 2.0
        next_pts, status, ran = _track_level(
            prev.stacks[level], nxt.images[level], shapes[level], prev_pts,
            next_pts, status, level, win, max_iters, eps2, min_eig_thresh,
            dtype)
        iterations += ran

    return FlowResult(pts=next_pts.to(torch.float32), status=status & valid,
                      iterations=iterations)
