"""Connected-component labeling and the largest region's bounding box.

Port of ``respmon_tpu/ops/ccl.py`` (reference base.py:566-575: threshold ->
``cv2.findContours(RETR_EXTERNAL)`` -> max ``contourArea`` ->
``boundingRect``).  ``largest_component_bbox_batch`` takes a batch of
masks: a CUDA tensor goes through ``csrc/ccl.cu``, a union-find in six
launches a batch with no host read; a CPU tensor takes the plain version,
``_largest_component_bbox``, one mask at a time.  The plain version's labels
propagate by sweeps of an 8-neighbourhood min plus segmented min-scans
along rows and columns (Hillis-Steele doubling with contiguous shifts)
until a sweep changes nothing — one ``.any()`` host check per sweep (the
``locate.ccl`` span counts them).  Areas are cv2's polygon areas,
decomposed over 2x2 pixel-centre quads of the hole-filled mask (4 filled ->
1, 3 -> 1/2); the ``argmax`` over labels keeps the raster-first component
on ties, as ``torch.argmax`` documents it returns the first maximal index.
The kernel computes the same function bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from respmon_tpu_torch.ops import _build
from respmon_tpu_torch.utils.bench import span

# csrc/ccl.cu: one call a batch of masks on a CUDA tensor (six kernels
# each), counted as ccl.
KERNELS = _build.Kernels("ccl", {"ccl_largest_bbox": "piiipppp"},
                         counted=("ccl",))

# The kernel sums areas in halves, exact in float32 (as the plain version's
# sums are) below 2**23: it takes masks of fewer pixels.
MAX_PIXELS = 2 ** 23


class BBoxResult(NamedTuple):
    x: torch.Tensor        # int32
    y: torch.Tensor        # int32
    w: torch.Tensor        # int32
    h: torch.Tensor        # int32
    found: torch.Tensor    # bool
    area: torch.Tensor     # float32 — cv2-style polygon area


def _pad_const(x: torch.Tensor, pad, fill) -> torch.Tensor:
    """Constant pad of a bool/int tensor (``pad`` in F.pad order)."""
    if x.dtype == torch.bool:
        return F.pad(x.to(torch.uint8), pad, value=int(fill)).to(torch.bool)
    return F.pad(x, pad, value=fill)


def _neighbor_min(lab: torch.Tensor, big: int) -> torch.Tensor:
    """Min label over the 8-neighbourhood (out-of-image = big)."""
    h, w = lab.shape
    p = _pad_const(lab, (1, 1, 1, 1), big)
    out = lab
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return out


def _neighbor_min4(lab: torch.Tensor, big: int) -> torch.Tensor:
    """Min label over the 4-neighbourhood (out-of-image = big)."""
    h, w = lab.shape
    p = _pad_const(lab, (1, 1, 1, 1), big)
    out = lab
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return out


def _shifted(x: torch.Tensor, d: int, axis: int, fill, front: bool) \
        -> torch.Tensor:
    """Contiguous shift by ``d`` along ``axis`` (0 or 1 of a 2-D tensor):
    front=True gives out[i] = x[i-d] (filled at the start), else
    out[i] = x[i+d]."""
    n = x.shape[axis]
    if axis == 1:
        pad = (d, 0) if front else (0, d)
    else:
        pad = (0, 0, d, 0) if front else (0, 0, 0, d)
    p = _pad_const(x, pad, fill)
    start = 0 if front else d
    return p.narrow(axis, start, n)


def _segmented_min_scan(lab: torch.Tensor, fg: torch.Tensor, axis: int,
                        big: int) -> torch.Tensor:
    """Min-propagate labels along ``axis`` within contiguous foreground
    runs, both directions, in O(log n) doubling steps."""
    n = lab.shape[axis]
    fill = torch.full_like(lab, big)
    m0 = torch.where(fg, lab, fill)
    b0 = ~fg
    out = None
    for front in (True, False):
        m, b = m0, b0
        d = 1
        while d < n:
            ms = _shifted(m, d, axis, big, front)
            bs = _shifted(b, d, axis, True, front)
            m = torch.where(b, m, torch.minimum(m, ms))
            b = b | bs
            d *= 2
        out = m if out is None else torch.minimum(out, m)
    return torch.where(fg, out, fill)


def _sweep_to_fixed_point(val: torch.Tensor, fg: torch.Tensor, big: int,
                          neighbor):
    """Sweep until nothing changes; returns (the fixed point, the sweeps
    run, each one host read)."""
    fill = torch.full_like(val, big)
    sweeps = 0
    while True:
        new = torch.where(fg, neighbor(val, big), fill)
        new = _segmented_min_scan(new, fg, 1, big)
        new = _segmented_min_scan(new, fg, 0, big)
        sweeps += 1
        if not bool((new != val).any()):
            return new, sweeps
        val = new


def _label_components(fg: torch.Tensor):
    """``label_components`` and its sweeps."""
    h, w = fg.shape
    big = h * w
    idx = torch.arange(big, dtype=torch.int32, device=fg.device).reshape(h, w)
    lab = torch.where(fg, idx, torch.full_like(idx, big))
    return _sweep_to_fixed_point(lab, fg, big, _neighbor_min)


def label_components(fg: torch.Tensor) -> torch.Tensor:
    """8-connected component labels: each foreground pixel gets the
    smallest flat index of its component; background gets H*W."""
    return _label_components(fg)[0]


def _outside_mask(bg: torch.Tensor):
    """``outside_mask`` and its sweeps."""
    h, w = bg.shape
    border = torch.zeros((h, w), dtype=torch.bool, device=bg.device)
    border[0, :] = True
    border[h - 1, :] = True
    border[:, 0] = True
    border[:, w - 1] = True
    val = torch.where(bg, torch.where(border, 0, 1), 2).to(torch.int32)
    val, sweeps = _sweep_to_fixed_point(val, bg, 2, _neighbor_min4)
    return bg & (val == 0), sweeps


def outside_mask(bg: torch.Tensor) -> torch.Tensor:
    """Background pixels 4-connected to the image border (holes of an
    8-connected foreground are sealed by diagonal pinches)."""
    return _outside_mask(bg)[0]


def _fill_holes(fg: torch.Tensor):
    """``fill_holes`` and its sweeps."""
    outside, sweeps = _outside_mask(~fg)
    return fg | ~outside, sweeps


def fill_holes(fg: torch.Tensor) -> torch.Tensor:
    """fg with enclosed background regions filled (RETR_EXTERNAL's view)."""
    return _fill_holes(fg)[0]


def largest_component_bbox(fg: torch.Tensor) -> BBoxResult:
    """Bounding box (x, y, w, h), cv2 convention, of the component with the
    largest cv2.contourArea-equivalent outer-contour area of an (H, W)
    mask: ``largest_component_bbox_batch`` of one mask, 0-d fields."""
    return BBoxResult(*(f[0] for f in largest_component_bbox_batch(fg[None])))


def largest_component_bbox_batch(fg: torch.Tensor) -> BBoxResult:
    """``largest_component_bbox`` of each mask of an (S, H, W) bool batch,
    fields of shape (S,), in one ``locate.ccl`` span that counts the
    ``images`` and the host reads, ``sweeps``: the plain version's
    fixed-point sweeps on the CPU, 0 on the card.  A CUDA tensor runs
    ``csrc/ccl.cu`` on the current stream, without a synchronise or a host
    read; a CPU tensor the plain version, one mask at a time.  An empty
    mask gives found False, area -inf and the box (W, H, -W, -H)."""
    if fg.dtype != torch.bool or fg.ndim != 3 or 0 in fg.shape:
        raise ValueError(f"ccl: expected an (S, H, W) bool batch, none of "
                         f"them 0, got {fg.dtype} {tuple(fg.shape)}")
    with span("locate.ccl") as rec:
        if fg.device.type == "cpu":
            parts = [_largest_component_bbox(img) for img in fg]
            rec.set(sweeps=sum(n for _, n in parts), images=len(parts))
            return BBoxResult(*(torch.stack(f)
                                for f in zip(*(box for box, _ in parts))))
        box = _bbox_cuda(fg)
        rec.set(sweeps=0, images=fg.shape[0])
        return box


def _bbox_cuda(fg: torch.Tensor) -> BBoxResult:
    """``largest_component_bbox_batch``'s body on the card: one call of
    ``csrc/ccl.cu`` (six launches on the current stream)."""
    s, h, w = fg.shape
    if fg.device.type != "cuda":
        raise ValueError(f"ccl: expected a CPU or CUDA tensor, got "
                         f"{fg.device}")
    if not fg.is_contiguous():
        raise ValueError("ccl: expected a contiguous batch")
    if h * w >= MAX_PIXELS or s > 65535 or s * h * w >= 2 ** 31:
        raise ValueError(f"ccl: the kernel takes masks of fewer than "
                         f"{MAX_PIXELS} pixels, at most 65535 of them and "
                         f"fewer than 2**31 pixels in all, got "
                         f"{tuple(fg.shape)}")
    dev = fg.device
    work = torch.empty(9 * s * h * w + s, dtype=torch.int32, device=dev)
    xywh = torch.empty((4, s), dtype=torch.int32, device=dev)
    found = torch.empty(s, dtype=torch.bool, device=dev)
    area = torch.empty(s, dtype=torch.float32, device=dev)
    KERNELS.launch("ccl_largest_bbox", dev, fg.data_ptr(), s, h, w,
                   work.data_ptr(), xywh.data_ptr(), found.data_ptr(),
                   area.data_ptr(), count="ccl")
    return BBoxResult(x=xywh[0], y=xywh[1], w=xywh[2], h=xywh[3],
                      found=found, area=area)


def _largest_component_bbox(fg: torch.Tensor):
    """The plain version of one (H, W) mask's box (a ``BBoxResult`` of 0-d
    tensors), and its sweeps."""
    h, w = fg.shape
    big = h * w
    dev = fg.device
    filled, sweeps_fill = _fill_holes(fg)
    lab, sweeps_lab = _label_components(filled)
    flat = lab.reshape(-1).to(torch.long)

    # index_add_ of multiples of 0.5: exact in f32 in any order.
    npix = torch.zeros(big + 1, dtype=torch.float32, device=dev)
    npix.index_add_(0, flat, filled.reshape(-1).to(torch.float32))

    fi = filled.to(torch.int32)
    q = fi[:-1, :-1] + fi[:-1, 1:] + fi[1:, :-1] + fi[1:, 1:]
    cell = torch.where(q == 4, 1.0, torch.where(q == 3, 0.5, 0.0)) \
        .to(torch.float32)
    cl = torch.minimum(torch.minimum(lab[:-1, :-1], lab[:-1, 1:]),
                       torch.minimum(lab[1:, :-1], lab[1:, 1:]))
    areas = torch.zeros(big + 1, dtype=torch.float32, device=dev)
    areas.index_add_(0, cl.reshape(-1).to(torch.long), cell.reshape(-1))
    areas[big] = -torch.inf
    areas = torch.where(npix > 0, areas, -torch.inf)
    best = torch.argmax(areas)

    sel = (lab == best) & filled
    rows = sel.any(dim=1)
    cols = sel.any(dim=0)
    ridx = torch.arange(h, device=dev)
    cidx = torch.arange(w, device=dev)
    y0 = torch.where(rows, ridx, h).min()
    y1 = torch.where(rows, ridx, -1).max()
    x0 = torch.where(cols, cidx, w).min()
    x1 = torch.where(cols, cidx, -1).max()

    i32 = torch.int32
    return BBoxResult(x=x0.to(i32), y=y0.to(i32), w=(x1 - x0 + 1).to(i32),
                      h=(y1 - y0 + 1).to(i32), found=fg.any(),
                      area=areas[best]), sweeps_fill + sweeps_lab
