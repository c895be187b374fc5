"""Connected-component labeling and the largest region's bounding box.

Port of ``respmon_tpu/ops/ccl.py`` (reference base.py:566-575: threshold ->
``cv2.findContours(RETR_EXTERNAL)`` -> max ``contourArea`` ->
``boundingRect``).  Labels propagate by sweeps of an 8-neighbourhood min
plus segmented min-scans along rows and columns (Hillis-Steele doubling
with contiguous shifts) until a sweep changes nothing — one ``.any()`` host
check per sweep (``largest_component_bbox``'s ``locate.ccl`` span counts
them).  Areas are cv2's polygon areas, decomposed over 2x2 pixel-centre
quads of the hole-filled mask (4 filled -> 1, 3 -> 1/2); the ``argmax``
over labels keeps the raster-first component on ties, as
``torch.argmax`` documents it returns the first maximal index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from respmon_tpu_torch.utils.bench import span


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
    largest cv2.contourArea-equivalent outer-contour area, in a
    ``locate.ccl`` span that counts the fixed-point ``sweeps``."""
    with span("locate.ccl") as rec:
        box, sweeps = _largest_component_bbox(fg)
        rec.set(sweeps=sweeps)
        return box


def _largest_component_bbox(fg: torch.Tensor):
    """``largest_component_bbox`` and its sweeps."""
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
