# Frozen copy of respmon_tpu_torch/ops/corners.py:1-228 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package; good_features_to_track left out).
"""Shi-Tomasi corner detection (cv2.goodFeaturesToTrack semantics).

Port of ``respmon_tpu/ops/corners.py``.  The reference seeds its
optical-flow tracker with ``cv2.goodFeaturesToTrack(img, maxCorners=100,
qualityLevel=0.3, minDistance=7, blockSize=7)`` (base.py:91-94, 365-366).
OpenCV's algorithm:

  1. ``cornerMinEigenVal``: Sobel-3 gradients (BORDER_REFLECT_101), per-pixel
     2x2 structure tensor summed over a blockSize box (unnormalized), then
     the min eigenvalue ``(a+c) - sqrt((a-c)^2 + b^2)`` with a=0.5*Sxx,
     b=Sxy, c=0.5*Syy.  (OpenCV folds a constant 1/(2^(ksize-1)*block*255)
     into the gradients; the selection below is scale-invariant, so it is
     left out.)
  2. Threshold at ``qualityLevel * max(eig)`` (strictly-greater survives).
  3. 3x3 dilation non-max suppression (plateau ties all survive), excluding
     the 1-pixel image border.
  4. Process candidates by descending response; keep one if no kept corner
     lies strictly within ``minDistance`` (Euclidean); stop at maxCorners.

``good_features_to_track_batch`` runs on (S, H, W) images, one ROI mask
each (the fleet's S crops); ``good_features_to_track`` is its S = 1 case.
The greedy selection is a Python loop of max+mask rounds into a fixed
(S, max_corners, 2) masked point buffer, as masked tensor ops on all S
images at once: one host read up front (the largest candidate count, which
bounds the rounds that can pick anything) and none per corner.  Ties inside
a round resolve to the smallest flat index (cv2's unstable sort leaves tie
order unspecified), written as ``min(where(score == best, flat_idx, h*w))``
because an argmax on the card does not promise the first maximum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.reference.pyramid import _reflect101_indices, _slice, _take


class CornerSet(NamedTuple):
    pts: torch.Tensor    # (max_corners, 2) float32, (x, y)
    valid: torch.Tensor  # (max_corners,) bool
    count: torch.Tensor  # int32


def _conv1d(x: torch.Tensor, axis: int, taps) -> torch.Tensor:
    """Small odd-length 1D stencil along ``axis`` with REFLECT_101 border."""
    r = len(taps) // 2
    n = x.shape[axis]
    xp = _take(x, _reflect101_indices(n, r), axis)
    acc = None
    for k, w in enumerate(taps):
        term = _slice(xp, axis, k, k + n) * w
        acc = term if acc is None else acc + term
    return acc


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Unnormalized box filter (cv2.boxFilter normalize=False), reflect-101."""
    ones = (1.0,) * size
    return _conv1d(_conv1d(x, x.ndim - 2, ones), x.ndim - 1, ones)


def min_eigenval_map(img: torch.Tensor, block_size: int = 7,
                     remap=None) -> torch.Tensor:
    """cv2.cornerMinEigenVal response map (unscaled) of an (H, W) image or
    of (S, H, W) images.

    ``remap=(rows, cols)`` (index maps of (H,) and (W,), or (S, H) and
    (S, W)) restricts each image's computation to a virtual subimage: the maps reflect out-of-ROI
    positions back inside (REFLECT_101 at the ROI edges).  cv2 pads per
    stage, the image for the Sobel pass AND the gradient maps for the box
    pass, so the remap is applied both to the image and to the gradients
    (reflecting only the image would bake sign-flipped x-gradients into the
    box sums at the right/left ROI edge).
    """
    def rmap(x):
        if remap is None:
            return x
        if x.ndim == 2:
            return x[remap[0]][:, remap[1]]
        sidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
        return x[sidx, remap[0][:, :, None], remap[1][:, None, :]]

    img = rmap(img)
    ix = _conv1d(_conv1d(img, img.ndim - 1, (-1.0, 0.0, 1.0)),
                 img.ndim - 2, (1.0, 2.0, 1.0))
    iy = _conv1d(_conv1d(img, img.ndim - 2, (-1.0, 0.0, 1.0)),
                 img.ndim - 1, (1.0, 2.0, 1.0))
    ix = rmap(ix)
    iy = rmap(iy)
    sxx = _box_sum(ix * ix, block_size)
    syy = _box_sum(iy * iy, block_size)
    sxy = _box_sum(ix * iy, block_size)
    a = 0.5 * sxx
    c = 0.5 * syy
    return (a + c) - torch.sqrt((a - c) * (a - c) + sxy * sxy)


def _reflect101_idx(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """BORDER_REFLECT_101 index map for offsets ``i`` into axes of length
    ``n`` (broadcast against ``i``).  The mod-period formula IS cv2's
    iterated reflection, so it is exact even when the stencil radius
    exceeds n; an axis of length <= 1 maps everything to 0."""
    n = torch.as_tensor(n, device=i.device)
    period = torch.clamp(2 * n - 2, min=1)
    m = i.abs() % period
    return torch.where(n <= 1, 0, torch.where(m < n, m, period - m))


def _dilate3(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float("-inf"))
    out = p[..., 0:h, 0:w]
    for i in range(3):
        for j in range(3):
            if i or j:
                out = torch.maximum(out, p[..., i:i + h, j:j + w])
    return out


def _mask_extent(roi_mask: torch.Tensor):
    """(dy, dx, rh, rw), each (S, 1), of (S, H, W) rectangular masks, on
    the device: the first row and column of each mask and its extent."""
    h, w = roi_mask.shape[-2:]
    row_any = roi_mask.any(dim=2)
    col_any = roi_mask.any(dim=1)
    rows = torch.arange(h, device=roi_mask.device)
    cols = torch.arange(w, device=roi_mask.device)
    dy = torch.where(row_any, rows, h).amin(dim=1, keepdim=True)
    dx = torch.where(col_any, cols, w).amin(dim=1, keepdim=True)
    return (dy, dx, row_any.sum(dim=1, keepdim=True),
            col_any.sum(dim=1, keepdim=True))


def good_features_to_track_batch(img: torch.Tensor, max_corners: int = 100,
                                 quality_level: float = 0.3,
                                 min_distance: float = 7.0,
                                 block_size: int = 7,
                                 roi_mask: Optional[torch.Tensor] = None
                                 ) -> CornerSet:
    """Masked fixed-size corner sets of (S, H, W) float images: pts
    (S, max_corners, 2), valid (S, max_corners), count (S,).

    ``roi_mask`` ((S, H, W), optional) restricts each image's detection to
    a rectangular ROI inside a bucketed window (``pipeline/motion`` crops a
    padded window and the real ROI may sit at an offset inside it).  cv2
    operates on the exact cropped subimage (base.py:365-366), so for parity
    the window's out-of-ROI pixels are remapped to the ROI's REFLECT_101
    virtual border before the response stencil, and the ROI's own 1-pixel
    border is excluded: each corner set equals
    ``cv2.goodFeaturesToTrack(frame[y:y+h, x:x+w], ...)`` shifted by the
    ROI offset.
    """
    s, h, w = img.shape
    dev = img.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    if roi_mask is not None:
        dy, dx, rh, rw = _mask_extent(roi_mask)
        rr = (_reflect101_idx(rows - dy, rh) + dy).clamp(0, h - 1)
        cc = (_reflect101_idx(cols - dx, rw) + dx).clamp(0, w - 1)
        eig = min_eigenval_map(img, block_size, remap=(rr, cc))
        eig = torch.where(roi_mask, eig, float("-inf"))
    else:
        dy = dx = torch.zeros((s, 1), dtype=torch.int64, device=dev)
        rh = torch.full((s, 1), h, device=dev)
        rw = torch.full((s, 1), w, device=dev)
        eig = min_eigenval_map(img, block_size)

    # cv2's border exclusion applies to the subimage extent.
    rows2 = rows[None, :, None]
    cols2 = cols[None, None, :]
    interior = ((rows2 >= dy[..., None] + 1)
                & (rows2 < (dy + rh - 1)[..., None])
                & (cols2 >= dx[..., None] + 1)
                & (cols2 < (dx + rw - 1)[..., None]))

    neg = float("-inf")
    maxval = torch.where(torch.isfinite(eig), eig, neg).amax(dim=(1, 2),
                                                             keepdim=True)
    thresh = quality_level * maxval
    cand = (eig > thresh) & (eig == _dilate3(eig)) & interior

    score = torch.where(cand, eig, neg).reshape(s, h * w)
    flat_idx = torch.arange(h * w, device=dev)
    frow = (flat_idx // w).to(eig.dtype)
    fcol = (flat_idx % w).to(eig.dtype)
    md2 = min_distance * min_distance
    # Each round picks at most one candidate per image, so no round after
    # the largest candidate count can pick anything.
    rounds = min(max_corners, int(cand.sum(dim=(1, 2)).max())) if s else 0
    picks = []
    for _ in range(rounds):
        best = score.amax(dim=1, keepdim=True)
        has = best > neg
        # Tie-break: smallest flat index among maxima.
        pick = torch.where((score == best) & has, flat_idx,
                           h * w).amin(dim=1, keepdim=True)
        py = (pick // w).to(eig.dtype)
        px = (pick % w).to(eig.dtype)
        # Suppress strictly-closer-than-min_distance candidates (cv2 uses
        # dx*dx + dy*dy < minDistance^2).
        d2 = (frow - py) ** 2 + (fcol - px) ** 2
        score = torch.where(has & (d2 < md2), neg, score)
        picks.append(torch.cat([torch.where(has, px, 0.0),
                                torch.where(has, py, 0.0),
                                has.to(eig.dtype)], dim=1))
    out = torch.zeros((s, max_corners, 3), dtype=torch.float32, device=dev)
    if picks:
        out[:, :rounds] = torch.stack(picks, dim=1).to(torch.float32)
    valid = out[..., 2] > 0
    return CornerSet(pts=out[..., :2].contiguous(), valid=valid,
                     count=valid.sum(dim=1).to(torch.int32))
