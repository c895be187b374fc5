"""Min-distance peak detection with peakutils.indexes semantics, batched
over rows of right-aligned masked signals.

Port of ``respmon_tpu/ops/peaks.py`` (reference base.py:314): relative
threshold, plateau filling of the first differences, candidates where the
difference turns from + to -, then greedy suppression by descending height
with ties broken toward the higher index (peakutils reverses a stable
ascending argsort).  The greedy loop runs a fixed number of steps with no
host synchronisation.
"""

from __future__ import annotations

import torch


def _fill_plateaus(dy: torch.Tensor) -> torch.Tensor:
    """Replace zero-runs of ``dy`` (..., M) with neighbouring nonzero values
    (left half <- left value, right half <- right value, the median index
    goes right; edge plateaus use the available side)."""
    m = dy.shape[-1]
    idx = torch.arange(m, device=dy.device)
    nz = dy != 0
    # Last nonzero at or before i, first nonzero at or after i.
    lpos = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    rpos = torch.flip(torch.cummin(torch.flip(torch.where(nz, idx, m), [-1]),
                                   dim=-1).values, [-1])
    lval = torch.where(lpos >= 0,
                       torch.gather(dy, -1, lpos.clamp(min=0)), 0.0)
    rval = torch.where(rpos < m,
                       torch.gather(dy, -1, rpos.clamp(max=m - 1)), 0.0)
    left_edge = lpos < 0
    right_edge = rpos >= m
    median = (lpos + 1 + rpos - 1) / 2.0
    use_right = (idx >= median) | left_edge
    fill = torch.where(use_right & ~right_edge, rval, lval)
    return torch.where(nz, dy, fill)


def peak_indexes_masked(y: torch.Tensor, count: torch.Tensor, min_dist: int,
                        thres: float = 0.3, max_peaks: int = 32):
    """peakutils.indexes on right-aligned masked rows.

    Args:
      y: (..., N) buffer; row r valid at [N-count[r], N).
      count: (...,) valid samples per row.
      min_dist: minimum peak distance (samples).
      thres: relative threshold (peakutils default 0.3).
      max_peaks: cap on returned peaks.

    Returns:
      (indices, mask): (..., max_peaks) int32 buffer indices in ascending
      order (-1 past the last) and their validity mask.
    """
    n = y.shape[-1]
    dev = y.device
    idx = torch.arange(n, device=dev)
    count = torch.as_tensor(count, device=dev)
    start = (n - count)[..., None]
    valid = idx >= start

    ymax = torch.where(valid, y, -torch.inf).amax(dim=-1, keepdim=True)
    ymin = torch.where(valid, y, torch.inf).amin(dim=-1, keepdim=True)
    threshold = thres * (ymax - ymin) + ymin

    # The invalid prefix repeats the first valid sample, so its dy is zero
    # and peakutils' left-edge plateau rule treats it as absent.
    y_first = torch.gather(y, -1, start.clamp(max=n - 1))
    y_ext = torch.where(valid, y, y_first)

    dy = torch.diff(y_ext, dim=-1)
    flat = torch.where(idx[:-1] >= start, dy == 0, True).all(dim=-1,
                                                            keepdim=True)
    dy = _fill_plateaus(dy)

    zero = torch.zeros_like(dy[..., :1])
    dy_l = torch.cat([zero, dy], dim=-1)     # dy[i-1]
    dy_r = torch.cat([dy, zero], dim=-1)     # dy[i]
    cand = (dy_l > 0) & (dy_r < 0) & (y_ext > threshold) & valid & ~flat

    if min_dist > 1:
        score = torch.where(cand, y_ext, -torch.inf)
        kept = torch.zeros_like(cand)
        for _ in range(min(max_peaks, n // (min_dist + 1) + 1)):
            best = score.amax(dim=-1, keepdim=True)
            pick = torch.where(score == best, idx, -1).amax(dim=-1,
                                                          keepdim=True)
            has = best > -torch.inf
            window = (idx - pick).abs() <= min_dist
            score = torch.where(has & window, -torch.inf, score)
            kept = kept | (has & (idx == pick))
        num_cand = cand.sum(dim=-1, keepdim=True)
        kept = torch.where(num_cand <= 1, cand, kept)
    else:
        kept = cand

    # Compact kept indices (ascending) into (..., max_peaks); the extra
    # slot max_peaks is the dump for everything else and is sliced off.
    order = torch.cumsum(kept.to(torch.int64), dim=-1) - 1
    slot = torch.where(kept, order, max_peaks).clamp(max=max_peaks)
    out = torch.full(y.shape[:-1] + (max_peaks + 1,), -1, dtype=torch.int32,
                     device=dev)
    out.scatter_(-1, slot, idx.to(torch.int32).expand(y.shape[:-1] + (n,)))
    indices = out[..., :max_peaks]
    return indices, indices >= 0


def peak_indexes(y: torch.Tensor, min_dist: int, thres: float = 0.3,
                 max_peaks: int = 32):
    """peakutils.indexes of a full (N,) signal, or of each row of a
    (..., N) one: ``peak_indexes_masked`` with every sample valid."""
    count = torch.full(y.shape[:-1], y.shape[-1], device=y.device)
    return peak_indexes_masked(y, count, min_dist, thres=thres,
                               max_peaks=max_peaks)
