"""BPM estimation — the reference's ``measure()`` on a batch of windows.

Port of ``respmon_tpu/pipeline/bpm.py`` (reference base.py:312-352):
Butterworth-lowpass filtfilt of each right-aligned ring, peakutils peak
detection, a Gaussian LM fit per candidate window (drop non-converged,
accept signed dev < cutoff), BPM = 60 / mean peak-to-peak interval when
>= 2 peaks survive.  The JAX function takes one (N,) ring and is
``vmap``-ped; this one takes a leading window axis, (B, N).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from respmon_tpu_torch.config import MeasureConfig
from respmon_tpu_torch.ops import filters, gaussfit, peaks
from respmon_tpu_torch.utils import bench


class BPMResult(NamedTuple):
    has_bpm: torch.Tensor      # (B,) bool — a new estimate was produced
    bpm: torch.Tensor          # (B,) float — valid iff has_bpm
    filtered: torch.Tensor     # (B, N) right-aligned filtered signal
    cand_idx: torch.Tensor     # (B, max_peaks) candidate buffer indices
    cand_mask: torch.Tensor    # (B, max_peaks) candidates validity
    accept_mask: torch.Tensor  # (B, max_peaks) accepted after the fit
    peak_count: torch.Tensor   # (B,) int32 accepted peaks


def _compact(values: torch.Tensor, keep: torch.Tensor, size: int,
             fill) -> torch.Tensor:
    """Kept ``values`` in ascending order into (B, size); the rest land in
    an extra dump slot that is sliced off."""
    order = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    slot = torch.where(keep, order, size).clamp(max=size)
    out = torch.full(values.shape[:-1] + (size + 1,), fill,
                     dtype=values.dtype, device=values.device)
    return out.scatter_(-1, slot, values)[..., :size]


def estimate_bpm(data: torch.Tensor, t: torch.Tensor, count: torch.Tensor,
                 coeffs: filters.FilterCoeffs, min_dist: int,
                 cfg: MeasureConfig) -> BPMResult:
    """``measure()`` on right-aligned (B, N) rings with ``count`` (B,) valid
    samples each.  ``coeffs`` is the lowpass at freq_max*0.5 of order
    cfg.filter_order; ``min_dist`` = floor(fps / freq_max)."""
    n = data.shape[-1]
    dev = data.device
    width = max(min_dist, 1)
    max_peaks = cfg.max_peaks
    count = torch.as_tensor(count, device=dev)

    with bench.span("bpm.filter"):
        filtered = filters.filtfilt_masked(coeffs, data, count)
    with bench.span("bpm.peaks"):
        cand_idx, cand_mask = peaks.peak_indexes_masked(
            filtered, count, min_dist, thres=cfg.peak_threshold,
            max_peaks=max_peaks)

    start = (n - count)[..., None]
    # Reference window clamping (base.py:319-323), including the quirk that
    # the right clamp tests the already-reduced w.
    i_loc = cand_idx - start
    w1 = torch.where(i_loc - width < 0, i_loc, width)
    w2 = torch.where(i_loc + w1 > count[..., None], count[..., None] - i_loc,
                     w1)

    # Only the first fit_lanes candidate slots can be occupied: at spacing
    # min_dist+1 at most n//(min_dist+1)+1 peaks survive suppression.
    fit_lanes = min(max_peaks, n // (min_dist + 1) + 1) if min_dist > 1 \
        else max_peaks
    offs = torch.arange(2 * width, device=dev)
    gidx = (cand_idx - w2)[..., :fit_lanes, None] + offs
    gclip = gidx.clamp(0, n - 1)
    batch = data.shape[:-1]
    flat = gclip.reshape(batch + (-1,))
    vt = torch.gather(t, -1, flat).reshape(gclip.shape)
    vy = torch.gather(filtered, -1, flat).reshape(gclip.shape)
    vm = cand_mask[..., :fit_lanes, None] \
        & (offs < 2 * w2[..., :fit_lanes, None]) & (gidx >= 0) & (gidx < n)

    fit = gaussfit.gaussian_fit_batch(vt, vy, vm)
    acc_lane = fit.converged & (fit.dev < cfg.gaussian_cutoff)

    if cfg.f64_refine:
        # Wild converged f32 fits (center > 2 window spans outside, or
        # |ampl| > 5x the data) re-fit in f64 at MINPACK tolerances; the
        # H100 runs f64 natively.  Other lanes are masked out and start
        # done, so the refit costs nothing when no lane is suspect.
        t_lo = torch.where(vm, vt, torch.inf).amin(dim=-1)
        t_hi = torch.where(vm, vt, -torch.inf).amax(dim=-1)
        span = torch.clamp(t_hi - t_lo, min=1e-9)
        dist = torch.clamp(torch.maximum(t_lo - fit.center,
                                         fit.center - t_hi), min=0.0) / span
        ymax = torch.where(vm, vy.abs(), 0.0).amax(dim=-1)
        ar = fit.ampl.abs() / torch.clamp(ymax, min=1e-12)
        suspect = fit.converged & ((dist > 2.0) | (ar > 5.0))
        f64 = torch.float64
        fit64 = gaussfit.gaussian_fit_batch(
            vt.to(f64), vy.to(f64), vm & suspect[..., None], iters=500)
        acc64 = fit64.converged & (fit64.dev < cfg.gaussian_cutoff)
        acc_lane = torch.where(suspect, acc64, acc_lane)

    pad = torch.zeros(batch + (max_peaks - fit_lanes,), dtype=torch.bool,
                      device=dev)
    accept = cand_mask & torch.cat([acc_lane, pad], dim=-1)

    times = torch.gather(t, -1, cand_idx.clamp(0, n - 1).to(torch.int64))
    compact = _compact(times, accept, max_peaks, 0.0)
    k = accept.sum(dim=-1)

    pair_mask = torch.arange(max_peaks - 1, device=dev) < (k - 1)[..., None]
    diffs = compact[..., 1:] - compact[..., :-1]
    interval = torch.where(pair_mask, diffs, 0.0).sum(dim=-1) / \
        torch.clamp(pair_mask.sum(dim=-1), min=1)
    has_bpm = k >= 2
    bpm = 60.0 / torch.where(interval != 0, interval, 1.0)
    return BPMResult(has_bpm=has_bpm, bpm=bpm, filtered=filtered,
                     cand_idx=cand_idx, cand_mask=cand_mask,
                     accept_mask=accept, peak_count=k.to(torch.int32))
