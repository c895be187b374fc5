# Port of respmon_tpu/ops/detect_peaks.py.
"""Alternative peak detector with the Marcos Duarte ``detect_peaks``
semantics (reference prototypes/detect_peaks.py, vendored there as an
unused alternative to peakutils).

Semantics reproduced:
  - NaN-adjacent candidates are discarded; NaN samples never peak.
  - A peak is a sample strictly greater than its left neighbor and
    >= / > its right neighbor depending on edge mode:
      edge=None: strict both sides;
      'rising' adds plateau left edges, 'falling' plateau right edges,
      'both' adds either.
  - First/last samples never peak.
  - ``mph``: minimum peak height; ``threshold``: minimum excess over both
    neighbors; ``mpd``: greedy min-distance keeping taller peaks first
    (ties: later index first); ``valley=True`` inverts the signal.

Fixed shapes and a fixed number of suppression rounds, as in the JAX
package: nothing is read back to the host, so the whole call queues on
the device without a synchronise.
"""

from __future__ import annotations

import torch


def detect_peaks(x: torch.Tensor, mph: float | None = None, mpd: int = 1,
                 threshold: float = 0.0, edge: str | None = "rising",
                 valley: bool = False, max_peaks: int = 64):
    """Returns (indices, mask): fixed-size ascending peak positions of the
    1-D ``x``, int32 padded with -1, and ``indices >= 0``."""
    n = x.shape[0]
    dev = x.device
    idx = torch.arange(n, device=dev)
    if valley:
        x = -x

    isnan = torch.isnan(x)
    xs = torch.where(isnan, torch.full_like(x, float("inf")), x)

    nan1 = torch.full((1,), float("nan"), dtype=xs.dtype, device=dev)
    diff = xs[1:] - xs[:-1]
    dx_r = torch.cat([diff, nan1])   # x[i+1]-x[i]
    dx_l = torch.cat([nan1, diff])   # x[i]-x[i-1]

    if edge is None:
        cand = (dx_l > 0) & (dx_r < 0)
    elif edge == "rising":
        cand = (dx_l > 0) & (dx_r <= 0)
    elif edge == "falling":
        cand = (dx_l >= 0) & (dx_r < 0)
    else:  # 'both'
        cand = ((dx_l > 0) & (dx_r <= 0)) | ((dx_l >= 0) & (dx_r < 0))

    # NaN samples and their neighbors never peak.
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    nan_adjacent = isnan | torch.cat([isnan[1:], no]) \
        | torch.cat([no, isnan[:-1]])
    cand = cand & ~nan_adjacent
    # First and last sample never peak.
    cand = cand & (idx > 0) & (idx < n - 1)

    if mph is not None:
        cand = cand & (x > mph)

    if threshold > 0:
        inf1 = torch.full((1,), float("inf"), dtype=xs.dtype, device=dev)
        left = torch.cat([inf1, xs[:-1]])
        right = torch.cat([xs[1:], inf1])
        excess = torch.minimum(x - left, x - right)
        cand = cand & (excess >= threshold)

    if mpd > 1:
        neg = torch.tensor(float("-inf"), dtype=x.dtype, device=dev)
        score = torch.where(cand, x, neg)
        kept = torch.zeros(n, dtype=torch.bool, device=dev)
        none = torch.full_like(idx, -1)
        for _ in range(min(max_peaks, n // (mpd + 1) + 1)):
            best = score.max()
            has = best > neg
            # Ties: later index wins (argsort-stable-reversed, like the
            # vendored implementation).
            pick = torch.where(score == best, idx, none).max()
            window = (idx - pick).abs() <= mpd
            score = torch.where(has & window, neg, score)
            kept = kept | (has & (idx == pick))
    else:
        kept = cand

    order = torch.cumsum(kept.to(torch.int64), dim=0) - 1
    slot = torch.where(kept, order, max_peaks).clamp(max=max_peaks)
    out = torch.full((max_peaks + 1,), -1, dtype=torch.int32, device=dev)
    out = out.scatter(0, slot, idx.to(torch.int32))[:max_peaks]
    return out, out >= 0
