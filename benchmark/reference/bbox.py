# Frozen copy of respmon_tpu_torch/utils/bbox.py:1-23 at commit 17374d4 (the benchmark's plain reference; imports rewritten to this package).
# Copied from respmon_tpu/utils/bbox.py:1-22.
"""Bounding-box helpers (host-side, numpy)."""

from __future__ import annotations

import numpy as np


def reduce_bounding_box(x: int, y: int, w: int, h: int,
                        maximum_area: float):
    """Shrink a bbox about its center to at most ``maximum_area`` preserving
    aspect ratio (reference tools.py:48-57; default area inf = no-op via
    base.py:80)."""
    area = w * h
    if area <= maximum_area:
        return x, y, w, h
    scale = np.sqrt(float(maximum_area) / float(area))
    nw = w * scale
    nh = h * scale
    nx = x + (w - nw) / 2.0
    ny = y + (h - nh) / 2.0
    return (int(np.round(nx)), int(np.round(ny)),
            int(np.round(nw)), int(np.round(nh)))
