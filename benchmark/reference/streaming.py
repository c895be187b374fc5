"""The plain reference of the fleet's streaming-ROI mode: the coarse
localize of one stream, computed afresh from its last ``buffer_length``
frames (not from the program's rings), the host's re-lock rule, and the
re-lock of a flow state.

Built from the frozen copies beside this file, so it imports nothing of
the program.  ``localize`` takes ``tf32``: True runs its matrix products in
TF32, the control that has to come out as not correct.  The pieces copied
here from the program carry their source and lines.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import ccl
from benchmark.reference.config import CalibrationConfig
from benchmark.reference.fft_bandpass import temporal_bandpass_fft
from benchmark.reference.pyramid import (gaussian_pyramid, pyr_up,
                                         pyramid_shapes)
from benchmark.reference.system import (FlowSpec, FlowState, _suppress_top,
                                        _tmean, float_to_uint8, precision,
                                        uint8_to_float)


# Copied from respmon_tpu_torch/pipeline/evm.py:133-144 (_collapse, with
# its ``stop``).
def _collapse(band: Dict[int, torch.Tensor], shapes, t_len: int,
              like: torch.Tensor, stop: int) -> torch.Tensor:
    last = len(shapes) - 2
    img = torch.zeros((t_len,) + tuple(shapes[last + 1]), dtype=like.dtype,
                      device=like.device)
    for lvl in range(last, stop - 1, -1):
        img = pyr_up(img, shapes[lvl])
        if lvl in band:
            img = img + band[lvl]
    return img


def localize(frames_u8: torch.Tensor, fps: float, cal: CalibrationConfig,
             tf32: bool = False):
    """((found, x, y, w, h), heatmap) of the coarse localize of one stream
    whose last ``buffer_length`` frames are the (T, H, W) uint8
    ``frames_u8``: the plain pyramid's kept Laplacian levels, the
    packed-rfft bandpass, the collapse stopped at level
    ``skip_levels_at_top``, suppress-top, the pairwise T-mean, the uint8
    heatmap at that level, the threshold and the largest 8-connected
    region, its box scaled by ``2 ** skip_levels_at_top`` and clipped to
    the frame (respmon_tpu_torch/pipeline/streaming.py:141-189, one stream
    of ``localize_batch`` with ``coarse=True``)."""
    with precision(tf32):
        vid = uint8_to_float(frames_u8)
        t_len, h0, w0 = vid.shape
        levels, stop = cal.pyramid_levels, cal.skip_levels_at_top
        shapes = pyramid_shapes(h0, w0, levels)
        gauss = gaussian_pyramid(vid, levels)
        band = {}
        for lvl in range(stop, levels - 1):
            lap = gauss[lvl] - pyr_up(gauss[lvl + 1],
                                      tuple(gauss[lvl].shape[-2:]))
            band[lvl] = temporal_bandpass_fft(lap, fps, cal.freq_min,
                                              cal.freq_max,
                                              cal.amplification)
        del gauss
        img = _collapse(band, shapes, t_len, vid, stop)
        del band
        avg = _tmean(_suppress_top(img, cal))
        heat = float_to_uint8((avg - avg.min()) / (avg.max() - avg.min()))
        fg = heat.to(torch.int32) > int(round(cal.threshold * 255.0))
        box = ccl.largest_component_bbox(fg)
        found, x, y, w, h = (int(v) for v in torch.stack(
            [box.found.to(torch.int32), box.x, box.y, box.w, box.h]).cpu())
    k = 1 << stop
    x, y = x * k, y * k
    return (bool(found), x, y, min(w * k, w0 - x), min(h * k, h0 - y)), heat


# Copied from respmon_tpu_torch/parallel/streams.py:662-682
# (MultiStreamMonitor._maybe_relock, its host rule).
def relock_rule(boxes: np.ndarray, rois: np.ndarray, drift_px: float,
                frame_hw):
    """(apply, new ROIs) of the re-lock decision on a localize's (5, S)
    ``boxes`` (found, x, y, w, h) against the (S, 4) ``rois`` (x, y, w, h)
    before it: a found stream whose box centre lies ``drift_px`` or more
    from its ROI's centre moves its window, at its size, onto that centre,
    clipped to the frame; streams whose window would not move stay.
    ``new ROIs`` holds every stream's ROI after the localize."""
    found, bx, by, bw, bh = np.asarray(boxes, np.int64)
    found = found.astype(bool)
    cur = np.asarray(rois, np.int64)
    cx = bx + bw / 2.0
    cy = by + bh / 2.0
    drift = np.hypot(cx - (cur[:, 0] + cur[:, 2] / 2.0),
                     cy - (cur[:, 1] + cur[:, 3] / 2.0))
    apply = found & (drift >= drift_px)
    h_f, w_f = frame_hw
    w, h = cur[:, 2], cur[:, 3]
    x2 = np.clip(np.round(cx - w / 2.0), 0, w_f - w).astype(np.int64)
    y2 = np.clip(np.round(cy - h / 2.0), 0, h_f - h).astype(np.int64)
    apply &= (x2 != cur[:, 0]) | (y2 != cur[:, 1])
    new = cur.copy()
    new[apply, 0] = x2[apply]
    new[apply, 1] = y2[apply]
    return apply, new


# Copied from respmon_tpu_torch/pipeline/motion.py:491-513
# (relock_state_batch, the fields a flow step reads) and
# respmon_tpu_torch/parallel/streams.py:235-245 (relock_streams' mask).
def relock(state: FlowState, new_rois: torch.Tensor, apply: torch.Tensor,
           spec: FlowSpec) -> FlowState:
    """The flow state of S streams after a masked re-lock: where ``apply``
    holds, the ROI moves to its row of ``new_rois`` and the tracked points
    move with the window (points that leave it are dropped, and a stream
    left with none is no longer initialized); the motion ring stays."""
    def starts(roi):
        return (roi[:, 1].clamp(0, spec.frame_h - spec.crop_h),
                roi[:, 0].clamp(0, spec.frame_w - spec.crop_w))
    new_rois = new_rois.to(state.roi.dtype)
    sy_old, sx_old = starts(state.roi)
    sy_new, sx_new = starts(new_rois)
    shift = torch.stack([sx_old - sx_new, sy_old - sy_new],
                        dim=-1).to(state.pts.dtype)
    pts = state.pts + shift[:, None, :]
    inb = ((pts[..., 0] >= 0) & (pts[..., 0] <= spec.crop_w - 1)
           & (pts[..., 1] >= 0) & (pts[..., 1] <= spec.crop_h - 1))
    valid = state.pts_valid & inb
    moved = state._replace(
        roi=new_rois, pts=pts, pts_valid=valid,
        initialized=state.initialized & (valid.sum(dim=1) > 0))

    def pick(a, b):
        return torch.where(apply.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    return FlowState(*(pick(a, b) for a, b in zip(moved, state)))
