"""The port's counterpart of ``__graft_entry__.py``: the flagship
calibration as a ``(fn, example_args)`` pair, and the multi-rank dry run.

    from respmon_tpu_torch.entry import entry
    fn, args = entry()            # on cuda:0; entry("cpu") off the card
    found, x, y, w, h, heatmap_u8 = fn(*args)

On a CUDA tensor ``fn``'s ``locate`` builds the Laplacian levels with the
stencil pyramid kernels (``ops/pyramid_cuda``), as every ``locate`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.parallel.dryrun import dryrun_multichip
from respmon_tpu_torch.pipeline import evm

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """The fused EVM calibration (Laplacian video pyramid -> packed-rfft
    bandpass -> collapse -> suppress-top -> heatmap -> threshold -> CCL
    bbox) of a 64-frame 120x160 buffer.

    Returns ``(fn, example_args)``: ``fn(buffer)`` gives ``(found, x, y, w,
    h, heatmap_u8)``, and ``example_args`` holds the synthetic breathing
    clip as a float32 tensor on ``device`` (``None``: the card, see
    ``device.resolve``)."""
    device = device_mod.resolve(device)
    cfg = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    fps = 10.0

    def fn(buffer):
        res = evm.locate(buffer, fps, cfg)
        return (res.found, res.x, res.y, res.w, res.h, res.heatmap_u8)

    clip = breathing_clip(num_frames=64, height=120, width=160, fps=fps,
                          bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    return fn, (torch.from_numpy(np.asarray(clip, np.float32)).to(device),)
