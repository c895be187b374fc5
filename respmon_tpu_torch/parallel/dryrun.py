"""A multi-rank dry run of the sharded paths on tiny shapes.

The port's counterpart of ``__graft_entry__.dryrun_multichip``: over
``n`` gloo ranks on the CPU, one stream-sharded fleet (calibrated on
camera-native uint8 buffers, in streaming-ROI mode, stepped twice: an
absorb and a localize with its drift check), one W-sharded pyrDown, one
W-sharded locate and one T-sharded locate whose T does not divide over
the ranks.

    python -m respmon_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.parallel import spatial, streams, temporal
from respmon_tpu_torch.parallel.launch import run_ranks
from respmon_tpu_torch.parallel.mesh import make_mesh

FPS = 10.0


def _clip(num_frames, height, width, seed, centre, size):
    return breathing_clip(num_frames=num_frames, height=height, width=width,
                          fps=FPS, bpm=20.0, patch_center=centre,
                          patch_size=size, amplitude=0.2, seed=seed)


def dryrun_rank(device: torch.device) -> dict:
    """One rank of ``dryrun_multichip``: what each sharded path returned,
    as shapes and the located boxes."""
    mesh = make_mesh(axis_names=("streams",), device=device)
    n = mesh.shape["streams"]
    cfg = MonitorConfig(
        calibration=CalibrationConfig(buffer_length=16, pyramid_levels=3,
                                      skip_levels_at_top=1),
        streaming_roi=True, streaming_interval=2)
    clips = np.stack([_clip(20, 24, 32, i, (12, 16), (8, 10))
                      for i in range(n)])
    clips_u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)
    fleet = streams.MultiStreamMonitor(cfg, mesh, (24, 32), FPS)
    loc = fleet.calibrate(clips_u8[:, :16])
    fleet.step(clips[:, 17])
    res = fleet.step(clips_u8[:, 18])
    assert tuple(loc.found.shape) == (n,)
    assert tuple(res.samples.shape) == (n,)

    mesh_sp = make_mesh(axis_names=("space",), device=device)
    w = 8 * n
    x = np.random.default_rng(0).random((16, w)).astype(np.float32)
    down = spatial.pyr_down_w_sharded(x, mesh_sp)
    assert tuple(down.shape) == (8, w // 2)
    cfg_w = CalibrationConfig(buffer_length=16, pyramid_levels=3,
                              skip_levels_at_top=1)
    loc_w = spatial.locate_wsharded(_clip(16, 32, w, 1, (16, w // 2),
                                          (10, 12)), mesh_sp, FPS, cfg_w)
    assert tuple(loc_w.heatmap_u8.shape) == (32, w)

    mesh_t = make_mesh(axis_names=("time",), device=device)
    t_total = 2 * n + 3
    cfg_t = CalibrationConfig(buffer_length=t_total, pyramid_levels=3,
                              skip_levels_at_top=1)
    loc_t = temporal.locate_tsharded(_clip(t_total, 24, 32, 0, (12, 16),
                                           (8, 10)), mesh_t, FPS, cfg_t)
    assert tuple(loc_t.heatmap_u8.shape) == (24, 32)
    return {"fleet_boxes": loc.boxes.tolist(),
            "fleet_samples": tuple(res.samples.shape),
            "pyr_down": tuple(down.shape),
            "wsharded_box": [int(v) for v in (loc_w.x, loc_w.y, loc_w.w,
                                              loc_w.h)],
            "tsharded_box": [int(v) for v in (loc_t.x, loc_t.y, loc_t.w,
                                              loc_t.h)]}


def dryrun_multichip(n_devices: int) -> list:
    """Run one sharded fleet step and the W- and T-sharded paths over
    ``n_devices`` gloo ranks on the CPU; returns each rank's summary (the
    same on every rank)."""
    results = run_ranks(dryrun_rank, n_devices, backend="gloo",
                        device="cpu")
    assert all(r == results[0] for r in results), results
    return results


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)[0])
