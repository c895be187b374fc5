"""Hold the sharded paths on several NCCL ranks, one card a rank, against
the unsharded ones on each rank's own card.

    python3 tools/sharded_nccl_check.py [--ranks N]

``chip_smoke.py`` runs the sharded paths in a one-rank group, which sends
nothing between ranks; this runs them over ``N`` ranks (default: every
card of the host), so the halo exchange, the reduce-scatter and the
gathers cross NVLink.  On the 640x480 u8 fixture of ``chip_smoke.py`` (18
BPM, 128 calibration frames) every rank checks:

- ``locate_wsharded`` equals ``evm.locate`` bit for bit;
- ``locate_tsharded`` has its bbox and ``thresh > 0`` and a heatmap
  within 1;
- a 4-stream flow fleet sharded over the ranks (full signal rings
  installed, 3 steps, a BPM among them) gives the unsharded fleet's
  samples, BPMs, has_bpm and errors bit for bit, with one gather a step.

Prints the cards' name and power limit (``nvidia-smi``), then one JSON
line per rank (the checks, the collectives, the times on the host clock;
one call each, no warm-up beyond one untimed call) and exits 1 unless
every check held on every rank.  ``--backend gloo
--device cpu --size 120x160`` rehearses it on the CPU.  Times here are not
a scaling measurement: the paths are small for N cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FPS = 10.0
STREAMS = 4
STEPS = 3


def _clips(h, w, n_frames, seed0=0):
    import numpy as np

    from respmon_tpu_torch.io.synthetic import breathing_clip

    out = [breathing_clip(num_frames=n_frames, height=h, width=w, fps=FPS,
                          bpm=18.0 + 3 * i, patch_center=(h // 2, w // 2),
                          patch_size=(h // 6, w // 6), amplitude=0.12,
                          motion_px=2.0, texture_motion=True, seed=seed0 + i)
           for i in range(STREAMS)]
    return np.clip(np.round(np.stack(out) * 255.0), 0, 255).astype(np.uint8)


def _timed(fn):
    import torch

    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_rank(device, size):
    """One rank: the three checks above; returns what it found."""
    import dataclasses

    import numpy as np
    import torch

    import respmon_tpu_torch  # noqa: F401  (the precision policy)
    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import spatial, streams, temporal
    from respmon_tpu_torch.parallel.mesh import make_mesh
    from respmon_tpu_torch.pipeline import evm

    h, w = size
    cfg = MonitorConfig(motion_extraction_method="flow")
    if h < 480:
        cfg = dataclasses.replace(cfg, calibration=dataclasses.replace(
            cfg.calibration, buffer_length=64, pyramid_levels=6,
            skip_levels_at_top=2))
    cal = cfg.calibration
    t_len = cal.buffer_length
    clips = _clips(h, w, 1 + t_len + 1 + STEPS)
    buf = torch.from_numpy(clips[0, 1:t_len + 1]).to(device)
    out = {}
    want, out["locate_s"] = _timed(lambda: evm.locate(buf, FPS, cal))

    mesh_w = make_mesh(axis_names=("space",), device=device)
    got, out["wsharded_s"] = _timed(
        lambda: spatial.locate_wsharded(buf, mesh_w, FPS, cal))
    out["wsharded_bit_equal"] = all(torch.equal(a, b)
                                    for a, b in zip(got, want))
    mesh_t = make_mesh(axis_names=("time",), device=device)
    got, out["tsharded_s"] = _timed(
        lambda: temporal.locate_tsharded(buf, mesh_t, FPS, cal))
    gap = int((got.heatmap_u8.int() - want.heatmap_u8.int()).abs().max())
    box = [int(v) for v in (got.x, got.y, got.w, got.h)]
    out["tsharded_ok"] = (box == [int(v) for v in (want.x, want.y, want.w,
                                                   want.h)]
                          and gap <= 1
                          and torch.equal(got.thresh > 0, want.thresh > 0))
    out["tsharded_heatmap_gap"] = gap

    mesh_s = make_mesh(axis_names=("streams",), device=device)
    rows = {}
    for name, mesh in (("unsharded", None), ("sharded", mesh_s)):
        fleet = streams.MultiStreamMonitor(cfg, mesh, (h, w), FPS,
                                           device=device)
        fleet.calibrate(clips[:, 1:t_len + 1])
        # Full signal rings, as chip_smoke.py's _full_rings installs them.
        n = cfg.measure.buffer_length
        rng = np.random.default_rng(0)
        t = np.arange(n, dtype=np.float32) / FPS
        phases = rng.uniform(0, 2 * np.pi, STREAMS).astype(np.float32)
        ring = (0.15 * np.sin(2 * np.pi * 0.3 * t[None, :]
                              + phases[:, None])
                + 0.01 * rng.standard_normal((STREAMS, n)).astype(
                    np.float32))
        full = (ring.astype(np.float32), np.broadcast_to(t, (STREAMS, n)),
                np.full(STREAMS, n, np.int32))
        full = streams.shard_streams(full, mesh) if mesh else tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in full)
        fleet.states = fleet.states._replace(
            data=full[0], t=full[1], count=full[2], motion_count=full[2])
        mesh_s.collectives.clear()
        t0 = time.perf_counter()
        res = [fleet.step(clips[:, t_len + 2 + k]) for k in range(STEPS)]
        rows[name] = torch.stack([torch.stack(
            [r.samples.double(), r.bpm.double(), r.has_bpm.double(),
             r.error.double()]) for r in res]).cpu().numpy()
        out[f"{name}_fleet_s"] = time.perf_counter() - t0
    out["fleet_bit_equal"] = bool(np.array_equal(
        rows["sharded"], rows["unsharded"], equal_nan=True))
    out["fleet_has_bpm"] = bool((rows["sharded"][:, 2] > 0).any())
    out["fleet_collectives"] = dict(mesh_s.collectives)
    out["collectives"] = {"space": dict(mesh_w.collectives),
                          "time": dict(mesh_t.collectives)}
    out["ok"] = (out["wsharded_bit_equal"] and out["tsharded_ok"]
                 and out["fleet_bit_equal"] and out["fleet_has_bpm"]
                 and out["fleet_collectives"] == {"all_gather": STEPS})
    return out


def main() -> int:
    import torch

    from respmon_tpu_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="480x640", help="HxW of the frames")
    args = ap.parse_args()
    n = args.ranks or torch.cuda.device_count()
    size = tuple(int(v) for v in args.size.split("x"))
    if args.device == "cuda":
        # The cards' name and power limit, as chip_smoke.py prints them.
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    results = run_ranks(check_rank, n, args.backend, args.device,
                        args=(size,))
    for rank, out in enumerate(results):
        print(json.dumps({"rank": rank, "ranks": n, **out}), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
