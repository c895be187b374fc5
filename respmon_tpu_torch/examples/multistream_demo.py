# Port of examples/multistream_demo.py.
"""Multi-kennel fleet monitoring on one card, or a mesh of ranks
(BASELINE.md config 5).

Runs S synthetic streams with different breathing rates through the
MultiStreamMonitor and prints per-stream BPMs.  Each stream's calibration
runs the pyramid kernel K1 on the card.  When this process is one rank of
an initialised ``torch.distributed`` group whose world size divides S, the
stream axis shards over the ranks (one results gather a step).

``--feeder`` runs the full production ingestion loop instead of indexing
a staged array: S capture sources -> FleetFeeder (per-stream C++ rings,
camera-native u8, one assembled (S, H, W) batch per lockstep tick) ->
MultiStreamMonitor.step."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--feeder", action="store_true",
                    help="ingest via FleetFeeder (u8 rings) instead of a "
                         "staged array")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, or with a "
                         "mesh the rank's card)")
    args = ap.parse_args()

    import torch.distributed as dist

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.parallel.mesh import make_mesh
    from respmon_tpu_torch.parallel.streams import MultiStreamMonitor

    fps = 10.0
    s = args.streams
    ndev = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1
    mesh = make_mesh(axis_sizes=(ndev,), axis_names=("streams",),
                     device=args.device) \
        if ndev > 1 and s % ndev == 0 else None
    device = mesh.device if mesh else device_mod.resolve(args.device)
    print(f"devices: {ndev}, mesh: {'sharded' if mesh else 'single'}")

    cfg = MonitorConfig(calibration=CalibrationConfig(
        buffer_length=64, pyramid_levels=4, skip_levels_at_top=1))
    # NB: short demo buffers narrow the packed-rfft passband (same math as
    # the reference); 64 frames localizes 12-24 BPM reliably, the production
    # 128-frame buffer covers the full 6-60 BPM band.
    bpms = [12.0 + 3.0 * (i % 5) for i in range(s)]
    clips = np.stack([
        breathing_clip(num_frames=args.frames, height=60, width=80, fps=fps,
                       bpm=bpms[i], patch_center=(30, 40),
                       patch_size=(16, 20), amplitude=0.25, noise=0.002,
                       seed=i)
        for i in range(s)])

    mon = MultiStreamMonitor(cfg, mesh, (60, 80), fps, device=device)
    cal_len = cfg.calibration.buffer_length
    # Camera-native u8 end to end: calibrate and step on bytes.
    clips_u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)
    loc = mon.calibrate(clips_u8[:, :cal_len])
    print("calibrated:", loc.found.cpu().numpy().tolist())

    last = np.full(s, np.nan)
    if args.feeder:
        from respmon_tpu_torch.io.capture import ArrayCapture
        from respmon_tpu_torch.runtime.fleet_feeder import FleetFeeder

        fleet = FleetFeeder(
            [ArrayCapture(c[cal_len + 1:], fps=fps) for c in clips_u8],
            capacity=4, lossless=True, dtype=np.uint8).start()
        ticks = 0
        while True:
            b = fleet.next_batch(timeout=10.0)
            if b is None:
                break
            res = mon.step(b.frames)
            ticks += 1
            has = res.has_bpm.cpu().numpy()
            last[has] = res.bpm.cpu().numpy()[has]
        fleet.stop()
        print(f"feeder lockstep ticks: {ticks}, per-stream dropped: "
              f"{fleet.dropped.tolist()}")
    else:
        for f in range(cal_len + 1, args.frames):
            res = mon.step(clips_u8[:, f])
            has = res.has_bpm.cpu().numpy()
            last[has] = res.bpm.cpu().numpy()[has]

    for i in range(s):
        print(f"stream {i}: true {bpms[i]:5.1f} BPM -> measured "
              f"{last[i]:5.1f}")


if __name__ == "__main__":
    main()
