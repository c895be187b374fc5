# Port of examples/locating_demo.py.
"""EVM ROI localization demo (reference prototypes/locating.py analog):
runs the batch localizer and the streaming sliding-window calibrator on the
same clip and prints both trajectories.  On the card both run the pyramid
kernel K1: the batch locate on the 32-frame buffer, the streaming
calibrator at T = 1 on every frame."""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.config import CalibrationConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import evm, streaming

    device = device_mod.resolve(args.device)
    fps = 10.0
    cfg = CalibrationConfig(buffer_length=32, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=args.frames, height=60, width=80,
                          fps=fps, bpm=18.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25, noise=0.002)
    frames = torch.as_tensor(clip, device=device)

    batch = evm.locate(frames[:cfg.buffer_length], fps, cfg)
    print(f"batch locate:     found={bool(batch.found)} "
          f"bbox=({int(batch.x)},{int(batch.y)},{int(batch.w)},"
          f"{int(batch.h)})")

    state = streaming.init_streaming_state(60, 80, cfg, device=device)
    for i in range(args.frames):
        state, res = streaming.streaming_update(state, frames[i], fps, cfg)
        if bool(res.found):
            print(f"streaming frame {i:3d}: bbox=({int(res.x)},{int(res.y)},"
                  f"{int(res.w)},{int(res.h)})")

    if args.plot:
        import matplotlib.pyplot as plt

        plt.imshow(res.heatmap_u8.cpu().numpy(), cmap="inferno")
        plt.title("streaming EVM heatmap")
        plt.show()


if __name__ == "__main__":
    main()
