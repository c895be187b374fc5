# Port of examples/temporal_analysis_demo.py.
"""Windowed-FFT BPM estimation on a fixed ROI (reference
prototypes/temporal_analysis.py analog: the approach the reference
abandoned for peak-to-peak intervals; here it works as a cross-check)."""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bpm", type=float, default=18.0)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.utils.diagnostics import (freq_from_fft,
                                                     pixel_sum_series)

    device = device_mod.resolve(args.device)
    fps = 10.0
    clip = breathing_clip(num_frames=args.frames, height=60, width=80,
                          fps=fps, bpm=args.bpm, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.2)
    # Fixed ROI over the patch:
    series = pixel_sum_series(torch.as_tensor(clip, device=device),
                              bounds=(30, 50, 22, 38))
    f = float(freq_from_fft(series - series.mean(), fps))
    print(f"dominant frequency: {f:.4f} Hz -> {f*60:.2f} BPM "
          f"(true {args.bpm})")


if __name__ == "__main__":
    main()
