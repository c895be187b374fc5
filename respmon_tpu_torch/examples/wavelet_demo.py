# Port of examples/wavelet_demo.py.
"""db4 wavelet decomposition / smoothing (reference prototypes/wavelets.py +
transforms.py:121-141 analog), on the torch implementation."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import wavelets

    device = device_mod.resolve(args.device)
    t, y = motion_trace(num_samples=256, fps=10.0, bpm=18.0, noise=0.3)
    # float32, the JAX demo's dtype (it runs without x64).
    y_dev = torch.tensor(y, dtype=torch.float32, device=device)
    ca, cd = wavelets.wavelet_decompose(y_dev, args.iterations)
    for lvl, (a, d) in enumerate(zip(ca, cd)):
        print(f"level {lvl + 1}: approx len {a.shape[0]} "
              f"(energy {float((a ** 2).sum()):.1f}), detail len "
              f"{d.shape[0]} (energy {float((d ** 2).sum()):.2f})")
    sm = wavelets.wavelet_filter(y_dev, iterations=args.iterations)
    sm = sm.cpu().numpy()
    print(f"smoothed: corr with noisy input "
          f"{np.corrcoef(sm, y)[0, 1]:.3f}")

    if args.plot:
        import matplotlib.pyplot as plt

        plt.plot(t, y, alpha=0.4, label="raw")
        plt.plot(t, sm, label="db4 smoothed")
        plt.legend()
        plt.show()


if __name__ == "__main__":
    main()
