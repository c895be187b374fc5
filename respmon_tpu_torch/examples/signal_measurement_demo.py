# Port of examples/signal_measurement_demo.py.
"""Offline peak/BPM pipeline on a recorded motion trace (reference
prototypes/signal_measurement.py analog): loads a ``<target>.npy`` written
by the monitor's session recorder and re-runs the estimation stage."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", nargs="?",
                    help="(t, motion) .npy from a session "
                         "(default: synthetic 18 BPM)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.config import MeasureConfig
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import filters
    from respmon_tpu_torch.pipeline import bpm as bpm_mod

    device = device_mod.resolve(args.device)
    if args.trace:
        data = np.load(args.trace)
        t, y = data[:, 0], data[:, 1]
        fps = args.fps
    else:
        fps = args.fps
        t, y = motion_trace(num_samples=128, fps=fps, bpm=18.0)

    n = 128
    count = min(len(y), n)
    yp = np.zeros(n)
    tp = np.zeros(n)
    yp[n - count:] = y[-count:]
    tp[n - count:] = t[-count:]

    cfg = MeasureConfig()
    coeffs = filters.design_butter_lowpass(0.5, fps, cfg.filter_order)
    # One (1, N) ring in float32, the JAX demo's dtype (it runs without
    # x64, so its jnp.asarray of the float64 ring is float32).
    res = bpm_mod.estimate_bpm(
        torch.tensor(yp[None], dtype=torch.float32, device=device),
        torch.tensor(tp[None], dtype=torch.float32, device=device),
        torch.tensor([count], device=device), coeffs, int(np.floor(fps)), cfg)
    print(f"samples: {count}")
    print(f"accepted peaks: {int(res.peak_count[0])}")
    print(f"BPM: {float(res.bpm[0]) if bool(res.has_bpm[0]) else None}")

    if args.plot:
        import matplotlib.pyplot as plt

        filtered = res.filtered[0].cpu().numpy()
        plt.plot(tp[n - count:], yp[n - count:], label="raw")
        plt.plot(tp[n - count:], filtered[n - count:], label="filtered")
        acc = res.accept_mask[0].cpu().numpy()
        idxs = res.cand_idx[0].cpu().numpy()[acc]
        plt.scatter(tp[idxs], filtered[idxs], c="r", label="peaks")
        plt.legend()
        plt.show()


if __name__ == "__main__":
    main()
