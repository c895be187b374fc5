# Port of examples/gaussian_explorer.py.
"""Gaussian-fit acceptance landscape (reference prototypes/lif.py analog).

The reference tuned ``gaussian_cutoff`` with an interactive slider explorer;
this headless version sweeps peak shapes (width x noise) and reports which
are accepted by the production Gaussian filter (converged AND dev < cutoff),
showing where the 10.0 default sits."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cutoff", type=float, default=10.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.ops import gaussfit

    device = device_mod.resolve(args.device)
    fps = args.fps
    widths = [0.1, 0.2, 0.4, 0.8, 1.6, 3.2]
    noises = [0.0, 0.05, 0.15, 0.4]
    rng = np.random.default_rng(0)

    t = np.arange(20) / fps
    rows = []
    for dev in widths:
        for noise in noises:
            y = np.exp(-((t - 1.0) ** 2) / (2 * dev ** 2))
            y = y + noise * rng.standard_normal(len(t))
            rows.append((dev, noise, t, y))

    # float32 windows, the JAX demo's dtype (it runs without x64).
    T = torch.tensor(np.stack([r[2] for r in rows]), dtype=torch.float32,
                     device=device)
    Y = torch.tensor(np.stack([r[3] for r in rows]), dtype=torch.float32,
                     device=device)
    M = torch.ones(T.shape, dtype=torch.bool, device=device)
    res = gaussfit.gaussian_fit_batch(T, Y, M)
    converged = res.converged.cpu().numpy()
    fit_dev = res.dev.cpu().numpy()

    print(f"{'true dev':>9} {'noise':>6} {'fit dev':>9} {'conv':>5} "
          f"{'accept(<'}{args.cutoff}{')':>3}")
    for i, (dev, noise, _, _) in enumerate(rows):
        conv = bool(converged[i])
        fdev = float(fit_dev[i])
        acc = conv and fdev < args.cutoff
        print(f"{dev:9.2f} {noise:6.2f} {fdev:9.3f} {str(conv):>5} "
              f"{str(acc):>7}")


if __name__ == "__main__":
    main()
