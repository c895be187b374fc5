# Port of examples/filter_explorer.py.
"""Butterworth design/response exploration (reference prototypes/filter.py
analog): prints filter coefficients and -3 dB points for the pipeline's
lowpass/bandpass designs and applies them to a trace."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import scipy.signal as sps
    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import filters

    device = device_mod.resolve(args.device)
    fps = args.fps
    designs = {
        "lowpass o3 @ 0.5 Hz (BPM path)":
            filters.design_butter_lowpass(0.5, fps, 3),
        "bandpass o6 0.1-1.0 Hz (EVM IIR alt, SOS)":
            filters.design_butter_bandpass_sos(0.1, 1.0, fps, 6),
    }
    t, y = motion_trace(num_samples=256, fps=fps, bpm=18.0, noise=0.3)
    # float32, the JAX demo's dtype (it runs without x64).
    y_dev = torch.tensor(y, dtype=torch.float32, device=device)
    for name, c in designs.items():
        if isinstance(c, filters.SOSCoeffs):
            sos = np.asarray(c.sections)
            w, h = sps.sosfreqz(sos, fs=fps)
            out = filters.sosfilt(c, y_dev).cpu().numpy()
            order = 2 * len(c.sections)
        else:
            w, h = sps.freqz(np.asarray(c.b), np.asarray(c.a), fs=fps)
            out = filters.lfilter(c, y_dev).cpu().numpy()
            order = c.order
        mag = 20 * np.log10(np.maximum(np.abs(h), 1e-12))
        f3 = w[np.argmin(np.abs(mag + 3.0))]
        print(f"{name}: order={order}, approx -3dB @ {f3:.3f} Hz, "
              f"out std={out.std():.3f} (in {y.std():.3f})")
        if args.plot:
            import matplotlib.pyplot as plt

            plt.plot(w, mag, label=name)
    if args.plot:
        import matplotlib.pyplot as plt

        plt.ylim(-60, 3)
        plt.legend()
        plt.xlabel("Hz")
        plt.ylabel("dB")
        plt.show()


if __name__ == "__main__":
    main()
