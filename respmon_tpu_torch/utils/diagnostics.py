# Port of respmon_tpu/utils/diagnostics.py.
"""FFT diagnostics (reference C14: tools.py:7-45, transforms.py:105-118,
prototypes/parabolic.py).

``show_frequencies`` plots a video's pixel-sum time series and spectrum (a
debug aid off the main path); ``freq_from_fft`` estimates a dominant
frequency via a Blackman-Harris-windowed FFT with parabolic inter-sample
peak interpolation (the approach the reference prototyped in
temporal_analysis.py and abandoned for peak-to-peak intervals, README-
documented).  The estimators run in torch on their input's device;
plotting is host-side matplotlib, imported only where it plots."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from respmon_tpu_torch import device as device_mod


def parabolic(f: torch.Tensor, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic interpolation of the extremum around index x of f
    (prototypes/parabolic.py semantics): returns (x_vertex, y_vertex)."""
    f = torch.as_tensor(f)
    xm = f[x - 1]
    x0 = f[x]
    xp = f[x + 1]
    xv = x + 0.5 * (xm - xp) / (xm - 2.0 * x0 + xp)
    yv = x0 - 0.25 * (xm - xp) * (xv - x)
    return xv, yv


# Copied from respmon_tpu/utils/diagnostics.py:34-41 (numpy only).
def _blackmanharris(n: int) -> np.ndarray:
    """4-term Blackman-Harris window (scipy.signal.blackmanharris)."""
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    k = np.arange(n)
    return (a[0] - a[1] * np.cos(2 * np.pi * k / (n - 1))
            + a[2] * np.cos(4 * np.pi * k / (n - 1))
            - a[3] * np.cos(6 * np.pi * k / (n - 1)))


def freq_from_fft(sig: torch.Tensor, fs: float) -> torch.Tensor:
    """Dominant frequency via windowed FFT + parabolic peak interpolation
    (reference transforms.py:105-118).

    The window is cast to the signal's dtype, as in the JAX package: an
    integer series (``pixel_sum_series`` of a u8 video) gets an integer
    window, all zeros but its centre, in both packages.  A reference
    quirk, kept; callers pass a float series."""
    n = sig.shape[0]
    window = torch.as_tensor(_blackmanharris(n)).to(sig.device, sig.dtype)
    spectrum = torch.fft.rfft(sig * window).abs()
    # argmax is the first maximum, as jnp.argmax's.
    i = torch.argmax(spectrum).clamp(1, spectrum.shape[0] - 2)
    true_i, _ = parabolic(torch.log(spectrum + 1e-30), i)
    return fs * true_i / n


def pixel_sum_series(vid: torch.Tensor, bounds=None) -> torch.Tensor:
    """Per-frame pixel sums over frames 1..T-2 (tools.py:10-16 semantics:
    the first and last frames are skipped), optionally cropped to
    ``bounds = (x0, x1, y0, y1)``.  A u8 video sums in int64 (the JAX
    package's uint32 without x64: the same values)."""
    if bounds is not None:
        x0, x1, y0, y1 = bounds
        vid = vid[:, y0:y1, x0:x1]
    sums = vid.sum(dim=tuple(range(1, vid.ndim)))
    sums = sums[1:-1]
    return sums - sums.min()


def show_frequencies(vid_data, fps: float, bounds=None, show: bool = True,
                     device=None):
    """Plot pixel-average series + positive-frequency spectrum
    (tools.py:7-45).  Returns (averages, freqs, magnitudes) so headless
    callers can use the data without matplotlib.  The sums run on
    ``device`` (``None``: the card, or a CUDA tensor's own device)."""
    vid = torch.as_tensor(vid_data)
    vid = vid.to(device_mod.resolve(device, vid))
    averages = pixel_sum_series(vid, bounds).cpu().numpy()
    n = len(averages)
    freqs = np.fft.fftfreq(n, d=1.0 / fps)
    mags = np.abs(np.fft.fft(averages))
    order = np.argsort(freqs)
    freqs_sorted = freqs[order]
    mags_sorted = mags[order]
    pos = freqs_sorted[int(len(freqs_sorted) / 2.0 + 1.0):]
    pos_m = mags_sorted[int(len(mags_sorted) / 2.0 + 1.0):]

    if show:
        try:
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return averages, pos, pos_m
        plt.figure(figsize=(20, 10))
        plt.subplots_adjust(hspace=0.7)
        plt.subplot(2, 1, 1)
        plt.title("Pixel Average")
        plt.xlabel("Time")
        plt.ylabel("Brightness")
        plt.plot(averages)
        plt.subplot(2, 1, 2)
        plt.title("FFT")
        plt.xlabel("Freq (Hz)")
        plt.plot(pos, pos_m)
        plt.show()
    return averages, pos, pos_m
