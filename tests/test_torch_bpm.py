"""Port parity: ops/filters, ops/peaks, ops/gaussfit and pipeline/bpm
against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.config import MeasureConfig
from respmon_tpu.io.synthetic import motion_trace
from respmon_tpu.ops import filters as jfilters
from respmon_tpu.ops import gaussfit as jgauss
from respmon_tpu.ops import peaks as jpeaks
from respmon_tpu.pipeline import bpm as jbpm
from respmon_tpu_torch.ops import filters as tfilters
from respmon_tpu_torch.ops import gaussfit as tgauss
from respmon_tpu_torch.ops import peaks as tpeaks
from respmon_tpu_torch.pipeline import bpm as tbpm

torch.set_num_threads(1)

FPS = 10.0
N = 128
COEFFS = tfilters.design_butter_lowpass(0.5, FPS, 3)
JCOEFFS = jfilters.design_butter_lowpass(0.5, FPS, 3)


def _ring(y, count, n=N):
    """Right-aligned (n,) f32 ring holding the last ``count`` of ``y``."""
    out = np.zeros(n, np.float32)
    out[n - count:] = np.asarray(y, np.float32)[-count:]
    return out


def test_design_matches_jax():
    assert (COEFFS.b, COEFFS.a, COEFFS.zi) == \
        (JCOEFFS.b, JCOEFFS.a, JCOEFFS.zi)
    assert COEFFS.padlen == JCOEFFS.padlen


def test_lfilter_sequential_and_assoc_match_jax():
    x = np.random.default_rng(0).standard_normal(40).astype(np.float32)
    zi = np.asarray(COEFFS.zi, np.float32) * x[0]
    want = np.asarray(jfilters.lfilter(JCOEFFS, jnp.asarray(x),
                                       zi=jnp.asarray(zi)))
    got = tfilters.lfilter(COEFFS, torch.from_numpy(x),
                           zi=torch.from_numpy(zi)).numpy()
    # Bit for bit: the port fuses multiply-adds where XLA's CPU backend
    # does (ops/fma.py).
    assert np.array_equal(got, want)
    want_a = np.asarray(jfilters.lfilter_assoc(JCOEFFS, jnp.asarray(x),
                                               zi=jnp.asarray(zi)))
    got_a = tfilters.lfilter_assoc(COEFFS, torch.from_numpy(x),
                                   zi=torch.from_numpy(zi)).numpy()
    assert np.array_equal(got_a, want_a)


@pytest.mark.parametrize("associative", [True, False])
def test_filtfilt_masked_batch_matches_jax(associative):
    _, y = motion_trace(num_samples=N, fps=FPS, bpm=18.0, noise=0.05)
    counts = [13, 20, 64, 127, 128]
    rings = np.stack([_ring(y, c) for c in counts])
    got = tfilters.filtfilt_masked(COEFFS, torch.from_numpy(rings),
                                   torch.tensor(counts),
                                   associative=associative).numpy()
    for row, c in enumerate(counts):
        want = np.asarray(jfilters.filtfilt_masked(
            JCOEFFS, jnp.asarray(rings[row]), c, associative=associative))
        np.testing.assert_allclose(got[row, N - c:], want[N - c:],
                                   rtol=1e-5, atol=1e-5)


def _peak_signals():
    rng = np.random.default_rng(3)
    sigs, counts = [], []
    for count in (13, 40, 90, 128):
        t = np.arange(N) / FPS
        y = np.sin(2 * np.pi * 0.3 * t) + 0.3 * rng.standard_normal(N)
        sigs.append(_ring(y, count))
        counts.append(count)
    plateau = np.zeros(N, np.float32)
    plateau[40:44] = 1.0                      # plateau peak
    plateau[80] = plateau[90] = 0.7           # equal-height tie
    sigs += [plateau, np.zeros(N, np.float32)]  # and a flat signal
    counts += [N, N]
    return np.stack(sigs), counts


@pytest.mark.parametrize("min_dist", [1, 10])
def test_peak_indexes_masked_exact(min_dist):
    sigs, counts = _peak_signals()
    idx, mask = tpeaks.peak_indexes_masked(torch.from_numpy(sigs),
                                           torch.tensor(counts), min_dist)
    for row, c in enumerate(counts):
        want_idx, want_mask = jpeaks.peak_indexes_masked(
            jnp.asarray(sigs[row]), jnp.asarray(c), min_dist)
        assert np.array_equal(idx[row].numpy(), np.asarray(want_idx))
        assert np.array_equal(mask[row].numpy(), np.asarray(want_mask))


def _windows(seed, noisy=True, batch=48, width=20):
    """Masked Gaussian-peak windows as the BPM stage cuts them (lengths 2
    to ``width``), with noise of up to 0.3 (1.0 on every 4th) if ``noisy``."""
    rng = np.random.default_rng(seed)
    t = np.zeros((batch, width), np.float32)
    y = np.zeros((batch, width), np.float32)
    m = np.zeros((batch, width), bool)
    for i in range(batch):
        k = int(rng.integers(2, width + 1))
        ti = rng.uniform(0, 10) + np.arange(k) / FPS
        c = ti[0] + rng.uniform(0.2, 1.8) * (k / FPS) / 2
        sig = rng.uniform(0.5, 2.0) * np.exp(
            -(ti - c) ** 2 / (2 * rng.uniform(0.1, 0.6) ** 2))
        noise = rng.uniform(0.0, 0.3 if i % 4 else 1.0) if noisy else 0.0
        t[i, :k] = ti
        y[i, :k] = sig + noise * rng.standard_normal(k)
        m[i, :k] = True
    return t, y, m


def _fits(t, y, m, iters):
    got = tgauss.gaussian_fit_batch(torch.from_numpy(t), torch.from_numpy(y),
                                    torch.from_numpy(m), iters=iters)
    want = jgauss.gaussian_fit_batch(jnp.asarray(t), jnp.asarray(y),
                                     jnp.asarray(m), iters=iters)
    return got, want


def test_fit_on_neither_cpu_nor_cuda_raises():
    # Off the CPU a fit launches the kernel or raises: no fallback to the
    # plain loop.
    t, y, m = (torch.from_numpy(a).to("meta")
               for a in _windows(0, noisy=False, batch=4, width=8))
    with pytest.raises(ValueError, match="CUDA"):
        tgauss.gaussian_fit_batch(t, y, m)


def test_reset_launches_zeroes_the_kernel_s_count(monkeypatch):
    # One counter for every wrapper's kernels, the fit's among them.
    from respmon_tpu_torch.ops import _build, ccl, pyramid_cuda, pyramid_mm

    counted = (tgauss.KERNELS.counted + ccl.KERNELS.counted
               + pyramid_cuda.KERNELS.counted + pyramid_mm.KERNELS.counted)
    assert set(counted) == set(_build.LAUNCHES)
    for n, k in enumerate(counted, 7):
        monkeypatch.setitem(_build.LAUNCHES, k, n)
    _build.reset_launches()
    assert _build.LAUNCHES == dict.fromkeys(counted, 0)


def test_a_launch_binds_once_passes_the_stream_and_counts(monkeypatch):
    # The launch boundary of ops/_build on a stand-in library: its
    # functions typed from the table at the first launch, the current
    # stream last, a non-zero cudaError_t raised and left uncounted.
    import ctypes
    from types import SimpleNamespace

    from respmon_tpu_torch.ops import _build

    calls, loads = [], []

    def kern(err, ptr, x, stream):
        calls.append((err, ptr, x, stream))
        return err

    def load(name):
        loads.append(name)
        return SimpleNamespace(kern=kern)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=1234))
    monkeypatch.setitem(_build.LAUNCHES, "stand_in", 0)
    kernels = _build.Kernels("stand_in", {"kern": "ipd"},
                             counted=("stand_in",))
    kernels.launch("kern", "cuda:0", 0, None, 0.5, count="stand_in")
    assert calls == [(0, None, 0.5, 1234)] and loads == ["stand_in"]
    assert kern.argtypes == [ctypes.c_int, ctypes.c_void_p, ctypes.c_double,
                             ctypes.c_void_p]
    assert kern.restype is ctypes.c_int
    assert _build.LAUNCHES["stand_in"] == 1
    with pytest.raises(RuntimeError,
                       match="^kern launch failed: cudaError_t 700$"):
        kernels.launch("kern", "cuda:0", 700, None, 0.5, count="stand_in")
    assert _build.LAUNCHES["stand_in"] == 1 and loads == ["stand_in"]


def _assert_params_close(got, want):
    conv = np.asarray(want.converged)
    for name in ("ampl", "center", "dev"):
        np.testing.assert_allclose(getattr(got, name).numpy()[conv],
                                   np.asarray(getattr(want, name))[conv],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype,iters", [(np.float32, 200),
                                         (np.float64, 500)])
def test_gaussian_fit_decisions_match_jax(dtype, iters):
    t, y, m = _windows(11)
    got, want = _fits(t.astype(dtype), y.astype(dtype), m, iters)
    conv = np.asarray(want.converged)
    assert np.array_equal(got.converged.numpy(), conv)
    assert np.array_equal(conv & (got.dev.numpy() < 10.0),
                          conv & (np.asarray(want.dev) < 10.0))
    if dtype == np.float64:
        _assert_params_close(got, want)


def test_gaussian_fit_f32_params_match_jax_on_clean_windows():
    # On noisy windows the f32 loop stops where the relative cost decrease
    # falls under ftol = 3.45e-4, and that stopping point moves with the
    # last-ULP differences of exp() and of the sums between XLA and
    # PyTorch (params up to ~2% apart there; the decisions above still
    # agree).  Clean windows converge to the same point.
    t, y, m = _windows(12, noisy=False)
    got, want = _fits(t, y, m, 200)
    assert np.array_equal(got.converged.numpy(), np.asarray(want.converged))
    _assert_params_close(got, want)


def test_solve3_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((16, 3, 3)).astype(np.float32)
    A[0] = 0.0                                   # singular -> zeros
    b = rng.standard_normal((16, 3)).astype(np.float32)
    got = tgauss._solve3(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    for i in range(16):
        want = np.asarray(jgauss._solve3(jnp.asarray(A[i]),
                                         jnp.asarray(b[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)


def test_estimate_bpm_batch_matches_jax():
    cfg = MeasureConfig()
    _, y = motion_trace(num_samples=150, fps=FPS, bpm=18.0, noise=0.02)
    counts = [13, 30, 64, 128, 128]
    ends = [13, 30, 64, 128, 150]
    rings = np.stack([_ring(y[:e], c) for c, e in zip(counts, ends)])
    ts = np.stack([_ring(np.arange(e) / FPS, c) for c, e in
                   zip(counts, ends)])
    got = tbpm.estimate_bpm(torch.from_numpy(rings), torch.from_numpy(ts),
                            torch.tensor(counts), COEFFS, 10, cfg)
    for row, c in enumerate(counts):
        want = jbpm.estimate_bpm_jit(jnp.asarray(rings[row]),
                                     jnp.asarray(ts[row]), jnp.asarray(c),
                                     JCOEFFS, 10, cfg)
        assert bool(got.has_bpm[row]) == bool(want.has_bpm)
        assert np.array_equal(got.accept_mask[row].numpy(),
                              np.asarray(want.accept_mask))
        assert int(got.peak_count[row]) == int(want.peak_count)
        if bool(want.has_bpm):
            np.testing.assert_allclose(float(got.bpm[row]), float(want.bpm),
                                       rtol=1e-5)
