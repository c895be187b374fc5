"""The Gaussian LM fit's kernel (``csrc/gaussfit.cu``) against the plain
loop (``gaussfit._fit_loop``) on the card.  Every test here needs a card
and skips without one.  The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_gaussfit_cuda.py -o addopts="" \\
        --noconftest -q

The kernel sums as the plain loop's reductions and cuBLAS calls sum on the
card, in the orders read off an H100 for windows of W = 20 samples.  At the
single monitor's (12 lanes) and the 64-stream fleet's (768 lanes) shapes its
fits are the plain loop's bit for bit, wild lanes included: a float32 fit
whose center lies far outside the window wanders along its valley, and
where its dev ends against the cutoff follows every last bit.  At other
shapes the sums may fall in another order, so on noisy float32 windows the
loose ftol stop (3.45e-4) can fall an iteration apart and ill-posed lanes
wander apart.  The bar there is: the estimate's decisions equal on every
corpus window; on the lanes the estimate keeps (converged, dev under the
cutoff, not refit in float64) 99% of the parameters within 1e-3 and all
within 0.25 (on the same lanes the plain loop on an H100 lies up to 0.23
from itself on the CPU, 99% within 1.5e-4); on clean Gaussians within the
stop's own tolerance.  The sign of dev is arbitrary (the model holds
dev^2): |dev| is compared.
"""

import numpy as np
import pytest
import torch

from respmon_tpu_torch.bench import corpus_traces
from respmon_tpu_torch.config import MeasureConfig
from respmon_tpu_torch.ops import _build, filters, gaussfit
from respmon_tpu_torch.pipeline import bpm
from respmon_tpu_torch.utils import bench

pytestmark = pytest.mark.cuda

CFG = MeasureConfig()
# Parameters of kept float32 lanes of the corpus: relative gap of all of
# them, and of 99% of them.
CORPUS_RTOL_F32 = 0.25
CORPUS_RTOL_F32_Q99 = 1e-3
# Parameters of converged float64 lanes with dev under the cutoff.
CORPUS_RTOL_F64 = 1e-6
# Parameters of clean Gaussians: float32 within the stop's xtol (3.45e-4),
# float64 within 1e-9.
CLEAN_RTOL = {torch.float32: 3.45e-4, torch.float64: 1e-9}
# Lanes stopped after two iterations.
SHORT_RTOL = {torch.float32: 1e-4, torch.float64: 1e-8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def plain_loop(monkeypatch):
    """Route ``gaussfit._fit`` on the card to the plain loop."""
    def route():
        def fit(t, y, mask, iters, ftol, xtol):
            with bench.span("bpm.fit") as rec:
                return gaussfit._fit_loop(t, y, mask, iters, ftol, xtol, rec)
        monkeypatch.setattr(gaussfit, "_fit", fit)
    return route


def _corpus_rings(tr, stride=2):
    """Every ring window of a trace from initialization_length + 1 samples
    on (``tests/test_torch_bpm_corpus.py``'s windows)."""
    y, t = tr["y"], tr["t"]
    n = CFG.buffer_length
    steps = range(CFG.initialization_length + 1, len(y) + 1, stride)
    D = np.zeros((len(steps), n), np.float32)
    T = np.zeros((len(steps), n), np.float32)
    C = np.zeros((len(steps),), np.int32)
    for j, c in enumerate(steps):
        m = min(c, n)
        D[j, n - m:] = y[c - m:c]
        T[j, n - m:] = t[c - m:c]
        C[j] = m
    return D, T, C


def _estimate(tr, dev, fits):
    """``estimate_bpm`` of a trace's ring windows on the card; every fit's
    inputs and result go to ``fits``."""
    fps = tr["fps"]
    D, T, C = (torch.from_numpy(a).to(dev) for a in _corpus_rings(tr))
    fit = gaussfit.gaussian_fit_batch

    def seen(t, y, mask, iters=200):
        out = fit(t, y, mask, iters=iters)
        fits.append(((t, y, mask, iters), out))
        return out

    gaussfit.gaussian_fit_batch = seen
    try:
        return bpm.estimate_bpm(
            D, T, C, filters.design_butter_lowpass(0.5, fps, CFG.filter_order),
            max(int(np.floor(fps / 1.0)), 1), CFG)
    finally:
        gaussfit.gaussian_fit_batch = fit


def _kept(fit, cutoff):
    return fit.converged & (fit.dev < cutoff)


def _gaps(got, want, lanes):
    """Each lane's largest relative parameter gap, over ``lanes``."""
    gaps = [((g - w).abs() / w.abs())[lanes] for g, w in (
        (got.ampl, want.ampl), (got.center, want.center),
        (got.dev.abs(), want.dev.abs()))]
    return torch.stack(gaps, -1).amax(-1)


def _rel(got, want, lanes):
    return float(_gaps(got, want, lanes).max()) if bool(lanes.any()) \
        else 0.0


def test_estimate_on_the_corpus_equals_the_plain_loop(dev, plain_loop):
    traces = corpus_traces(120)[::7]
    got_fits, got = [], []
    for tr in traces:
        got.append(_estimate(tr, dev, got_fits))
    plain_loop()
    want_fits, want = [], []
    for tr in traces:
        want.append(_estimate(tr, dev, want_fits))
    torch.cuda.synchronize()
    n_bpm = 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.has_bpm, w.has_bpm), k
        assert torch.equal(g.accept_mask, w.accept_mask), k
        assert torch.equal(g.peak_count, w.peak_count), k
        assert torch.equal(g.bpm[w.has_bpm], w.bpm[w.has_bpm]), k
        n_bpm += int(w.has_bpm.sum())
    assert n_bpm > 0
    # One float32 fit and one float64 refit an estimate; the refit's lanes
    # (the suspect float32 fits) are the same.
    assert len(got_fits) == len(want_fits) == 2 * len(traces)
    cut = CFG.gaussian_cutoff
    gaps32, worst64 = [], 0.0
    for i in range(0, len(got_fits), 2):
        (_, g32), ((_, _, g_refit, _), g64) = got_fits[i:i + 2]
        (_, w32), ((_, _, w_refit, _), w64) = want_fits[i:i + 2]
        assert torch.equal(g_refit, w_refit)
        kept32 = _kept(g32, cut) & _kept(w32, cut) & ~w_refit.any(-1)
        gaps32.append(_gaps(g32, w32, kept32))
        worst64 = max(worst64, _rel(g64, w64,
                                    _kept(g64, cut) & _kept(w64, cut)))
    gaps32 = torch.cat(gaps32).double()
    q99 = float(gaps32.quantile(0.99))
    print(f"corpus parameter gaps: float32 max {float(gaps32.max())}, "
          f"99% {q99} over {gaps32.numel()} lanes; float64 max {worst64}")
    assert float(gaps32.max()) <= CORPUS_RTOL_F32
    assert q99 <= CORPUS_RTOL_F32_Q99
    assert worst64 <= CORPUS_RTOL_F64


def _noisy_rings(streams, seed):
    """Full 128-sample 10 fps rings of noisy breathing: the fits of their
    estimate hold many wild lanes."""
    rng = np.random.default_rng(seed)
    n = CFG.buffer_length
    t = np.arange(n) / 10.0 + 30.0
    rate = rng.uniform(12.0, 25.0, (streams, 1)) / 60.0
    amp = rng.uniform(0.02, 0.3, (streams, 1))
    noise = rng.choice([0.005, 0.02, 0.05], (streams, 1))
    y = amp * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi, (
        streams, 1))) + noise * rng.standard_normal((streams, n))
    return (np.asarray(y, np.float32), np.tile(t, (streams, 1)).astype(
        np.float32), np.full(streams, n, np.int32))


@pytest.mark.parametrize("streams", [1, 64])
def test_monitor_and_fleet_fits_equal_the_plain_loop_bit_for_bit(
        dev, plain_loop, streams):
    # The single monitor's estimate (a float32 fit and its float64 refit
    # of 12 lanes) and the fleet's (a float32 fit of 768 lanes), over
    # corpus rings at 10 fps and noisy rings.
    cfg = CFG if streams == 1 else MeasureConfig(f64_refine=False)
    tens = [tr for tr in corpus_traces(120) if tr["fps"] == 10.0]
    corpus = [np.concatenate(a) for a in zip(*(_corpus_rings(tr, stride=9)
                                               for tr in tens))]
    rng = np.random.default_rng(streams)
    batches = []
    for k in range(12 if streams == 1 else 3):
        pick = rng.choice(len(corpus[0]), streams, replace=False)
        batches.append(tuple(a[pick] for a in corpus))
        batches.append(_noisy_rings(streams, k))
    coeffs = filters.design_butter_lowpass(0.5, 10.0, cfg.filter_order)

    def estimates():
        fits = []
        fit = gaussfit.gaussian_fit_batch

        def seen(*args, **kwargs):
            fits.append(fit(*args, **kwargs))
            return fits[-1]

        gaussfit.gaussian_fit_batch = seen
        try:
            res = [bpm.estimate_bpm(*(torch.from_numpy(a).to(dev) for a in b),
                                    coeffs, 10, cfg) for b in batches]
        finally:
            gaussfit.gaussian_fit_batch = fit
        return res, fits

    got, got_fits = estimates()
    plain_loop()
    want, want_fits = estimates()
    assert len(got_fits) == len(want_fits) == len(batches) * (
        2 if streams == 1 else 1)
    for g, w in zip(got_fits + got, want_fits + want):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _clean(dtype, dev, lanes=256, w=20, seed=0):
    """Noise-free Gaussians whose centers lie inside the window."""
    rng = np.random.default_rng(seed)
    t = np.tile(np.arange(w) / 10.0, (lanes, 1))
    c = rng.uniform(0.6, 1.3, (lanes, 1))
    s = rng.uniform(0.15, 0.8, (lanes, 1))
    a = rng.uniform(0.3, 3.0, (lanes, 1))
    y = a * np.exp(-(t - c) ** 2 / (2 * s ** 2))
    return (torch.tensor(t, dtype=dtype, device=dev),
            torch.tensor(y, dtype=dtype, device=dev),
            torch.ones((lanes, w), dtype=torch.bool, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_clean_gaussians_within_the_stop_tolerance(dev, plain_loop, dtype):
    args = _clean(dtype, dev)
    got = gaussfit.gaussian_fit_batch(*args)
    plain_loop()
    want = gaussfit.gaussian_fit_batch(*args)
    assert bool(got.converged.all()) and bool(want.converged.all())
    assert _rel(got, want, want.converged) <= CLEAN_RTOL[dtype]


def test_corpus_windows_refit_in_float64_alike(dev, plain_loop):
    # Every float32 fit of a few corpus traces, refit whole at MINPACK's
    # float64 tolerances: the same lanes kept, their parameters close.
    fits = []
    for tr in corpus_traces(120)[:4]:
        _estimate(tr, dev, fits)
    windows = [[a.double() if a.is_floating_point() else a for a in args[:3]]
               for args, _ in fits if args[1].dtype == torch.float32]
    got = [gaussfit.gaussian_fit_batch(*w, iters=500) for w in windows]
    plain_loop()
    want = [gaussfit.gaussian_fit_batch(*w, iters=500) for w in windows]
    cut = CFG.gaussian_cutoff
    worst = 0.0
    for g, w in zip(got, want):
        assert torch.equal(_kept(g, cut), _kept(w, cut))
        worst = max(worst, _rel(g, w, _kept(w, cut)))
    print(f"float64 refit of whole fits: worst parameter gap {worst}")
    assert worst <= CORPUS_RTOL_F64


def _edge_batch(dev, dtype):
    """Lanes: a clean Gaussian; 2 valid points; all masked; a non-finite
    masked sample (a non-finite first cost); a noisy window."""
    t, y, m = _clean(dtype, dev, lanes=5)
    m[1, 2:] = False
    m[2] = False
    y[3, 4] = float("inf")
    noise = np.random.default_rng(1).normal(0.0, 0.05, y.shape[-1])
    y[4] += torch.tensor(noise, dtype=dtype, device=dev)
    return t, y, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_lanes(dev, plain_loop, dtype):
    t, y, m = _edge_batch(dev, dtype)
    got = gaussfit.gaussian_fit_batch(t, y, m)
    short = gaussfit.gaussian_fit_batch(t, y, m, iters=2)
    empty = gaussfit.gaussian_fit_batch(t[:0], y[:0], m[:0])
    plain_loop()
    want = gaussfit.gaussian_fit_batch(t, y, m)
    want_short = gaussfit.gaussian_fit_batch(t, y, m, iters=2)
    assert got.converged.tolist() == want.converged.tolist()
    assert got.converged.tolist()[:4] == [True, False, False, False]
    # Lanes that start done keep their initial guess and cost, bit for bit.
    for k in gaussfit.GaussFit._fields:
        torch.testing.assert_close(getattr(got, k)[1:4],
                                   getattr(want, k)[1:4], rtol=0, atol=0,
                                   equal_nan=True)
    assert bool(torch.isinf(got.ampl[2])) \
        and not bool(torch.isfinite(got.cost[3]))
    # Two iterations are not enough: no lane converges, and the lanes that
    # ran stand where the plain loop's stand after two.
    assert not bool(short.converged.any())
    assert not bool(want_short.converged.any())
    ran = torch.tensor([True, False, False, False, True], device=dev)
    assert _rel(short, want_short, ran) <= SHORT_RTOL[dtype]
    assert all(f.shape == (0,) for f in empty)
    assert empty.converged.dtype == torch.bool


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_window_tolerance_overrides(dev, plain_loop, dtype):
    t, y, m = _edge_batch(dev, dtype)
    args = (t[4], y[4], m[4])
    tols = ((None, None), (1e-2, 1e-2), (1.49e-8, 1.49e-8))
    got = [gaussfit.gaussian_fit_single(*args, ftol=f, xtol=x)
           for f, x in tols]
    plain_loop()
    want = [gaussfit.gaussian_fit_single(*args, ftol=f, xtol=x)
            for f, x in tols]
    for g, w in zip(got, want):
        assert g.ampl.shape == () and bool(g.converged) == bool(w.converged)
        assert _rel(g, w, w.converged) <= CORPUS_RTOL_F32


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    t, y, m = _clean(torch.float32, dev, lanes=4)
    with pytest.raises(ValueError):
        gaussfit.gaussian_fit_batch(t.t(), y.t(), m.t())
    with pytest.raises(TypeError):
        gaussfit.gaussian_fit_batch(t.double(), y, m)
    with pytest.raises(TypeError):
        gaussfit.gaussian_fit_batch(t, y, m.float())
    with pytest.raises(ValueError):
        gaussfit.gaussian_fit_batch(t, y, m.cpu())
    with pytest.raises(ValueError):
        gaussfit.gaussian_fit_batch(t[:, :5], y, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_launch_a_fit_and_the_loop_s_counts(dev, plain_loop, dtype):
    fits = []
    _estimate(corpus_traces(120)[3], dev, fits)
    t, y, m = ((a.to(dtype) if a.is_floating_point() else a)
               for a in fits[0][0][:3])
    before = _build.LAUNCHES["gauss_fit"]
    gaussfit.gaussian_fit_batch(t, y, m)
    assert _build.LAUNCHES["gauss_fit"] == before + 1
    bench.clear()
    bench.enable()
    try:
        gaussfit.gaussian_fit_batch(t, y, m)
        assert _build.LAUNCHES["gauss_fit"] == before + 2
        plain_loop()
        gaussfit.gaussian_fit_batch(t, y, m)
    finally:
        bench.disable()
    snap = bench.snapshot()
    bench.clear()
    # The kernel's fit opens no bpm.lm_step span; the plain loop's does.
    assert snap[0]["name"] == "bpm.fit" and snap[1]["name"] == "bpm.lm_step"
    got, want = (s["counts"] for s in snap if s["name"] == "bpm.fit")
    assert got["lanes"] == want["lanes"] > 0
    assert abs(got["steps"] - want["steps"]) <= 2
    assert got["lanes"] <= got["live_lane_steps"] \
        <= got["lanes"] * got["steps"]
