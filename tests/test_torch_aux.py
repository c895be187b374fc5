"""Port parity: the auxiliary modules (``ops/dtype``'s converters,
``ops/detect_peaks``, ``ops/wavelets``, ``utils/diagnostics``, ``version``)
against the JAX package on the same seeded numpy inputs, and against the
oracles the JAX tests use (``tests/golden/reference_numpy``, cv2)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import respmon_tpu
import respmon_tpu_torch
from respmon_tpu.ops import detect_peaks as jpeaks
from respmon_tpu.ops import dtype as jdtype
from respmon_tpu.ops import wavelets as jwav
from respmon_tpu.utils import diagnostics as jdiag
from respmon_tpu_torch.io import native
from respmon_tpu_torch.ops import detect_peaks as tpeaks
from respmon_tpu_torch.ops import dtype as tdtype
from respmon_tpu_torch.ops import wavelets as twav
from respmon_tpu_torch.utils import diagnostics as tdiag
from tests.golden import reference_numpy as golden

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_version_equals_the_jax_package():
    assert respmon_tpu_torch.__version__ == respmon_tpu.__version__ == "0.1.0"


# -- ops/dtype ----------------------------------------------------------------

@pytest.mark.parametrize("values", [
    np.arange(256, dtype=np.float32) / 255.0,
    [0.0, 0.5, 1.0, 0.3, 1.0 / 255.0, 127.0 / 255.0],
    [1.5, 2.0, -0.1, -1.0, 3.7, -0.003],   # out of range: wraps mod 256
    np.random.default_rng(0).uniform(-2.0, 3.0, 1000),
])
def test_float_to_int8_bit_equal_to_jax(values):
    x = np.asarray(values, np.float32)
    got = tdtype.float_to_int8(_t(x)).numpy()
    want = np.asarray(jdtype.float_to_int8(jnp.asarray(x)))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    # The reference stores trunc(x * 255) - 127 into a uint8 array.
    ref = np.mod(np.trunc(x * np.float32(255.0)).astype(np.int64) - 127, 256)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normalize_bit_equal_to_jax(dtype):
    x = np.random.default_rng(1).normal(0.3, 2.0, (480, 640)).astype(dtype)
    got = tdtype.normalize(_t(x)).numpy()
    want = np.asarray(jdtype.normalize(jnp.asarray(x)))
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 1.0


def test_normalize_of_a_constant_is_nan_in_both_packages():
    x = np.full((4, 5), 0.25, np.float32)
    assert np.isnan(tdtype.normalize(_t(x)).numpy()).all()
    assert np.isnan(np.asarray(jdtype.normalize(jnp.asarray(x)))).all()


def test_bgr_to_gray_bit_equal_to_jax_cv2_and_the_native_path():
    cv2 = pytest.importorskip("cv2")
    frame = np.random.default_rng(3).integers(0, 256, (48, 64, 3),
                                              dtype=np.uint8)
    got = tdtype.bgr_to_gray(_t(frame)).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(jdtype.bgr_to_gray(
        jnp.asarray(frame))))
    assert np.array_equal(got, cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    # io/native's C++ path returns the gray byte widened to float32.
    widened = (got.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    assert np.array_equal(native.bgr_to_gray_f32(frame).view(np.uint32),
                          widened.view(np.uint32))


def test_bgr_to_gray_equals_cv2_on_every_bgr_value():
    cv2 = pytest.importorskip("cv2")
    v = np.arange(1 << 24, dtype=np.uint32)
    frame = np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    got = tdtype.bgr_to_gray(_t(frame)).numpy()
    assert np.array_equal(got, cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))


# -- ops/detect_peaks ---------------------------------------------------------

def _peaks_both(x, **kw):
    """The port's (indices, mask) and the JAX package's, as numpy."""
    idx, mask = tpeaks.detect_peaks(_t(x), **kw)
    jidx, jmask = jpeaks.detect_peaks(jnp.asarray(x), **kw)
    got = (idx.numpy(), mask.numpy())
    assert got[0].dtype == np.int32
    assert np.array_equal(got[0], np.asarray(jidx)) and \
        np.array_equal(got[1], np.asarray(jmask)), kw
    return got[0][got[1]]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mpd,edge", [(1, "rising"), (5, "rising"),
                                      (3, None), (4, "both"),
                                      (2, "falling")])
def test_detect_peaks_matches_jax_and_the_oracle(seed, mpd, edge):
    x = np.random.default_rng(seed).standard_normal(96)
    got = _peaks_both(x, mpd=mpd, edge=edge)
    np.testing.assert_array_equal(
        got, golden.detect_peaks_oracle(x, mpd=mpd, edge=edge))


@pytest.mark.parametrize("kw", [{"mph": 0.5}, {"threshold": 0.2},
                                {"valley": True},
                                {"valley": True, "mpd": 4, "mph": -1.0}])
def test_detect_peaks_mph_threshold_valley(kw):
    x = np.cumsum(np.random.default_rng(9).standard_normal(80))
    got = _peaks_both(x, **kw)
    np.testing.assert_array_equal(got, golden.detect_peaks_oracle(x, **kw))


def test_detect_peaks_nan_handling():
    x = np.array([0., 1., 0., np.nan, 0., 2., 0., 1., 0.])
    np.testing.assert_array_equal(_peaks_both(x),
                                  golden.detect_peaks_oracle(x))


def test_detect_peaks_float32_and_more_peaks_than_slots():
    x = np.sin(np.arange(128) * 1.3).astype(np.float32)
    got = _peaks_both(x, max_peaks=8)
    np.testing.assert_array_equal(got, golden.detect_peaks_oracle(x)[:8])
    _peaks_both(x, mpd=3, max_peaks=8)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(n=st.integers(3, 150), seed=st.integers(0, 2 ** 31 - 1),
       nan_share=st.sampled_from([0.0, 0.05, 0.2]),
       plateaus=st.booleans(), mpd=st.integers(1, 7),
       edge=st.sampled_from([None, "rising", "falling", "both"]))
def test_detect_peaks_property(n, seed, nan_share, plateaus, mpd, edge):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if plateaus:
        x = np.round(x * 2.0) / 2.0
    x[rng.random(n) < nan_share] = np.nan
    got = _peaks_both(x, mpd=mpd, edge=edge)
    # The oracle orders candidates of equal height by numpy's argsort,
    # which is not stable (below); without ties it is the same.
    if not plateaus or mpd == 1:
        np.testing.assert_array_equal(
            got, golden.detect_peaks_oracle(x, mpd=mpd, edge=edge))


def test_detect_peaks_tie_keeps_the_later_index_as_jax_does():
    # Candidates 11 and 13 have equal heights (0.0 and -0.0) and lie within
    # mpd = 2: both packages keep the later one.  The oracle's argsort of
    # the heights is not stable, and here it keeps 11.
    x = np.round(np.random.default_rng(0).standard_normal(15) * 2.0) / 2.0
    assert x[11] == x[13] == 0.0
    np.testing.assert_array_equal(_peaks_both(x, mpd=2, edge=None),
                                  [2, 6, 13])


# -- ops/wavelets -------------------------------------------------------------

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [128, 37, 256])
def test_dwt_and_idwt_match_jax(dtype, n):
    x = np.random.default_rng(n).standard_normal(n).astype(dtype)
    a, d = twav.dwt_db4(_t(x))
    ja, jd = jwav.dwt_db4(jnp.asarray(x))
    assert a.dtype == d.dtype == _t(x).dtype
    assert a.shape[0] == (n + 7) // 2
    for got, want in ((a, ja), (d, jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    rec = twav.idwt_db4(a, d, n).numpy()
    want = np.asarray(jwav.idwt_db4(ja, jd, n))
    np.testing.assert_allclose(rec, want, rtol=TOL[dtype], atol=TOL[dtype])
    got_a = twav.idwt_db4(a, None, n).numpy()
    np.testing.assert_allclose(got_a, np.asarray(jwav.idwt_db4(ja, None, n)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_wavelet_perfect_reconstruction():
    x = np.random.default_rng(1).standard_normal(128)
    a, d = twav.dwt_db4(_t(x))
    np.testing.assert_allclose(twav.idwt_db4(a, d, 128).numpy(), x,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("iterations", [1, 3, 5])
def test_wavelet_decompose_and_filter_match_jax(dtype, iterations):
    from respmon_tpu_torch.io.synthetic import motion_trace

    _, y = motion_trace(num_samples=256, fps=10.0, bpm=18.0, noise=0.3)
    y = y.astype(dtype)
    ca, cd = twav.wavelet_decompose(_t(y), iterations)
    jca, jcd = jwav.wavelet_decompose(jnp.asarray(y), iterations)
    assert len(ca) == len(cd) == iterations
    for got, want in zip(ca + cd, jca + jcd):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    sm = twav.wavelet_filter(_t(y), iterations)
    assert sm.shape == (256,) and sm.dtype == _t(y).dtype
    np.testing.assert_allclose(
        sm.numpy(), np.asarray(jwav.wavelet_filter(jnp.asarray(y),
                                                   iterations)),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_wavelet_filter_smooths():
    fs = 50.0
    t = np.arange(256) / fs
    clean = np.sin(2 * np.pi * 0.5 * t)
    noisy = clean + 0.3 * np.random.default_rng(2).standard_normal(256)
    sm = twav.wavelet_filter(_t(noisy), iterations=3).numpy()

    def hf(s):
        return np.abs(np.diff(s, 2)).mean()

    assert hf(sm) < 0.3 * hf(noisy)
    assert np.corrcoef(sm[16:-16], clean[16:-16])[0, 1] > 0.95


# -- utils/diagnostics --------------------------------------------------------

def test_parabolic_matches_jax_and_the_quadratic_vertex():
    xs = np.arange(8).astype(float)
    f = -(xs - 3.4) ** 2 + 7
    xv, yv = tdiag.parabolic(_t(f), torch.tensor(3))
    jxv, jyv = jdiag.parabolic(jnp.asarray(f), jnp.asarray(3))
    assert abs(float(xv) - float(jxv)) <= 1e-12
    assert abs(float(yv) - float(jyv)) <= 1e-12
    np.testing.assert_allclose([float(xv), float(yv)], [3.4, 7.0],
                               atol=1e-9)


def _spectrum_argmax(sig):
    n = len(sig)
    w = tdiag._blackmanharris(n).astype(sig.dtype)
    return int(np.argmax(np.abs(np.fft.rfft(sig * w))))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9),
                                       (np.float32, 1e-4)])
@pytest.mark.parametrize("freq,n", [(0.31, 256), (0.3, 128), (0.07, 64),
                                    (1.9, 200)])
def test_freq_from_fft_matches_jax(dtype, tol, freq, n):
    fs = 10.0
    t = np.arange(n) / fs
    rng = np.random.default_rng(n)
    sig = (np.sin(2 * np.pi * freq * t)
           + 0.3 * rng.standard_normal(n)).astype(dtype)
    got = tdiag.freq_from_fft(_t(sig), fs)
    want = jdiag.freq_from_fft(jnp.asarray(sig), fs)
    assert got.dtype == _t(sig).dtype
    assert abs(float(got) - float(want)) <= tol
    # The same bin: the first maximum of the windowed spectrum.
    i = _spectrum_argmax(sig)
    assert abs(float(got) * n / fs - i) <= 0.5


def test_freq_from_fft_takes_the_first_of_equal_maxima():
    # Two equal spectral lines: both packages interpolate around the first.
    n, fs = 64, 10.0
    k = np.arange(n)
    sig = np.cos(2 * np.pi * 8 * k / n) + np.cos(2 * np.pi * 16 * k / n)
    got = float(tdiag.freq_from_fft(_t(sig), fs))
    assert abs(got - float(jdiag.freq_from_fft(jnp.asarray(sig), fs))) \
        <= 1e-9
    assert abs(got * n / fs - 8) < 0.5


def test_pixel_sum_series_u8_exact():
    vid = np.random.default_rng(5).integers(0, 256, (12, 48, 64),
                                            dtype=np.uint8)
    for bounds in (None, (10, 40, 5, 30)):
        got = tdiag.pixel_sum_series(_t(vid), bounds).numpy()
        want = np.asarray(jdiag.pixel_sum_series(jnp.asarray(vid), bounds))
        # Values, not dtypes: int64 here, JAX's unsigned sum there.
        assert np.array_equal(got, want.astype(np.int64))
        sums = vid.astype(np.int64)
        if bounds is not None:
            x0, x1, y0, y1 = bounds
            sums = sums[:, y0:y1, x0:x1]
        sums = sums.sum(axis=(1, 2))[1:-1]
        assert np.array_equal(got, sums - sums.min())


def test_pixel_sum_series_float32_within_1e_6():
    vid = np.random.default_rng(6).random((20, 60, 80)).astype(np.float32)
    got = tdiag.pixel_sum_series(_t(vid), (30, 50, 22, 38)).numpy()
    want = np.asarray(jdiag.pixel_sum_series(jnp.asarray(vid),
                                             (30, 50, 22, 38)))
    assert got.dtype == np.float32
    sums = vid[:, 22:38, 30:50].astype(np.float64).sum(axis=(1, 2))[1:-1]
    scale = np.abs(sums).max()
    assert np.abs(got - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("show", [False, True])
def test_show_frequencies_equals_jax(show, monkeypatch):
    if show:
        plt = pytest.importorskip("matplotlib.pyplot")
        monkeypatch.setattr(plt, "show", lambda: None)
    vid = np.random.default_rng(0).random((32, 8, 8))
    got = tdiag.show_frequencies(vid, 10.0, show=show, device="cpu")
    want = jdiag.show_frequencies(vid, 10.0, show=False)
    assert len(got[0]) == 30 and got[0].min() == 0.0
    # Equal to 1e-12: the float64 pixel sums are added in another order.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    if show:
        plt.close("all")
