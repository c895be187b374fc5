"""Port parity: the IIR temporal filter (``temporal_filter="iir"``) against
the JAX package: the Butterworth bandpass designs, ``sosfilt``,
``temporal_bandpass_iir``, and ``locate`` / ``process_clip`` with the IIR
calibration.

Tolerances: float32 ``sosfilt`` is bit-equal (``ops/fma`` rounds each
multiply-add as XLA's CPU backend contracts it); float64 within 1e-12 of
the result's scale (XLA contracts float64 multiply-adds too, which the port
cannot emulate in float64).  The (b, a) form in float64 equals
``scipy.signal.lfilter`` to 1e-12 of the scale, and the JAX package's to
1e-7: its narrowband poles sit at radius ~0.99 and amplify the JAX side's
contracted rounding.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.ops import fft_bandpass as jbp
from respmon_tpu.ops import filters as jfilters
from respmon_tpu.pipeline import evm as jevm
from respmon_tpu.pipeline import scan as jscan
from respmon_tpu_torch import interop
from respmon_tpu_torch.ops import fft_bandpass as tbp
from respmon_tpu_torch.ops import filters as tfilters
from respmon_tpu_torch.pipeline import evm as tevm
from respmon_tpu_torch.pipeline import scan as tscan

torch.set_num_threads(1)

FPS = 10.0
CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                        skip_levels_at_top=2, temporal_filter="iir")
DESIGNS = [(0.4, 1.0, 10.0, 6), (0.1, 0.5, 30.0, 3), (1.0, 2.5, 25.0, 5)]


def _signal(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bbox(r):
    return tuple(int(v) for v in (r.x, r.y, r.w, r.h))


@pytest.fixture(scope="module")
def clip():
    return breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          dtype=np.float32)


@pytest.mark.parametrize("low,high,fs,order", DESIGNS)
def test_bandpass_designs_equal_the_jax_package(low, high, fs, order):
    got = tfilters.design_butter_bandpass(low, high, fs, order)
    want = jfilters.design_butter_bandpass(low, high, fs, order)
    assert (got.b, got.a, got.zi) == (want.b, want.a, want.zi)
    got_sos = tfilters.design_butter_bandpass_sos(low, high, fs, order)
    want_sos = jfilters.design_butter_bandpass_sos(low, high, fs, order)
    assert got_sos.sections == want_sos.sections
    assert len(got_sos.sections) == order
    hash(got_sos)


@pytest.mark.parametrize("shape", [(64,), (64, 300), (128, 6, 7)])
def test_sosfilt_float32_bit_equals_the_jax_package(shape):
    coeffs = tfilters.design_butter_bandpass_sos(0.4, 1.0, FPS)
    x = _signal(shape, np.float32)
    got = tfilters.sosfilt(coeffs, torch.from_numpy(x)).numpy()
    want = np.asarray(jfilters.sosfilt(
        jfilters.design_butter_bandpass_sos(0.4, 1.0, FPS), jnp.asarray(x)))
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_sosfilt_float64_matches_the_jax_package_and_scipy():
    coeffs = tfilters.design_butter_bandpass_sos(0.4, 1.0, FPS)
    x = _signal((128, 200), np.float64, seed=1)
    got = tfilters.sosfilt(coeffs, torch.from_numpy(x)).numpy()
    want = np.asarray(jfilters.sosfilt(
        jfilters.design_butter_bandpass_sos(0.4, 1.0, FPS), jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    ref = scipy.signal.sosfilt(np.asarray(coeffs.sections), x, axis=0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)


def test_sosfilt_columns_are_independent():
    # Columns of several signals side by side filter as each alone: the
    # IIR calibration filters all kept levels in one call.
    coeffs = tfilters.design_butter_bandpass_sos(0.4, 1.0, FPS)
    a = torch.from_numpy(_signal((64, 30), np.float32, seed=2))
    b = torch.from_numpy(_signal((64, 11), np.float32, seed=3))
    both = tfilters.sosfilt(coeffs, torch.cat([a, b], dim=1))
    assert torch.equal(both[:, :30], tfilters.sosfilt(coeffs, a))
    assert torch.equal(both[:, 30:], tfilters.sosfilt(coeffs, b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_temporal_bandpass_iir_sos_matches_the_jax_package(dtype):
    x = _signal((64, 12, 16), dtype, seed=4)
    got = tbp.temporal_bandpass_iir(torch.from_numpy(x), FPS, 0.4, 1.0,
                                    500.0).numpy()
    want = np.asarray(jbp.temporal_bandpass_iir(jnp.asarray(x), FPS, 0.4,
                                                1.0, 500.0))
    assert got.dtype == want.dtype == dtype
    if dtype == np.float32:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_temporal_bandpass_iir_ba_form_float64():
    x = _signal((64, 40), np.float64, seed=5)
    got = tbp.temporal_bandpass_iir(torch.from_numpy(x), FPS, 0.4, 1.0,
                                    500.0, sos=False).numpy()
    want = np.asarray(jbp.temporal_bandpass_iir(jnp.asarray(x), FPS, 0.4,
                                                1.0, 500.0, sos=False))
    ba = tfilters.design_butter_bandpass(0.4, 1.0, FPS, order=6)
    ref = scipy.signal.lfilter(ba.b, ba.a, x, axis=0) * 500.0
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * scale)


def test_iir_levels_in_one_call_equal_each_level_alone(clip):
    tcfg = interop.config_from_reference(CAL)
    lap = tevm._band_laplacian_levels(torch.from_numpy(clip[:64]), tcfg)
    got = tevm._bandpass_iir_levels(lap, FPS, tcfg)
    assert list(got) == list(lap)
    for i, lvl in lap.items():
        want = tbp.temporal_bandpass_iir(lvl, FPS, CAL.freq_min,
                                         CAL.freq_max, CAL.amplification)
        assert torch.equal(got[i], want)


@pytest.mark.parametrize("ingest", ["float32", "uint8"])
def test_locate_iir_matches_the_jax_package(clip, ingest):
    vid = clip[:64]
    if ingest == "uint8":
        vid = np.clip(np.round(vid * 255.0), 0, 255).astype(np.uint8)
    got = tevm.locate(torch.from_numpy(vid), FPS,
                      interop.config_from_reference(CAL))
    want = jevm.locate(jnp.asarray(vid), FPS, CAL)
    assert bool(got.found) and bool(want.found)
    assert _bbox(got) == _bbox(want)
    assert np.array_equal(got.heatmap_u8.numpy(), np.asarray(want.heatmap_u8))
    assert np.array_equal(got.thresh.numpy(), np.asarray(want.thresh))
    # The IIR calibration finds the breathing patch (centre (60, 80)).
    x, y, w, h = _bbox(got)
    assert x <= 80 <= x + w and y <= 60 <= y + h


def test_evm_bandpass_iir_matches_the_jax_package(clip):
    got = tevm.eulerian_magnification_bandpass(
        torch.from_numpy(clip[:64]), FPS, interop.config_from_reference(CAL))
    want = jevm.eulerian_magnification_bandpass(jnp.asarray(clip[:64]), FPS,
                                                CAL)
    scale = np.abs(np.asarray(want.raw)).max()
    for g, w in ((got.raw, want.raw), (got.masked, want.masked)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)


def test_process_clip_iir_matches_the_jax_package(clip):
    cfg = MonitorConfig(calibration=CAL)
    got = tscan.process_clip(clip, FPS, interop.config_from_reference(cfg),
                             device="cpu")
    want = jscan.process_clip(clip, FPS, cfg)
    assert got.found and want.found and got.roi == want.roi
    has = np.asarray(want.measure.has_bpm)
    assert has.sum() > 0
    assert np.array_equal(got.measure.has_bpm.numpy(), has)
    np.testing.assert_allclose(got.measure.bpm.numpy()[has],
                               np.asarray(want.measure.bpm)[has], rtol=1e-5)
    np.testing.assert_allclose(got.final_bpm, want.final_bpm, rtol=1e-5)


def test_locate_verbose_iir_logs_one_bandpass_stage(clip, caplog):
    import logging

    vid = torch.from_numpy(clip[:64])
    tcfg = interop.config_from_reference(CAL)
    with caplog.at_level(logging.INFO,
                         logger="respmon_tpu_torch.pipeline.evm"):
        got = tevm.locate_verbose(vid, FPS, tcfg)
    want = tevm.locate(vid, FPS, tcfg)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert caplog.text.count("temporal_bandpass_filter") == 1


@pytest.mark.parametrize("value", ["fir", "FFT", ""])
def test_other_temporal_filters_raise(clip, value):
    import dataclasses

    cfg = dataclasses.replace(interop.config_from_reference(CAL),
                              temporal_filter=value)
    with pytest.raises(ValueError, match="temporal_filter"):
        tevm.locate(torch.from_numpy(clip[:64]), FPS, cfg)
    with pytest.raises(AssertionError):
        jevm.locate(jnp.asarray(clip[:64]), FPS,
                    dataclasses.replace(CAL, temporal_filter=value))
