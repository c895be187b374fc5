"""Port parity: the whole-clip path (pipeline/scan) and interop against
the JAX package, and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch


from respmon_tpu.config import CalibrationConfig, MeasureConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.pipeline import scan as jscan
from respmon_tpu_torch import interop
from respmon_tpu_torch.ops import filters as tfilters
from respmon_tpu_torch.pipeline import scan as tscan

torch.set_num_threads(1)

FPS = 10.0
CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                        skip_levels_at_top=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clip_f32():
    return breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          dtype=np.float32)


@pytest.fixture(scope="module")
def jax_result(clip_f32):
    return jscan.process_clip(clip_f32, FPS, MonitorConfig(calibration=CAL))


def _assert_runs_match(got, want):
    assert got.found == want.found
    assert got.roi == want.roi
    has = np.asarray(want.measure.has_bpm)
    assert np.array_equal(got.measure.has_bpm.numpy(), has)
    np.testing.assert_allclose(got.measure.bpm.numpy()[has],
                               np.asarray(want.measure.bpm)[has], rtol=1e-5)
    np.testing.assert_allclose(got.final_bpm, want.final_bpm, rtol=1e-5)
    assert got.error_frame == want.error_frame


def test_bpm_trace_matches_jax(jax_result):
    # The JAX measure_clip's BPM trace is bpm_trace of its own samples.
    cfg = MeasureConfig()
    coeffs = tfilters.design_butter_lowpass(0.5, FPS, cfg.filter_order)
    samples = np.asarray(jax_result.measure.samples)
    got_bpm, got_has = tscan.bpm_trace(torch.tensor(samples), FPS,
                                       coeffs, 10, cfg)
    has = np.asarray(jax_result.measure.has_bpm)
    assert has.sum() > 20
    assert np.array_equal(got_has.numpy(), has)
    np.testing.assert_allclose(got_bpm.numpy()[has],
                               np.asarray(jax_result.measure.bpm)[has],
                               rtol=1e-5)


def test_process_clip_f32_matches_jax(clip_f32, jax_result):
    got = tscan.process_clip(clip_f32, FPS, MonitorConfig(calibration=CAL))
    assert got.found and got.final_bpm is not None
    _assert_runs_match(got, jax_result)
    np.testing.assert_allclose(got.measure.samples.numpy(),
                               np.asarray(jax_result.measure.samples),
                               rtol=1e-5)


def test_process_clip_u8_matches_jax(clip_f32):
    u8 = np.clip(np.round(clip_f32 * 255.0), 0, 255).astype(np.uint8)
    cfg = MonitorConfig(calibration=CAL)
    got = tscan.process_clip(u8, FPS, cfg)
    assert got.measure.samples.dtype == torch.float32
    _assert_runs_match(got, jscan.process_clip(u8, FPS, cfg))


def test_process_clip_auto_matches_jax(clip_f32, jax_result):
    cfg = MonitorConfig(calibration=CAL)
    got = tscan.process_clip_auto(clip_f32, FPS, cfg)
    assert len(got.episodes) == 1 and got.recoveries == 0
    assert not got.exhausted
    _assert_runs_match(got.episodes[0].result, jax_result)
    np.testing.assert_allclose(got.final_bpm, jax_result.final_bpm,
                               rtol=1e-5)


def test_process_clip_not_found():
    vid = np.full((40, 48, 64), 0.5, np.float32)
    cfg = MonitorConfig(calibration=CalibrationConfig(
        buffer_length=32, pyramid_levels=4, skip_levels_at_top=1))
    got = tscan.process_clip(vid, FPS, cfg)
    assert not got.found and got.final_bpm is None
    auto = tscan.process_clip_auto(vid, FPS, cfg)
    assert auto.final_bpm is None
    assert all(not ep.result.found for ep in auto.episodes)


def test_flow_mode_raises(clip_f32):
    cfg = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
    with pytest.raises(NotImplementedError, match="flow mode"):
        tscan.process_clip(clip_f32, FPS, cfg)


def test_final_state_matches_jax_through_interop(jax_result, clip_f32):
    got = tscan.process_clip(clip_f32, FPS, MonitorConfig(calibration=CAL))
    jax_state = {f: np.asarray(v)
                 for f, v in jax_result.measure.final_state._asdict().items()}
    carried = interop.measure_state_from_numpy(jax_state)
    for field in carried._fields:
        a = getattr(carried, field)
        b = getattr(got.measure.final_state, field)
        assert a.shape == b.shape and a.dtype == b.dtype, field
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       err_msg=field)
        else:
            assert torch.equal(a, b), field


def test_interop_round_trip(jax_result):
    d = {f: np.asarray(v)
         for f, v in jax_result.measure.final_state._asdict().items()}
    back = interop.measure_state_to_numpy(interop.measure_state_from_numpy(d))
    assert set(back) == set(d)
    for f in d:
        assert back[f].dtype == d[f].dtype and np.array_equal(back[f], d[f])
    with pytest.raises(KeyError):
        interop.measure_state_from_numpy({"data": d["data"]})


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "from respmon_tpu.config import CalibrationConfig, MonitorConfig\n"
        "from respmon_tpu.io.synthetic import breathing_clip\n"
        "import respmon_tpu_torch, respmon_tpu_torch.interop\n"
        "from respmon_tpu_torch.pipeline import scan\n"
        "clip = breathing_clip(num_frames=40, height=48, width=64, "
        "patch_center=(24, 32), patch_size=(12, 16), amplitude=0.12)\n"
        "cfg = MonitorConfig(calibration=CalibrationConfig("
        "buffer_length=32, pyramid_levels=4, skip_levels_at_top=1))\n"
        "scan.process_clip(clip, 10.0, cfg)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
