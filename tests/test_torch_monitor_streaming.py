"""Port parity: the monitor's streaming-ROI mode (``streaming_roi=True``)
against the JAX package's, frame for frame, and the JAX package's tests of
that mode for the port.

Both monitors step through the same clip; after every ``step()`` the
state, the re-lock count and the ROI are recorded, and the two records
must be equal in average mode, float64 flow mode and float32 flow mode:
the re-lock trail comes from the frames and the rings only, so float32
flow tracking (which drifts from JAX's, ``tests/test_torch_flow.py``)
cannot move it.  Samples and BPM are held as ``tests/test_torch_monitor.py``
holds them: BPM within rtol 1e-5 and samples within 1e-5 in average mode
and float64 flow mode, the last BPM within 0.5 in float32 flow mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.capture import ArrayCapture as JArrayCapture
from respmon_tpu.io.faults import FaultInjector as JFaultInjector
from respmon_tpu.io.faults import FaultSchedule as JFaultSchedule
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.runtime import RespiratoryMonitor as JMonitor
from respmon_tpu_torch import interop
from respmon_tpu_torch.io.capture import ArrayCapture
from respmon_tpu_torch.io.faults import FaultInjector, FaultSchedule
from respmon_tpu_torch.ops import pyramid_cuda
from respmon_tpu_torch.runtime import RespiratoryMonitor

torch.set_num_threads(1)

FPS = 10.0
BPM_RTOL = 1e-5
DRIFT = (14.0, 24.0)
N_DRIFT = 96
STREAM_CAL = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                               skip_levels_at_top=1)
WARM_CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                             skip_levels_at_top=2)
WARM_BLACKOUT = dict(start=64 + 1 + 30, end=64 + 1 + 36)


def _drift_clip(method, dtype):
    # tests/test_streaming_checkpoint_faults.py:159-177's clip.
    return breathing_clip(num_frames=N_DRIFT, height=60, width=80, fps=FPS,
                          bpm=37.5, patch_center=(18, 20),
                          patch_size=(10, 12), amplitude=0.35,
                          drift_px=DRIFT, noise=0.0,
                          motion_px=1.5 if method == "flow" else 0.0,
                          texture_motion=method == "flow", dtype=dtype)


def _warm_clip():
    # tests/test_streaming_checkpoint_faults.py:276-309's clip.
    return breathing_clip(num_frames=64 + 1 + 160, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12, motion_px=2.0)


DRIFT_CFG = MonitorConfig(calibration=STREAM_CAL, streaming_roi=True,
                          streaming_interval=4, streaming_drift_px=2.0)
WARM_CFG = MonitorConfig(calibration=WARM_CAL, streaming_roi=True,
                         streaming_interval=8, streaming_drift_px=4.0)
KW = dict(capture_target="synthetic", save_all_data=False, visualize=None,
          auto_run=False, sync_fps=False)


def _pair(method, config, frames=None, capture=None, jcapture=None,
          dtype="float32", **kw):
    """The JAX package's monitor and the port's on the same frames."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "float64": (jnp.float64, torch.float64)}[dtype]
    jm = JMonitor(motion_extraction_method=method, config=config,
                  capture=jcapture or JArrayCapture(frames, fps=FPS),
                  compute_dtype=jdt, **KW, **kw)
    tm = RespiratoryMonitor(motion_extraction_method=method,
                            config=interop.config_from_reference(config),
                            capture=capture or ArrayCapture(frames, fps=FPS),
                            compute_dtype=tdt, device="cpu", **KW, **kw)
    return jm, tm


def _drive(mon):
    """Step to the end of the stream; (state, relocks, ROI) after every
    step."""
    trail = []
    while mon.cap.is_open():
        if not mon.step():
            break
        trail.append((mon.state, mon.relocks, (mon.x, mon.y, mon.w, mon.h)))
    return trail


def _drive_counting_k1(mon):
    """``_drive``, and the frames (T) of each of the port's K1 calls."""
    calls = []
    k1 = pyramid_cuda.laplacian_band_levels

    def counted(vid, levels, skip_top):
        calls.append(vid.shape[0])
        return k1(vid, levels, skip_top)

    pyramid_cuda.laplacian_band_levels = counted
    try:
        return _drive(mon), calls
    finally:
        pyramid_cuda.laplacian_band_levels = k1


RUNS = {
    # name: (method, numpy dtype, compute dtype)
    "average_f32": ("average", np.float32, "float32"),
    "flow_f64": ("flow", np.float64, "float64"),
    "flow_f32": ("flow", np.float32, "float32"),
}


@pytest.fixture(scope="module")
def runs():
    done = {}

    def get(name):
        if name not in done:
            method, np_dtype, dtype = RUNS[name]
            jm, tm = _pair(method, DRIFT_CFG, _drift_clip(method, np_dtype),
                           dtype=dtype)
            done[name] = (jm, _drive(jm), tm, _drive(tm))
        return done[name]
    return get


@pytest.mark.parametrize("name", sorted(RUNS))
def test_relock_trail_matches_jax_frame_for_frame(runs, name):
    jm, jtrail, tm, ttrail = runs(name)
    assert len(ttrail) == len(jtrail) == N_DRIFT
    assert ttrail == jtrail
    assert tm.relocks == jm.relocks >= 1
    assert tm.streaming_absorbed["measure"] == len(tm.data)
    assert tm.streaming_starts == 1


@pytest.mark.parametrize("name", ["average_f32", "flow_f64"])
def test_streaming_samples_and_bpm_match_jax(runs, name):
    jm, _, tm, _ = runs(name)
    assert len(tm.freq) == len(jm.freq) > 0
    np.testing.assert_allclose(np.asarray(tm.freq), np.asarray(jm.freq),
                               rtol=BPM_RTOL)
    assert tm.peak_indices == jm.peak_indices
    np.testing.assert_allclose(np.asarray(tm.data), np.asarray(jm.data),
                               rtol=0, atol=1e-5)


def test_streaming_float32_flow_bpm_within_half_of_jax(runs):
    jm, _, tm, _ = runs("flow_f32")
    assert len(tm.freq) > 0 and len(jm.freq) > 0
    assert abs(tm.freq[-1] - jm.freq[-1]) <= 0.5


def test_monitor_streaming_relock_follows_drift(runs):
    # tests/test_streaming_checkpoint_faults.py:180-194 for the port.
    mon = runs("average_f32")[2]
    assert mon.state == "measure", mon.error_message
    assert mon.relocks >= 2, f"only {mon.relocks} re-locks"
    ty, tx = 18.0 + DRIFT[0], 20.0 + DRIFT[1]
    assert mon.x <= tx <= mon.x + mon.w, (mon.x, mon.w, tx)
    assert mon.y <= ty <= mon.y + mon.h, (mon.y, mon.h, ty)


@pytest.mark.parametrize("name", ["flow_f64", "flow_f32"])
def test_monitor_streaming_relock_preserves_flow_tracking(runs, name):
    # tests/test_streaming_checkpoint_faults.py:201-209 for the port.
    mon = runs(name)[2]
    assert mon.state == "measure", mon.error_message
    assert mon.relocks >= 1
    assert np.isfinite(np.asarray(mon.data, float)).all()


@pytest.fixture(scope="module")
def warm_runs():
    good = _warm_clip()
    jm, tm = _pair(
        "flow", WARM_CFG,
        jcapture=JFaultInjector(JArrayCapture(good, fps=FPS),
                                [JFaultSchedule("blackout", **WARM_BLACKOUT)]),
        capture=FaultInjector(ArrayCapture(good, fps=FPS),
                              [FaultSchedule("blackout", **WARM_BLACKOUT)]),
        error_reset_delay=0.0)
    ttrail, k1_calls = _drive_counting_k1(tm)
    return jm, _drive(jm), tm, ttrail, k1_calls


def test_warm_recovery_matches_jax_frame_for_frame(warm_runs):
    jm, jtrail, tm, ttrail, _ = warm_runs
    assert ttrail == jtrail
    assert tm.error_message == jm.error_message is not None
    assert abs(tm.freq[-1] - jm.freq[-1]) <= 0.5


def test_streaming_warm_recovery_skips_buffer_refill(warm_runs):
    # tests/test_streaming_checkpoint_faults.py:276-309 for the port.
    tm, trail = warm_runs[2], [s for s, _, _ in warm_runs[3]]
    assert "error" in trail, "blackout never triggered the error state"
    i_err = trail.index("error")
    assert "measure" in trail[i_err:], "never recovered to measurement"
    i_meas = i_err + trail[i_err:].index("measure")
    assert i_meas - i_err <= 20, \
        f"warm recovery took {i_meas - i_err} frames (cold would be >64)"
    # The rings absorbed the error wait's frames and localized warm; one
    # cold calibration warm-started them.
    assert tm.streaming_absorbed["error"] >= 1
    assert tm.streaming_absorbed["calibration"] >= 1
    assert tm.streaming_starts == 1
    assert len(tm.benchmarker.ticks["Calibration Measurement"]) == \
        1 + tm.streaming_absorbed["calibration"]


def test_k1_calls_follow_the_monitor_counters(warm_runs):
    # Every K1 call of the warm-recovery run is a cold locate or a warm
    # start of the rings (T frames each), or one frame the rings absorbed
    # while measuring, in the error wait or in a warm calibration step
    # (T = 1): the count chip_smoke.py checks on the card.
    tm, k1_calls = warm_runs[2], warm_runs[4]
    absorbed = sum(tm.streaming_absorbed.values())
    cold = len(tm.benchmarker.ticks["Calibration Measurement"]) \
        - tm.streaming_absorbed["calibration"]
    assert cold == tm.streaming_starts == 1
    t = WARM_CAL.buffer_length
    assert sorted(k1_calls) == [1] * absorbed + [t] * (cold
                                                       + tm.streaming_starts)


def test_reset_keeps_the_rings_in_streaming_mode():
    good = _warm_clip()[:64 + 1 + 5]
    for streaming_roi in (True, False):
        cfg = MonitorConfig(calibration=WARM_CAL, streaming_roi=streaming_roi)
        jm, tm = _pair("average", cfg, good)
        _drive(jm)
        _drive(tm)
        assert tm.state == jm.state == "measure"
        assert (tm._streaming_state is not None) == streaming_roi
        rings = tm._streaming_state
        jm.reset()
        tm.reset()
        assert tm.state == jm.state == "initialize"
        if streaming_roi:
            # The same rings, still full: the next calibration is warm.
            assert tm._streaming_state is rings
            assert jm._streaming_state is not None
            assert tm._warm_calibration_available()
            assert jm._warm_calibration_available()
            assert tm._streaming_count == WARM_CAL.buffer_length
        else:
            # The reference's cold reset.
            assert tm._streaming_state is None is jm._streaming_state
            assert not tm._warm_calibration_available()
            assert tm._streaming_count == 0


def test_cold_reset_without_streaming_recalibrates_from_a_full_buffer():
    good = _warm_clip()
    jm, tm = _pair(
        "flow", MonitorConfig(calibration=WARM_CAL),
        jcapture=JFaultInjector(JArrayCapture(good, fps=FPS),
                                [JFaultSchedule("blackout", **WARM_BLACKOUT)]),
        capture=FaultInjector(ArrayCapture(good, fps=FPS),
                              [FaultSchedule("blackout", **WARM_BLACKOUT)]),
        error_reset_delay=0.0)
    ttrail = [s for s, _, _ in _drive(tm)]
    jtrail = [s for s, _, _ in _drive(jm)]
    assert ttrail == jtrail
    i_err = ttrail.index("error")
    i_meas = i_err + ttrail[i_err:].index("measure")
    assert i_meas - i_err > WARM_CAL.buffer_length
    assert tm.relocks == 0 and tm._streaming_state is None
    assert sum(tm.streaming_absorbed.values()) == tm.streaming_starts == 0
