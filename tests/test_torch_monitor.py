"""Port parity: the live single-stream RespiratoryMonitor
(calibrate -> measure -> error -> recalibrate) against the JAX package's,
frame for frame, and the tests of ``tests/test_monitor.py`` for the port.

Both monitors step through the same clip; the state after every ``step()``
is recorded.  Average mode (float32) and flow mode in float64 (JAX with
x64, which ``tests/conftest.py`` enables) must give equal state traces,
ROI, BPM count and peak indices, and BPM within ``tests/test_torch_scan.py``'s
rtol 1e-5.  Float32 flow tracking drifts from JAX's after about frame 35
(``tests/test_torch_flow.py``), so there only the ROI, the state trace and
BPM within 0.5 are compared.
"""

import math

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
from respmon_tpu_torch.pipeline import scan as tscan
from respmon_tpu_torch.runtime import RespiratoryMonitor

torch.set_num_threads(1)

FPS = 10.0
BPM_TRUE = 18.0
H, W = 120, 160
SMALL_CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                              skip_levels_at_top=2)
BPM_RTOL = 1e-5      # tests/test_torch_scan.py's BPM tolerance


def _clip(num_frames, motion_px=0.0, seed=0, dtype=np.float32):
    return breathing_clip(num_frames=num_frames, height=H, width=W, fps=FPS,
                          bpm=BPM_TRUE, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          motion_px=motion_px, seed=seed, dtype=dtype)


def _monitor(frames, method="average", capture=None, config=None, **kw):
    cfg = interop.config_from_reference(
        config or MonitorConfig(calibration=SMALL_CAL))
    return RespiratoryMonitor(
        capture_target="synthetic", save_all_data=False, visualize=None,
        motion_extraction_method=method, config=cfg,
        capture=capture or ArrayCapture(frames, fps=FPS), auto_run=False,
        sync_fps=False, device="cpu", **kw)


def _jax_monitor(frames, method="average", capture=None, config=None, **kw):
    return JMonitor(
        capture_target="synthetic", save_all_data=False, visualize=None,
        motion_extraction_method=method,
        config=config or MonitorConfig(calibration=SMALL_CAL),
        capture=capture or JArrayCapture(frames, fps=FPS), auto_run=False,
        sync_fps=False, **kw)


def _drive(mon, until=None):
    """Step ``mon`` to the end of its stream (or until ``until(trace)``);
    the state after every step."""
    trace = []
    while mon.cap.is_open():
        if not mon.step():
            break
        trace.append(mon.state)
        if until is not None and until(trace):
            break
    return trace


RUNS = {
    # name: (method, clip frames, motion_px, numpy dtype, compute dtypes)
    "average_f32": ("average", 64 + 1 + 80, 0.0, np.float32,
                    (jnp.float32, torch.float32)),
    "flow_f64": ("flow", 64 + 1 + 90, 2.0, np.float64,
                 (jnp.float64, torch.float64)),
    "flow_f32": ("flow", 64 + 1 + 90, 2.0, np.float32,
                 (jnp.float32, torch.float32)),
}


@pytest.fixture(scope="module")
def runs():
    """Both packages' monitors run on each RUNS clip, once per module."""
    done = {}

    def get(name):
        if name not in done:
            method, n, motion_px, np_dtype, (jdt, tdt) = RUNS[name]
            frames = _clip(n, motion_px=motion_px, dtype=np_dtype)
            jm = _jax_monitor(frames, method, compute_dtype=jdt)
            tm = _monitor(frames, method, compute_dtype=tdt)
            done[name] = (jm, _drive(jm), tm, _drive(tm))
        return done[name]
    return get


@pytest.mark.parametrize("name", ["average_f32", "flow_f64"])
def test_monitor_matches_jax_frame_for_frame(runs, name):
    jm, jtrace, tm, ttrace = runs(name)
    assert ttrace == jtrace
    assert tm.state == jm.state == "measure"
    assert (tm.x, tm.y, tm.w, tm.h) == (jm.x, jm.y, jm.w, jm.h)
    assert len(tm.freq) == len(jm.freq) > 0
    np.testing.assert_allclose(np.asarray(tm.freq), np.asarray(jm.freq),
                               rtol=BPM_RTOL)
    assert tm.peak_indices == jm.peak_indices
    np.testing.assert_allclose(np.asarray(tm.data), np.asarray(jm.data),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tm.filtered_data),
                               np.asarray(jm.filtered_data), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(tm.t), np.asarray(jm.t),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(tm.peak_times),
                                  np.asarray(jm.peak_times))


def test_monitor_float32_flow_matches_jax_in_roi_states_and_bpm(runs):
    jm, jtrace, tm, ttrace = runs("flow_f32")
    assert ttrace == jtrace
    assert (tm.x, tm.y, tm.w, tm.h) == (jm.x, jm.y, jm.w, jm.h)
    assert len(tm.freq) > 0 and len(jm.freq) > 0
    assert abs(tm.freq[-1] - jm.freq[-1]) <= 0.5


# -- tests/test_monitor.py for the port ------------------------------------

def test_average_mode_reaches_measure_state(runs):
    mon = runs("average_f32")[2]
    assert mon.state == "measure"
    assert mon.x is not None
    # ROI covers the breathing patch center (60, 80).
    assert mon.x <= 80 <= mon.x + mon.w
    assert mon.y <= 60 <= mon.y + mon.h


def test_average_mode_bpm_within_half(runs):
    mon = runs("average_f32")[2]
    assert len(mon.freq) > 0, "no BPM estimates produced"
    assert abs(mon.freq[-1] - BPM_TRUE) <= 0.5


def test_observable_buffers_mirror_reference_api(runs):
    mon = runs("average_f32")[2]
    assert len(mon.data) == len(mon.t)
    assert len(mon.filtered_data) == len(mon.data)
    assert mon.peak_minimum_sample_distance == int(np.floor(FPS / 1.0))
    for tag in ("Measurement Loop", "Frame Capture",
                "Calibration Measurement"):
        assert mon.benchmarker.has_tag(tag)
    assert mon.t[0] == 0.0
    np.testing.assert_allclose(np.diff(np.asarray(mon.t)), 1.0 / FPS)
    assert all(isinstance(v, float) for v in mon.data)


def test_flow_mode_tracks_and_estimates(runs):
    mon = runs("flow_f32")[2]
    assert mon.state == "measure"
    assert len(mon.freq) > 0
    # Flow + PCA BPM should land near truth (±1 BPM on synthetic motion).
    assert abs(mon.freq[-1] - BPM_TRUE) <= 1.0


def test_flow_keypoint_overlay_drawn():
    cv2 = pytest.importorskip("cv2")
    mon = _monitor(_clip(64 + 1 + 30, motion_px=2.0), method="flow")
    mon.run()
    assert mon.state == "measure"
    state = mon._measure_state
    dev_pts = state.pts.numpy()[state.pts_valid.numpy()]
    assert len(dev_pts) > 0
    ui_pts = np.asarray(mon.ui.keypoints).reshape(-1, 2)
    np.testing.assert_array_equal(ui_pts, dev_pts)

    df = mon.display_frame
    for a, b in ui_pts:
        x, y = int(round(float(a))), int(round(float(b)))
        if 0 <= y < df.shape[0] and 0 <= x < df.shape[1]:
            assert df[y, x] == 255, f"no overlay at point ({x}, {y})"
    # Bit-parity with the literal reference drawing loop.
    base = np.clip(np.trunc(mon.cropped_image * 255.0), 0, 255) \
        .astype(np.uint8)
    mask = np.zeros_like(base)
    disp = base.copy()
    for new in mon.ui.keypoints:
        a, b = new.ravel()
        mask = cv2.circle(mask, (int(round(float(a))),
                                 int(round(float(b)))), 2,
                          (255, 255, 255), -1)
        disp = cv2.add(disp, mask)
    np.testing.assert_array_equal(df, disp)


def test_skip_calibration_pins_roi():
    frames = _clip(40)
    mon = _monitor(frames, method="average")
    mon.fps = FPS
    mon.skip_calibration(60, 45, 40, 30)
    assert mon.state == "measure"
    mon.run()
    assert (mon.x, mon.y, mon.w, mon.h) == (60, 45, 40, 30)
    assert len(mon.data) == 40


def test_flow_error_recovery_cycle():
    good = _clip(64 + 1 + 30, motion_px=2.0)
    black = np.zeros((40, H, W), dtype=np.float32)
    frames = np.concatenate([good, black])
    mon = _monitor(frames, method="flow", error_reset_delay=0.0)
    mon.run()
    assert mon.error_message is not None, "error never triggered"
    assert mon.state in ("calibration", "error", "measure")
    assert mon.calibration_buffer_idx <= mon.calibration_buffer_target_length


def test_constructor_asserts_match_reference():
    with pytest.raises(AssertionError):
        _monitor(_clip(4), method="nonsense")
    with pytest.raises(AssertionError):
        RespiratoryMonitor(fps_limit=-1, visualize=None,
                           capture=ArrayCapture(_clip(4), fps=FPS),
                           auto_run=False, device="cpu")


# -- faults, buckets and ingest ---------------------------------------------

def test_blackout_cycle_matches_jax_step_for_step():
    # tests/test_streaming_checkpoint_faults.py:249-273 on both packages:
    # the error and the return to measurement fall on the same step.
    good = _clip(64 + 1 + 200, motion_px=2.0)
    blackout = dict(start=64 + 1 + 30, end=64 + 1 + 45)
    jm = _jax_monitor(None, "flow", error_reset_delay=0.0,
                      capture=JFaultInjector(
                          JArrayCapture(good, fps=FPS),
                          [JFaultSchedule("blackout", **blackout)]))
    tm = _monitor(None, "flow", error_reset_delay=0.0,
                  capture=FaultInjector(ArrayCapture(good, fps=FPS),
                                        [FaultSchedule("blackout",
                                                       **blackout)]))

    def back_to_measure(trace):
        return "error" in trace and trace[-1] == "measure"

    jtrace = _drive(jm, back_to_measure)
    ttrace = _drive(tm, back_to_measure)
    assert "error" in ttrace, "blackout never triggered the error state"
    assert tm.error_message == jm.error_message is not None
    i_err = ttrace.index("error")
    assert i_err == jtrace.index("error")
    assert ttrace[-1] == "measure" and len(ttrace) == len(jtrace)
    assert ttrace == jtrace
    # Recovery is a full recalibration: at least buffer_length frames.
    assert len(ttrace) - 1 - i_err > SMALL_CAL.buffer_length
    assert (tm.x, tm.y, tm.w, tm.h) == (jm.x, jm.y, jm.w, jm.h)


def test_measurement_bucket_reuse_across_recalibration():
    cal = CalibrationConfig(buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1)
    clip = breathing_clip(num_frames=20, height=60, width=80, fps=FPS,
                          bpm=18.0, patch_center=(30, 40),
                          patch_size=(16, 20), amplitude=0.25)
    mon = _monitor(clip, config=MonitorConfig(calibration=cal))
    mon.skip_calibration(10, 10, 30, 28)
    spec1 = mon._measure_spec
    # Slightly different ROI inside the same bucket -> same spec object.
    mon.skip_calibration(14, 12, 28, 26)
    assert mon._measure_spec is spec1
    # Tiny ROI (bucket area > 4x) -> rebuilt spec.
    mon.skip_calibration(14, 12, 8, 6)
    assert mon._measure_spec is not spec1


def test_nan_fault_passthrough_average_mode_no_error():
    good = _clip(64 + 1 + 40)
    src = FaultInjector(
        ArrayCapture(good, fps=FPS),
        [FaultSchedule("nan", start=64 + 1 + 10, end=64 + 1 + 12)])
    mon = _monitor(None, "average", capture=src)
    mon.run()
    assert mon.state == "measure"
    assert mon.error_message is None
    assert any(math.isnan(v) for v in mon.data)


def test_monitor_u8_capture_bit_equals_float_monitor():
    # tests/test_u8_ingest.py:203 for the port.
    clip_f = _clip(64 + 2 + 60, motion_px=2.0)
    clip_u8 = np.clip(np.round(clip_f * 255.0), 0, 255).astype(np.uint8)
    clip_host = (clip_u8.astype(np.float64) * (1.0 / 255.0)).astype(
        np.float32)
    m_u8 = _monitor(clip_u8, "flow")
    m_f = _monitor(clip_host, "flow")
    m_u8.run()
    m_f.run()
    assert m_u8.ingest_uint8 and not m_f.ingest_uint8
    assert m_u8.calibration_buffer.dtype == np.uint8
    assert (m_u8.x, m_u8.y, m_u8.w, m_u8.h) == (m_f.x, m_f.y, m_f.w, m_f.h)
    assert np.array_equal(np.asarray(m_u8.data), np.asarray(m_f.data),
                          equal_nan=True)
    assert list(m_u8.freq) == list(m_f.freq)
    assert abs(m_u8.freq[-1] - BPM_TRUE) <= 1.0
    # Observable host mirrors keep the float [0, 1] convention.
    assert m_u8.cropped_image.dtype == np.float64
    assert float(m_u8.cropped_image.max()) <= 1.0


def test_monitor_matches_process_clip_on_decoded_frames(tmp_path):
    # tests/test_clip_replay.py:55-79 for the port: a codec round trip,
    # then the monitor against the port's whole-clip path.
    cv2 = pytest.importorskip("cv2")
    from respmon_tpu_torch.io.capture import OpenCVCapture

    path = str(tmp_path / "breathing.avi")
    u8 = np.clip(_clip(64 + 2 + 110, motion_px=2.0) * 255, 0, 255).astype(
        np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (W, H))
    assert vw.isOpened()
    for f in u8:
        vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    vw.release()

    cap = OpenCVCapture(path)
    frames = []
    while True:
        f = cap.next_frame()
        if f is None:
            break
        frames.append(f)
    cap.release()
    frames = np.stack(frames).astype(np.float32)

    cfg = MonitorConfig(calibration=SMALL_CAL)
    res = tscan.process_clip(frames, FPS, interop.config_from_reference(cfg),
                             device="cpu")
    assert res.found
    mon = _monitor(frames, "average", config=cfg)
    mon.run()
    assert (mon.x, mon.y, mon.w, mon.h) == res.roi
    np.testing.assert_allclose(res.final_bpm, mon.freq[-1], atol=1e-4)


# -- construction ----------------------------------------------------------

def test_streaming_roi_is_not_ported_yet():
    # The streaming-ROI mode is ported now (its parity tests are in
    # tests/test_torch_monitor_streaming.py): both ways of asking for it
    # construct a monitor in that mode, with no rings before calibrating.
    for mon in (_monitor(_clip(4), streaming_roi=True),
                _monitor(_clip(4), config=MonitorConfig(
                    calibration=SMALL_CAL, streaming_roi=True))):
        assert mon.config.streaming_roi
        assert mon._streaming_state is None and mon.relocks == 0


def test_constructor_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        RespiratoryMonitor(visualize=None, save_all_data=False,
                           capture=ArrayCapture(_clip(4), fps=FPS),
                           auto_run=False)
    mon = _monitor(_clip(4))
    assert mon.device == torch.device("cpu")


def test_verbose_calibration_and_recording(tmp_path, caplog):
    # verbose_evm=True calibrates through locate_verbose (one log line per
    # EVM stage) to the same ROI; save_all_data=True records the ROI crops
    # and the (t, sample) trace at the capture target's path.
    import logging

    pytest.importorskip("cv2")
    frames = _clip(64 + 1 + 20)
    target = str(tmp_path / "session")
    plain = _monitor(frames)
    plain.run()
    with caplog.at_level(logging.INFO,
                         logger="respmon_tpu_torch.pipeline.evm"):
        mon = RespiratoryMonitor(
            capture_target=target, save_all_data=True, visualize=None,
            config=interop.config_from_reference(
                MonitorConfig(calibration=SMALL_CAL)),
            capture=ArrayCapture(frames, fps=FPS), auto_run=False,
            sync_fps=False, device="cpu", verbose_evm=True)
        mon.run()
    assert "collapse_laplacian_video_pyramid" in caplog.text
    assert (mon.x, mon.y, mon.w, mon.h) == \
        (plain.x, plain.y, plain.w, plain.h)
    trace = np.load(target + ".npy")
    np.testing.assert_array_equal(trace[:, 0], np.asarray(mon.t))
    np.testing.assert_array_equal(trace[:, 1], np.asarray(mon.data))
    assert (tmp_path / "session.avi").stat().st_size > 0
