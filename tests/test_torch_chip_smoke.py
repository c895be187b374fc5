"""Rehearsal of ``chip_smoke.py``'s monitor phases on the CPU: the phase
functions at 120x160 with a 64-frame calibration, the port on the CPU, and
CPU stand-ins for what only the card has (device synchronisation, the
kernels' launch counts).  On the card the script runs them at 640x480 with
the default configuration."""

import pytest
import torch

import chip_smoke
from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io.synthetic import breathing_clip

torch.set_num_threads(1)

CFG = MonitorConfig(calibration=CalibrationConfig(
    buffer_length=64, pyramid_levels=6, skip_levels_at_top=2))


def _u8_clip(num_frames):
    clip = breathing_clip(num_frames=num_frames, height=120, width=160,
                          fps=chip_smoke.FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12, motion_px=2.0,
                          texture_motion=True, seed=1)
    return chip_smoke.quantize(clip)


@pytest.fixture
def cpu_stand_ins(monkeypatch):
    """No device to synchronise; no kernel launches to count (the wrappers
    run their plain versions on CPU tensors): each calibration's check
    records its arguments instead."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "check_k1_calibrations",
                        lambda launches, n, what: calls.append((n, launches)))
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    return calls, lines


def test_monitor_and_feeder_phases_rehearse_on_the_cpu(cpu_stand_ins):
    calls, lines = cpu_stand_ins
    frames = _u8_clip(64 + 1 + 90)
    launches, average_mon = chip_smoke.phase_monitor(frames, CFG, "cpu")
    assert set(launches) == {"average", "flow"}
    assert [n for n, _ in calls] == [1, 1]
    assert all(v == 0 for _, got in calls for v in got.values())
    by_phase = {line["phase"]: line for line in lines}
    for method in ("average", "flow"):
        row = by_phase[f"monitor_{method}"]
        assert row["calibrations"] == 1 and row["bpm_count"] > 0
        assert len(row["calibration_step_ms"]) == 1
        # Frame 0 initialises, 64 calibrate, one is dropped at the locate.
        assert row["measured_step_ms"]["n"] == len(frames) - 64 - 2
        assert row["benchmarker"]["Measurement Loop"]["count"] == \
            len(frames) - 64 - 2
        assert row["benchmarker"]["Calibration Measurement"]["count"] == 1
        assert row["measured_fps"] > 0
    assert by_phase["monitor_average"]["last_bpm_rel_vs_process_clip"] \
        <= 1e-5

    chip_smoke.phase_feeder(frames, average_mon, CFG, "cpu")
    feeder = lines[-1]
    assert feeder["phase"] == "feeder" and feeder["frames"] == len(frames)
    assert feeder["roi"] == by_phase["monitor_average"]["roi"]
    # The fed run stops after 60 measured frames; BPM estimates begin
    # after 12 samples.
    split = feeder["split_ms"]
    assert split["motion_step"]["n"] == feeder["measured_step_ms"]["n"] == 60
    assert split["estimate_bpm"]["n"] == 60 - 12
    assert split["gauss_fit_f32"]["n"] == split["gauss_fit_f64"]["n"] \
        == split["estimate_bpm"]["n"]
    # Each float32 fit of a window with peaks takes LM steps; the float64
    # refit takes none unless a fit is suspect.
    assert split["gauss_fit_f32_lm_steps"]["max"] >= 1
    assert split["gauss_fit_f64_lm_steps"]["median"] == 0


def test_recovery_phase_rehearses_on_the_cpu(cpu_stand_ins):
    calls, lines = cpu_stand_ins
    frames = _u8_clip(1 + 64 + 1 + 30 + 15 + 64 + 1 + 60)
    chip_smoke.phase_monitor_recovery(frames, CFG, "cpu")
    row = lines[-1]
    assert row["phase"] == "monitor_recovery_flow"
    assert row["calibrations"] >= 2 and calls[-1][0] == row["calibrations"]
    start = row["blackout_frames"][0]
    assert start == 1 + 64 + 1 + 30
    assert start <= row["error_step"] < row["measure_again_step"] \
        < row["first_bpm_again_step"]
    assert row["fault_to_bpm_frames"] == row["first_bpm_again_step"] \
        - start + 1
    assert row["fault_to_bpm_s"] > 0
    # The run ends at the first BPM after the recovery.
    assert row["frames_stepped"] == row["first_bpm_again_step"] + 1
    assert row["split_ms"]["motion_step"]["n"] == \
        row["measured_step_ms"]["n"]


def test_phases_fail_when_a_check_fails(cpu_stand_ins):
    # A clip that never recovers: the phase raises, it prints no result.
    frames = _u8_clip(1 + 64 + 1 + 40)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.phase_monitor_recovery(frames, CFG, "cpu")
