"""Rehearsal of ``chip_smoke.py``'s monitor and fleet phases on the CPU: the
phase functions at 120x160 with a 64-frame calibration, the port on the CPU,
and CPU stand-ins for what only the card has (device synchronisation, the
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


def _count_fits(monkeypatch):
    """Each Gaussian fit adds the one launch it makes on the card to
    ``_build.LAUNCHES`` (on CPU tensors it runs the plain loop)."""
    from respmon_tpu_torch.ops import _build, gaussfit

    fit = gaussfit._fit

    def counted(*args):
        _build.LAUNCHES["gauss_fit"] += 1
        return fit(*args)

    monkeypatch.setattr(gaussfit, "_fit", counted)


def _count_ccl(monkeypatch):
    """Each batched connected-component search adds the one library call
    it makes on the card to ``_build.LAUNCHES`` (on CPU tensors it runs
    the plain version)."""
    from respmon_tpu_torch.ops import _build, ccl

    search = ccl.largest_component_bbox_batch

    def counted(fg):
        _build.LAUNCHES["ccl"] += 1
        return search(fg)

    monkeypatch.setattr(ccl, "largest_component_bbox_batch", counted)


@pytest.fixture
def cpu_stand_ins(monkeypatch):
    """No device to synchronise; no stencil launches to count (the wrappers
    run their plain versions on CPU tensors): each calibration's check
    records its arguments instead.  Each Gaussian fit and each
    connected-component search counts its launch."""
    _count_fits(monkeypatch)
    _count_ccl(monkeypatch)
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
    assert all(v == 0 for _, got in calls
               for v in chip_smoke.pyramid_launches(got).values())
    by_phase = {line["phase"]: line for line in lines}
    for method in ("average", "flow"):
        row = by_phase[f"monitor_{method}"]
        assert row["calibrations"] == 1 and row["bpm_count"] > 0
        # The float32 fit and the float64 refit of every estimate.
        assert row["launches"]["gauss_fit"] == 2 * row["estimates"] > 0
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
    assert row["launches"]["ccl"] == row["calibrations"]
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


# -- the streaming-ROI and IIR phases ----------------------------------------

@pytest.fixture
def planned_launches(monkeypatch):
    """CPU stand-ins that count: each K1 call adds the launches its plan
    makes on the card to ``_build.LAUNCHES``, and each Gaussian fit and
    connected-component search its one launch, so the phases' own launch
    checks run; no device to synchronise."""
    from respmon_tpu_torch.ops import _build, pyramid_cuda

    _count_fits(monkeypatch)
    _count_ccl(monkeypatch)

    k1 = pyramid_cuda.laplacian_band_levels

    def counted(vid, levels, skip_top):
        planned = chip_smoke.planned_launches(*vid.shape[1:], levels,
                                              skip_top)
        for k, n in planned.items():
            _build.LAUNCHES[k] += n
        return k1(vid, levels, skip_top)

    monkeypatch.setattr(pyramid_cuda, "laplacian_band_levels", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    return lines


# The 640x480 streaming clip's drift, scaled to 120x160 frames and a
# 64-frame calibration (1 + 64 + 1 + 64 frames).
SMALL_STREAM = dict(num_frames=1 + 64 + 1 + 64, height=120, width=160,
                    start=(50, 60), drift=(20.0, 40.0), patch_size=(20, 25))


def test_streaming_phase_rehearses_on_the_cpu(planned_launches):
    lines = planned_launches
    cal = CFG.calibration
    static = chip_smoke.quantize(breathing_clip(
        num_frames=64, height=120, width=160, fps=chip_smoke.FPS, bpm=18.0,
        patch_center=(60, 80), patch_size=(30, 40), amplitude=0.12))
    moving = chip_smoke.streaming_frames(**SMALL_STREAM)[1:]
    launches = chip_smoke.phase_streaming("cpu", cal, static, moving)
    row = lines[-1]
    assert row["phase"] == "streaming_640x480"
    absorbed = len(moving) - 64
    assert launches["pyr_tail"] == 1 + absorbed
    assert len(row["bboxes"]) == absorbed // 8
    assert row["absorb_ms"]["n"] == absorbed
    assert row["localize_ms"]["n"] == absorbed // 8


def test_monitor_streaming_phase_rehearses_on_the_cpu(planned_launches):
    lines = planned_launches
    frames = chip_smoke.streaming_frames(**SMALL_STREAM)
    start, drift = SMALL_STREAM["start"], SMALL_STREAM["drift"]
    launches = chip_smoke.phase_monitor_streaming(
        frames, CFG, "cpu", final=(start[0] + drift[0], start[1] + drift[1]))
    assert set(launches) == {"average", "flow"}
    rows = {line["phase"]: line for line in lines}
    for method in ("average", "flow"):
        row = rows[f"monitor_streaming_{method}"]
        assert row["relocks"] >= (2 if method == "average" else 1)
        assert len(row["relock_steps"]) == row["relocks"]
        absorbed = row["streaming_absorbed"]
        assert absorbed["measure"] == row["measured_step_ms"]["n"] == 64
        # K1: the locate and the rings' warm start (A d = 2 + B each at
        # 640x480; here B alone) and one call per absorbed frame.
        assert row["launches"]["pyr_tail"] == 2 + absorbed["measure"]
        split = row["split_ms"]
        assert split["absorb"]["n"] == 64
        assert split["localize"]["n"] == 64 // 8
        assert split["relock"]["n"] == row["relocks"]
        assert split["motion_step"]["n"] == 64


def test_warm_recovery_phase_rehearses_on_the_cpu(planned_launches):
    lines = planned_launches
    frames = _u8_clip(1 + 64 + 1 + 30 + 15 + 64 + 1 + 60)
    chip_smoke.phase_monitor_warm_recovery(frames, CFG, "cpu")
    row = lines[-1]
    assert row["phase"] == "monitor_warm_recovery_flow"
    start = row["blackout_frames"][0]
    assert start == 1 + 64 + 1 + 30
    assert start <= row["error_step"] < row["measure_again_step"] \
        < row["first_bpm_again_step"]
    assert row["fault_to_measure_frames"] < row["fault_to_bpm_frames"]
    assert row["frames_stepped"] == row["first_bpm_again_step"] + 1
    assert row["streaming_absorbed"]["error"] >= 1
    assert row["warm_calibration_steps"] >= 1
    assert row["roi_before"] is not None and row["roi_after"] is not None


def test_k1_streaming_check_fails_on_a_missing_launch(planned_launches):
    frames = chip_smoke.streaming_frames(**SMALL_STREAM)[:1 + 64 + 1 + 8]
    mon = chip_smoke.make_monitor(
        frames, "average", CFG.__class__(
            calibration=CFG.calibration, streaming_roi=True), device="cpu")
    chip_smoke.reset_launches()
    chip_smoke.drive_monitor(mon)
    launches = chip_smoke.read_launches()
    chip_smoke.check_k1_streaming(launches, mon, "a full count")
    launches["pyr_tail"] -= 1
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.check_k1_streaming(launches, mon, "one launch short")


def test_ccl_check_fails_on_a_missing_launch():
    chip_smoke.check_ccl_launches({"ccl": 3}, 3, "a full count")
    # One call short, and a run that made no search.
    for launches, searches in (({"ccl": 2}, 3), ({"ccl": 0}, 0)):
        with pytest.raises(RuntimeError, match="one ccl call a search"):
            chip_smoke.check_ccl_launches(launches, searches, "short")


def test_k1_bound_at_t1():
    # 640x480 L9/S4 at T = 1: the frame in (1.23 MB) and the kept levels
    # out, about 0.37 us at 3.35 TB/s; 1080p about 2.5 us.
    b = chip_smoke.k1_bound(1, 480, 640, 9, 4)
    assert b["bound_by"] == "bytes"
    assert 0.36e-3 < b["bound_ms"] < 0.38e-3
    b = chip_smoke.k1_bound(1, 1080, 1920, 9, 4)
    assert b["bound_by"] == "bytes" and 2.4e-3 < b["bound_ms"] < 2.6e-3


def test_main_prints_each_phase_seconds_within_the_budget():
    import inspect

    src = inspect.getsource(chip_smoke.main)
    for phase in ("phase_ccl", "phase_streaming_kernels", "phase_streaming",
                  "phase_monitor_streaming", "phase_monitor_warm_recovery",
                  "phase_iir_locate", "phase_monitor_recovery",
                  "phase_fleet", "phase_fleet_feeder",
                  "phase_fleet_cross_check", "phase_fleet_streaming",
                  "phase_fleet_1080p", "phase_fleet_kernels",
                  "phase_checkpoint", "phase_sharded", "phase_aux",
                  "phase_surface", "phase_examples", "phase_bench"):
        assert f"timed({phase}" in src
    # The K1 demos' paths, read beside the others in the kernels line.
    for path in ("example_locating_60x80", "example_flow_120x160",
                 "example_multistream_60x80"):
        assert f'"{path}"' in inspect.getsource(chip_smoke.phase_examples)
    assert "**example_launches" in src and '"entry_120x160"' in src
    assert "**bench_launches" in src
    assert '"phase_seconds"' in src and chip_smoke.TIME_BUDGET_S == 900


# -- the fleet phases ---------------------------------------------------------

# The fleet at 120x160: 4 streams on the 120x160 flow fixture's patch, at
# rates whose periods fit a 70-frame measurement.
FLEET_SMALL = dict(height=120, width=160, centres=((60, 80),) * 4,
                   bpms=(18.0, 20.0, 18.0, 20.0), patch_size=(30, 40))
FLEET_CFG = MonitorConfig(motion_extraction_method="flow",
                          calibration=CFG.calibration)


def test_fleet_and_feeder_phases_rehearse_on_the_cpu(planned_launches):
    lines = planned_launches
    clips = chip_smoke.fleet_clips(1 + 64 + 1 + 70, **FLEET_SMALL)
    launches, rows, boxes = chip_smoke.phase_fleet(
        clips, FLEET_CFG, "cpu", FLEET_SMALL["bpms"])
    row = lines[-1]
    assert row["phase"] == "fleet_640x480_flow" and row["locates"] == 4
    # One K1 call per stream's locate (B alone at 120x160), none per step.
    assert launches["pyr_tail"] == 4
    # One float32 fit an estimate: the fleet runs no float64 refit.
    assert launches["gauss_fit"] == row["estimates"] > 0
    assert rows.shape == (70, 4, 4) and row["step_ms"]["n"] == 70
    assert row["split_ms"]["motion_step"]["n"] == 70
    assert min(row["bpm_count"]) >= 1

    chip_smoke.phase_fleet_feeder(clips, rows, boxes, FLEET_CFG, "cpu",
                                  ticks=3, live_ticks=2)
    fed = lines[-1]
    assert fed["phase"] == "fleet_feeder_640x480"
    assert fed["native_collects"] >= 2 and fed["live_stale_rows"] >= 0

    chip_smoke.phase_fleet_cross_check("cpu", steps=2)
    cross = lines[-1]
    assert cross["average"]["bpm_gap"] == 0.0
    assert cross["flow"]["rois"] == cross["average"]["rois"]


def test_fleet_streaming_and_1080p_phases_rehearse_on_the_cpu(
        planned_launches):
    lines = planned_launches
    drifts = ((10.0, 20.0), (10.0, -20.0), (-10.0, 20.0), (-10.0, -20.0))
    clips = chip_smoke.fleet_clips(1 + 64 + 1 + 24, drifts, **FLEET_SMALL)
    launches = chip_smoke.phase_fleet_streaming(
        clips, MonitorConfig(calibration=CFG.calibration), "cpu",
        FLEET_SMALL["centres"], drifts)
    for method in ("average", "flow"):
        row = {line["phase"]: line for line in lines}[
            f"fleet_streaming_640x480_{method}"]
        # K1: 4 locates, one warm start (one chunk), one absorb a step.
        assert launches[method]["pyr_tail"] == 4 + 1 + 24
        assert row["streaming_absorbed"] == 24 and row["relocks"] >= 4
        assert row["split_ms"]["absorb"]["n"] == 24
        assert row["split_ms"]["localize"]["n"] == 24 // 8

    buffer = torch.from_numpy(_u8_clip(CFG.calibration.buffer_length))
    launches = chip_smoke.phase_fleet_1080p(
        [60, 45, 40, 30], buffer, "cpu", 3,
        MonitorConfig(calibration=CFG.calibration))
    row = lines[-1]
    assert row["phase"] == "fleet_1080p_flow"
    # The streaming rings start full, warm-started from the tiled clip.
    assert row["streaming"]["warm_start_s"] > 0.0
    # Three steps with an absorb and one with the coarse update.
    assert launches["pyr_tail"] == 4
    assert launches["gauss_fit"] == row["streaming"]["estimates"] == 4
    # The coarse update's one batched search over the 3 streams' masks.
    assert launches["ccl"] == 1
    assert len(row["streaming"]["absorb_step_ms"]) == 3
    assert row["streaming"]["split_ms"]["localize"]["n"] == 1
    assert len(row["f64_refine"]["step_ms"]) == 3
    assert row["k1_absorb_max_abs_err"] == 0.0


def test_checkpoint_and_sharded_phases_rehearse_on_the_cpu(
        planned_launches):
    lines = planned_launches
    cal_len = FLEET_CFG.calibration.buffer_length
    steps = sum(chip_smoke.CKPT_FLEET_STEPS)
    clips = chip_smoke.fleet_clips(1 + cal_len + 1 + steps, **FLEET_SMALL)
    frames = _u8_clip(1 + cal_len + 1 + chip_smoke.CKPT_MEASURED)
    rows = chip_smoke.phase_checkpoint(frames, clips, FLEET_CFG, "cpu")
    row = lines[-1]
    assert row["phase"] == "checkpoint_640x480_flow"
    assert len(row["monitor_samples"]) == chip_smoke.CKPT_MEASURED
    assert row["monitor_file_bytes"] > 0 and row["fleet_file_bytes"] > 0
    assert rows.shape == (steps, 4, 4)

    launches = chip_smoke.phase_sharded(frames, clips, rows, FLEET_CFG,
                                        "cpu", "gloo")
    row = lines[-1]
    assert row["phase"] == "sharded_one_rank_nccl"
    # One K1 call on the T-sharded shard, none in the W-sharded locate,
    # one per stream's locate in the fleet; one CCL call a locate.
    assert launches["tsharded"]["pyr_tail"] == 1
    assert not any(chip_smoke.pyramid_launches(launches["wsharded"])
                   .values())
    assert launches["wsharded"]["ccl"] == 1
    assert launches["fleet"]["pyr_tail"] == 4
    # Five T-sharded locates (a first, three timed, one counted), one
    # reduce-scatter a kept level each.
    assert row["tsharded_collectives"]["reduce_scatter"] == 5 * (
        FLEET_CFG.calibration.pyramid_levels - 1
        - FLEET_CFG.calibration.skip_levels_at_top)
    assert row["fleet_step_ms"]["n"] == steps


# -- the auxiliary modules and the demos --------------------------------------

def test_aux_phase_rehearses_on_the_cpu(monkeypatch):
    # No CUDA events on the CPU: the stand-in timer makes one call.
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: (fn(), 0.0)[1])
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    cal_u8 = _u8_clip(10)
    chip_smoke.phase_aux("cpu", cal_u8)
    row = lines[-1]
    assert row["phase"] == "aux"
    assert {"bgr_to_gray_480x640", "bgr_to_gray_1080x1920",
            "pixel_sum_series_128x480x640_u8", "normalize_480x640",
            "float_to_int8_480x640", "wavelet_filter_256",
            "wavelet_decompose_256", "freq_from_fft_256"} <= set(row["ms"])
    assert len([k for k in row["ms"] if k.startswith("detect_peaks")]) == \
        len(chip_smoke.PEAK_CASES)
    assert all(n > 0 for n in row["peaks_found"].values())
    assert row["errors"] == {"wavelet_filter_rel": 0.0,
                             "wavelet_decompose_rel": 0.0,
                             "freq_from_fft_hz": 0.0}
    assert abs(row["freq_from_fft_hz"] - 0.3) < 0.01   # the trace's 18 BPM


# The demos at the smoke tests' sizes (tests/test_examples_smoke.py).
SMALL_EXAMPLES = (
    ("signal_measurement_demo", ()), ("filter_explorer", ()),
    ("gaussian_explorer", ()), ("wavelet_demo", ("--iterations", "2")),
    ("temporal_analysis_demo", ("--frames", "64")),
    ("multiaxis_demo", ("--samples", "60")),
    ("locating_demo", ("--frames", "36")), ("flow_demo", ("--frames", "90")),
    ("multistream_demo", ("--streams", "2", "--frames", "70")),
    ("multistream_demo", ("--streams", "2", "--frames", "70", "--feeder")))


def test_examples_phase_rehearses_on_the_cpu(planned_launches, monkeypatch):
    lines = planned_launches
    monkeypatch.setattr(chip_smoke, "EXAMPLES", SMALL_EXAMPLES)
    launches = chip_smoke.phase_examples("cpu")
    assert set(launches) == {"example_locating_60x80",
                             "example_flow_120x160",
                             "example_multistream_60x80"}
    # One B a locate at these sizes: the locating demo's locate and its 36
    # absorbs, the flow demo's locate, one locate a stream.
    assert [launches[k]["pyr_tail"] for k in sorted(launches)] == [1, 37, 2]
    rows = {(ln["demo"], tuple(ln["args"])): ln for ln in lines}
    assert set(rows) == set(SMALL_EXAMPLES)
    assert all(r["seconds"] > 0 and r["numbers"] for r in rows.values())
    assert sum("cpu_seconds" in r for r in rows.values()) == \
        len(chip_smoke.EXAMPLES_VS_CPU)
    assert rows["locating_demo", ("--frames", "36")]["numbers"][0] == \
        ["6", "21", "48", "26"]


def test_examples_phase_fails_on_a_missing_launch(monkeypatch):
    monkeypatch.setattr(chip_smoke, "EXAMPLES",
                        (("locating_demo", ("--frames", "33")),))
    monkeypatch.setattr(chip_smoke, "emit", lambda row: None)
    # On the CPU no kernel launches, and nothing counts a plan's launches.
    with pytest.raises(RuntimeError, match="launched K1"):
        chip_smoke.phase_examples("cpu")


# -- the functions that completed the surface ---------------------------------

def _surface_inputs():
    """Measured frames of the 120x160 u8 clip, the ROI that ``locate``
    finds on it (tests/test_torch_flow.py), and a full 128-sample ring."""
    import numpy as np

    from respmon_tpu_torch.io.synthetic import motion_trace

    frames = _u8_clip(64 + 2 + chip_smoke.SURFACE_FRAMES)[66:]
    t, y = motion_trace(num_samples=128, fps=chip_smoke.FPS, bpm=18.0,
                        noise=0.05)
    ring = {"data": y.astype(np.float32), "t": t.astype(np.float32),
            "count": np.asarray(128, np.int32)}
    return frames, (58, 43, 43, 32), ring


@pytest.fixture
def cpu_timers(monkeypatch):
    """No CUDA events on the CPU: each stand-in timer makes one call."""
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "event_ms", lambda fn: (fn(), 0.0))


def test_surface_phase_rehearses_on_the_cpu(planned_launches, cpu_timers):
    lines = planned_launches
    frames, roi, ring = _surface_inputs()
    launches = chip_smoke.phase_surface(frames, roi, ring, "cpu")
    row = lines[-1]
    assert row["phase"] == "surface"
    # The entry's one (64, 120, 160) L6/S2 locate: B alone at this size.
    planned = chip_smoke.planned_launches(120, 160, 6, 2)
    assert {k: launches[k] for k in planned} == planned
    assert launches["pyr_tail"] == 1 and launches["ccl"] == 1
    assert sum(chip_smoke.pyramid_launches(launches).values()) == 1
    assert row["entry_found"] and row["entry_box"] == row["entry_cpu_box"]
    assert row["entry_heatmap_max_abs_diff"] == 0
    for method in ("flow", "average"):
        assert set(row[f"step_{method}_ms"]) == {
            "cached_hinted", "uncached", "uncached_hinted"}
    assert row["filtfilt_max_abs_err"] == 0.0
    assert min(row["peaks_found"]) > 0 and row["window_points"] >= 3
    for name in ("gaussian_fit_single_float32",
                 "gaussian_fit_single_float64"):
        assert row[name]["converged"] and row[name]["cpu_converged"]
    assert {"filtfilt_5x128", "filtfilt_128", "peak_indexes_5x128",
            "peak_indexes_128", "gaussian_fit_single_float32",
            "gaussian_fit_single_float64",
            "entry_locate_64x120x160"} == set(row["ms"])


def test_surface_phase_fails_on_a_missing_launch(cpu_timers, monkeypatch):
    monkeypatch.setattr(chip_smoke, "emit", lambda row: None)
    # On the CPU no kernel launches, and nothing counts a plan's launches.
    with pytest.raises(RuntimeError, match="launched K1"):
        chip_smoke.phase_surface(*_surface_inputs(), "cpu")


# -- the benchmark's modes ------------------------------------------------------

# Two of phase_bench's modes at a CPU size: the corpus (no K1) and the
# live path, which calibrates (K1).
SMALL_BENCH = (
    ("bpm_corpus", "main_bpm_corpus", {"n_traces": 1}),
    ("live", "main_live", {"measure_frames": 4, "capture_ms": 0.0,
                           "height": 120, "width": 160,
                           "calibration": CFG.calibration}),
)


def test_bench_phase_rehearses_on_the_cpu(planned_launches):
    lines = planned_launches
    paths = chip_smoke.phase_bench("cpu", SMALL_BENCH)
    assert set(paths) == {"bench_bpm_corpus", "bench_live"}
    # The corpus runs no stencil or band kernel, only the Gaussian fit.
    corpus = paths["bench_bpm_corpus"]
    assert sum(chip_smoke.pyramid_launches(corpus).values()) == 0
    assert corpus["gauss_fit"] > 0
    # The live mode's one 64-frame 120x160 locate.
    planned = chip_smoke.planned_launches(120, 160, 6, 2)
    assert {k: paths["bench_live"][k] for k in planned} == planned
    rows = [row for row in lines if row.get("phase") == "bench"]
    assert [row["mode"] for row in rows] == ["bpm_corpus", "live"]
    assert rows[1]["k1_calls"] == 1
    assert rows[1]["line"]["metric"] == "live_path_sustained_160x120"
    assert all(row["line"]["device"] == "cpu" for row in rows)


def test_bench_phase_fails_on_a_missing_launch(monkeypatch):
    monkeypatch.setattr(chip_smoke, "emit", lambda row: None)
    # On the CPU no kernel launches, and nothing counts a plan's launches.
    with pytest.raises(RuntimeError, match="every K1 call launched"):
        chip_smoke.phase_bench("cpu", SMALL_BENCH[1:])
