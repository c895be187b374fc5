"""The port's benchmark (``respmon_tpu_torch.bench``) against ``bench.py``.

Every mode runs once on the CPU at a small size (120x160 frames, a
64-frame calibration, 2 streams, 4 corpus traces) and prints exactly one
JSON line on stdout with ``bench.py``'s keys for that mode plus
``"device"``, all numbers finite.  The corpus is ``bench.py``'s bit for
bit, and over 4 traces (all at one fps, so JAX compiles once) the port's
``--bpm-corpus`` line agrees with ``bench.py``'s: equal has-BPM counts
and |dBPM| against the scipy chain within 1e-4.  Without a card every
mode raises, as the port's other entry points do."""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from respmon_tpu_torch import bench as tbench
from respmon_tpu_torch.config import CalibrationConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                              skip_levels_at_top=2)

# bench.py's keys of each mode's line, with the lines they come from.
HEADLINE_KEYS = {
    # bench.py:381-393
    "metric", "value", "unit", "vs_baseline", "value_with_upload",
    "upload_ingest", "u8_widen_exact_on_device",
    "value_with_upload_pcie16GBps_estimate",
    "h2d_overlap",                                   # :395
    "config3_locate_ms", "config3_geometry", "config3_found",
    "config3_realtime_x",                            # :354-359
    "gaussfit_device_agreement_realistic",
    "gaussfit_device_agreement_noise",               # :400-401
    "bpm_tail_median", "bpm_true", "bpm_oracle_delta",   # :403-406
    "fleet_streams", "fleet_geometry", "fleet_step_ms", "fleet_sfps",
    "fleet_realtime_margin_at_10fps",                # :520-526
}
OVERLAP_KEYS = {"upload_only_ms", "compute_only_ms", "overlapped_ms",
                "overlap_efficiency", "h2d_MBps",
                "pcie16GBps_upload_ms"}                # :310-321
CORPUS_KEYS = {                                     # :734-751
    "metric", "value", "unit", "vs_baseline", "n_traces", "n_steps",
    "n_both_have_bpm", "has_bpm_mismatch_rate", "delta_p50", "delta_p99",
    "delta_p999", "traces_within_half_bpm", "per_kind_max", "per_kind_p99"}
MULTISTREAM_KEYS = {                                # :986-999, :936-942
    "metric", "value", "unit", "vs_baseline", "step_ms",
    "step_ms_sync_fetch", "realtime_margin_at_10fps", "batch4_ms_per_frame",
    "batch4_realtime_margin", "recalibration_1080p_ms", "streaming_step_ms",
    "streaming_overhead_ms_per_step",
    "streaming_overhead_ms_per_stream_frame", "streaming_interval"}
BREAKDOWN_KEYS = {"metric", "value", "unit", "vs_baseline",   # :1429-1437
                  "production_step_ms", "stages_ms", "derived_ms"}
BREAKDOWN_STAGES = {                                # :1141-1403
    "floor (trivial program)", "crop+u8 (from 1080p frames)",
    "prev stacks (pyr+Scharr+pad)", "next build (slices)",
    "LK full (builds + Newton)", "measure_step (crop+LK+PCA+rings)",
    "filtfilt (masked Hillis-Steele)", "peak candidates",
    "gaussian LM fit (batched)", "estimate_bpm full",
    "FULL fused step (full rings)", "FULL + state materialization",
    "outputs floor (state-shaped)", "FULL fused step (3-sample rings)",
    "mon.step production (incl dispatch)",
    "mon.step production (u8 ingest)"}
BREAKDOWN_DERIVED = {                               # :1405-1425
    "newton_loop_ms", "flow_update_rings_ms", "bpm_stage_in_situ_ms",
    "fit_load_in_situ_ms", "state_writeout_ms", "state_io_floor_ms",
    "host_wrapper_dispatch_ms"}
LIVE_KEYS = {"metric", "value", "unit", "vs_baseline",  # :1580-1591
             "sync_fps", "overlap_gain", "dropped", "u8_upload_live_fps",
             "u8_upload_sync_fps", "simulated_capture_ms"}
FLEET_LIVE_KEYS = {"metric", "value", "unit", "vs_baseline",  # :1724-1734
                   "ticks", "tick_rate_hz", "stale_rate", "dropped_total",
                   "simulated_capture_ms"}
RECOVERY_KEYS = {                                   # :1894-1913
    "metric", "streaming_roi", "relocks", "value", "unit", "vs_baseline",
    "cycles", "max_latency_s", "compute_latency_s", "error_reset_delay_s",
    "pre_fault_bpm_tail_median", "bpm_true", "state_sequence_ok"}


def streaming_keys(key):                            # :1938-1940, 2018-2028
    return {"metric", "unit", "interval", "value", "vs_baseline"} | {
        f"{k}_{key}" for k in (
            "absorb_ms", "update_ms", "update_coarse_ms",
            "amortized_ms_per_frame", "amortized_coarse_ms_per_frame",
            "realtime_x")}


def _finite(obj, where="line"):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite(v, f"{where}.{k}")
    elif isinstance(obj, bool) or isinstance(obj, str):
        pass
    else:
        assert isinstance(obj, (int, float)) and math.isfinite(obj), \
            (where, obj)


def _one_line(capsys):
    """The one JSON line the mode printed on stdout."""
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    _finite(line)
    assert line["device"] == "cpu"
    return line


def test_corpus_traces_equal_bench_py_bit_for_bit():
    for n, length in ((1, 192), (7, 192), (40, 64), (120, 192), (3, 30)):
        got, want = tbench.corpus_traces(n, length), \
            bench.corpus_traces(n, length)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype
                    assert np.array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k]
    assert tbench.REFERENCE_BEST_FPS == bench.REFERENCE_BEST_FPS


def test_bpm_corpus_agrees_with_bench_py(capsys, tmp_path):
    # All 4 traces are at 5.01 fps, so JAX compiles its estimator once.
    assert {tr["fps"] for tr in bench.corpus_traces(4)} == {5.01}
    path = tmp_path / "corpus.json"
    got = tbench.main_bpm_corpus(n_traces=4, out_path=str(path),
                                 device="cpu")
    line = _one_line(capsys)
    assert line == got == json.loads(path.read_text())
    assert set(line) == CORPUS_KEYS | {"device"}
    want = bench.main_bpm_corpus(n_traces=4)
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jline == want
    assert line["metric"] == jline["metric"]
    for k in ("n_traces", "n_steps", "n_both_have_bpm",
              "has_bpm_mismatch_rate", "traces_within_half_bpm"):
        assert line[k] == jline[k], k
    assert line["n_both_have_bpm"] > 400
    assert abs(line["value"] - jline["value"]) <= 1e-4
    for kind, v in jline["per_kind_max"].items():
        assert abs(line["per_kind_max"][kind] - v) <= 1e-4, kind


def test_headline_prints_bench_py_keys(capsys):
    got = tbench.main_headline(
        height=120, width=160, measure_len=48, iters=1, config3_frames=64,
        calibration=SMALL_CAL, gaussfit_windows=30, fleet_streams=2,
        fleet_hw=(120, 160), fleet_box=(60, 40, 40, 30), fleet_steps=1,
        device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == HEADLINE_KEYS | {"device"}
    assert set(line["h2d_overlap"]) == OVERLAP_KEYS
    assert line["metric"] == \
        "evm_calibration_plus_flow_measurement_160x120"
    assert line["u8_widen_exact_on_device"] is True
    assert line["config3_found"] is True
    # The device's BPM tail equals the golden chain's on its own trace.
    assert line["bpm_oracle_delta"] <= 0.5
    assert line["fleet_streams"] == 2 and line["value"] > 0


def test_multistream_prints_bench_py_keys(capsys):
    got = tbench.main_multistream(
        2, height=120, width=160, calibration=SMALL_CAL, timed_steps=1,
        sync_steps=1, streaming_interval=2, batch_iters=1, device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == MULTISTREAM_KEYS | {"device"}
    assert line["metric"] == "multistream_2x160x120_flow_monitoring"
    assert line["streaming_interval"] == 2


def test_fleet_breakdown_prints_bench_py_keys(capsys):
    got = tbench.main_fleet_breakdown(
        2, height=120, width=160, calibration=SMALL_CAL, calls=1,
        windows=1, production_steps=1, device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == BREAKDOWN_KEYS | {"device"}
    assert set(line["stages_ms"]) == BREAKDOWN_STAGES
    assert set(line["derived_ms"]) == BREAKDOWN_DERIVED
    assert line["metric"] == "fleet_step_breakdown_2x160x120"


def test_live_prints_bench_py_keys(capsys):
    got = tbench.main_live(6, 0.0, height=120, width=160,
                           calibration=SMALL_CAL, device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == LIVE_KEYS | {"device"}
    assert line["metric"] == "live_path_sustained_160x120"
    assert line["dropped"] == 0


def test_fleet_live_prints_bench_py_keys(capsys):
    # 5 ms a decoded frame: sources with no cost would spin their feeder
    # threads against the fleet step for the interpreter.
    got = tbench.main_fleet_live(2, 3, 5.0, 120, 160, calibration=SMALL_CAL,
                                 device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == FLEET_LIVE_KEYS | {"device"}
    assert line["metric"] == "fleet_live_2x120p_sustained"
    assert line["ticks"] == 3


@pytest.mark.parametrize("warm", [False, True])
def test_recovery_prints_bench_py_keys(capsys, monkeypatch, warm):
    # The source serves frames at 10 fps of real time; here as fast as the
    # monitor takes them.
    monkeypatch.setattr(time, "sleep", lambda s: None)
    got = tbench.main_recovery(1, height=120, width=160, smoke=True,
                               streaming_roi=warm, device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == RECOVERY_KEYS | {"device"}
    assert line["metric"] == "error_recovery_soak_160x120" \
        + ("_warm_streaming" if warm else "")
    assert line["state_sequence_ok"] is True and line["cycles"] == 1
    assert line["streaming_roi"] is warm


def test_streaming_prints_bench_py_keys(capsys):
    got = tbench.main_streaming(3, 2, sizes=((120, 160), (96, 128)),
                                calibration=SMALL_CAL, device="cpu")
    line = _one_line(capsys)
    assert line == got
    assert set(line) == (streaming_keys("160_120") | streaming_keys("128_96")
                         | {"device"})
    assert line["value"] == line["amortized_ms_per_frame_160_120"]


MODES = {
    "main_headline": {}, "main_bpm_corpus": {}, "main_multistream": {},
    "main_fleet_breakdown": {}, "main_live": {}, "main_fleet_live": {},
    "main_recovery": {}, "main_streaming": {},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_default_to_the_card_and_raise_without_one(mode, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(tbench, mode)()
    assert capsys.readouterr().out == ""


def test_cli_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "respmon_tpu_torch.bench", "--bpm-corpus",
         "--traces", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode != 0 and out.stdout == ""
    assert 'device="cpu"' in out.stderr


# bench.py:2085-2103's dispatch, flag set by flag set.
DISPATCH = [
    (["--bpm-corpus", "--traces", "7", "--out", "x.json"],
     "main_bpm_corpus", dict(n_traces=7, out_path="x.json")),
    (["--recovery", "--cycles", "2", "--warm"], "main_recovery",
     dict(cycles=2, streaming_roi=True)),
    (["--streaming"], "main_streaming", {}),
    (["--breakdown", "--streams", "8"], "main_fleet_breakdown", (8,)),
    (["--fleet-live", "--frames", "5", "--capture-ms", "2", "--height",
      "120", "--width", "160"], "main_fleet_live",
     dict(streams=16, measure_frames=5, capture_ms=2.0, height=120,
          width=160)),
    (["--live", "--frames", "9"], "main_live", (9, 15.0)),
    (["--multistream", "--fleet-refine"], "main_multistream",
     dict(fleet_refine=True)),
    (["--no-fleet"], "main_headline", dict(include_fleet=False)),
    ([], "main_headline", dict(include_fleet=True)),
]


@pytest.mark.parametrize("argv,mode,want", DISPATCH)
def test_cli_dispatches_as_bench_py(monkeypatch, argv, mode, want):
    calls = []
    for name in MODES:
        monkeypatch.setattr(tbench, name,
                            lambda *a, _n=name, **k: calls.append((_n, a, k)))
    monkeypatch.setattr(sys, "argv", ["bench"] + argv + ["--device", "cpu"])
    tbench.main()
    assert len(calls) == 1
    name, args, kwargs = calls[0]
    assert name == mode and kwargs.pop("device") == "cpu"
    if isinstance(want, tuple):
        assert args[:len(want)] == want
    else:
        for k, v in want.items():
            assert kwargs[k] == v, k


def test_chip_smoke_checks_the_keys_listed_here():
    want = {"main_headline": HEADLINE_KEYS, "main_bpm_corpus": CORPUS_KEYS,
            "main_multistream": MULTISTREAM_KEYS,
            "main_fleet_breakdown": BREAKDOWN_KEYS, "main_live": LIVE_KEYS,
            "main_fleet_live": FLEET_LIVE_KEYS,
            "main_recovery": RECOVERY_KEYS,
            "main_streaming": streaming_keys("640_480")
            | streaming_keys("1080p")}
    assert {k: set(v) for k, v in chip_smoke.BENCH_KEYS.items()} == want
    assert {fn for _, fn, _ in chip_smoke.BENCH_MODES} == set(want)
