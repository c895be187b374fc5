"""The port's spans and counters (``utils/bench.span``): recording off and
on, the tree a monitor step and a fleet step leave, the ring's bound, the
clock against the profiler's mirrors, the counts against replays of the
loops they count, outputs unchanged by tracing, and the benchmark's readers
of the spans (``benchmark/metrics``) on hand-built inputs."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import cells, timing
from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io.capture import ArrayCapture
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.ops import _build, ccl, gaussfit
from respmon_tpu_torch.parallel import streams
from respmon_tpu_torch.runtime import RespiratoryMonitor
from respmon_tpu_torch.utils import bench

torch.set_num_threads(1)

FPS = 10.0
H, W = 120, 160
CAL = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                        skip_levels_at_top=2)
MEASURED = 4    # measured steps, each estimating a full ring


@pytest.fixture(autouse=True)
def _fresh_ring():
    bench.disable()
    bench.clear()
    yield
    bench.disable()
    bench.clear()


def _names(snap):
    return [s["name"] for s in snap]


# ---------------------------------------------------------------------------
# Recording off and on
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with bench.span("t.a", n=1) as rec:
        rec.set(n=2)
        with bench.span("t.b"):
            pass
    assert bench.span("t.c") is bench.span("t.d")   # one shared no-op
    assert bench.snapshot() == [] and opened == []
    bench.enable()
    with bench.span("t.a"):
        pass
    assert opened == ["span:t.a"]


def test_enable_and_a_profiler_each_turn_recording_on():
    with bench.span("t.off"):
        pass
    bench.enable()
    with bench.span("t.enabled", n=3):
        pass
    bench.disable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with bench.span("t.profiled"):
            pass
    with bench.span("t.off_again"):
        pass
    snap = bench.snapshot()
    assert _names(snap) == ["t.enabled", "t.profiled"]
    assert snap[0]["counts"] == {"n": 3}


def test_the_ring_stays_bounded():
    bench.enable()
    for _ in range(bench.RING + 5):
        with bench.span("t.x"):
            pass
    snap = bench.snapshot()
    assert len(snap) == bench.RING
    ids = [s["id"] for s in snap]
    assert ids == list(range(ids[0], ids[0] + bench.RING))
    bench.clear()
    assert bench.snapshot() == []


def test_snapshot_times_agree_with_the_profiler_mirrors():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with bench.span("t.warm"):
            pass
    bench.clear()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            with bench.span("t.outer"):
                with bench.span("t.inner"):
                    torch.ones(256).sum()
                    time.sleep(0.001)
    mirrors = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("span:t."):
            mirrors.setdefault(e.name()[5:], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    snap = bench.snapshot()
    assert len(snap) == 10
    for s in snap:
        a, b = min(mirrors[s["name"]],
                   key=lambda m: abs(m[0] - s["start_ns"]))
        assert abs(s["start_ns"] - a) <= 100_000, (s, a)
        assert abs(s["end_ns"] - b) <= 100_000, (s, b)


# ---------------------------------------------------------------------------
# The trees of a monitor step and a fleet step; outputs unchanged
# ---------------------------------------------------------------------------

def _full_ring(mon):
    """Give a monitor that has just calibrated a full signal ring (a sine
    at 18 BPM) on the device and in its host mirrors, so that every
    measured step estimates a BPM."""
    n = mon.config.measure.buffer_length
    t = np.arange(n) / FPS
    data = 0.15 * np.sin(2 * np.pi * 0.3 * t)
    st = mon._measure_state
    mon._measure_state = st._replace(
        data=torch.from_numpy(data.astype(np.float32)),
        t=torch.from_numpy(t.astype(np.float32)),
        count=torch.tensor(n, dtype=st.count.dtype))
    mon.data.extend(data.tolist())
    mon.t.extend(t.tolist())


def _monitor_run(traced: bool):
    # One initialize step, the buffer, the locate step, the measured ones.
    clip = breathing_clip(num_frames=1 + CAL.buffer_length + 1 + MEASURED,
                          height=H, width=W, fps=FPS, bpm=18.0,
                          patch_center=(60, 80), patch_size=(30, 40),
                          amplitude=0.12, motion_px=1.0)
    mon = RespiratoryMonitor(
        capture_target="synthetic", save_all_data=False, visualize=None,
        motion_extraction_method="flow",
        config=MonitorConfig(calibration=CAL),
        capture=ArrayCapture(clip, fps=FPS), auto_run=False,
        sync_fps=False, device="cpu")
    if traced:
        bench.enable()
    states = []
    while mon.step():
        if mon.state == "measure" and not mon.data:
            _full_ring(mon)
        states.append(mon.state)
    bench.disable()
    out = {"states": states, "box": (mon.x, mon.y, mon.w, mon.h),
           "data": np.asarray(mon.data), "freq": list(mon.freq),
           "filtered": np.asarray(mon.filtered_data),
           "peaks": list(mon.peak_indices),
           "ring": [getattr(mon._measure_state, f).clone()
                    for f in ("data", "t", "count", "pts", "roi")]}
    return out, bench.snapshot()


def _fleet_run(traced: bool):
    cfg = MonitorConfig(motion_extraction_method="flow",
                        calibration=CalibrationConfig(
                            buffer_length=32, pyramid_levels=4,
                            skip_levels_at_top=1))
    clips = np.stack([breathing_clip(
        num_frames=36, height=60, width=80, fps=FPS, bpm=bpm,
        patch_center=(30, 40), patch_size=(16, 20), amplitude=0.25,
        noise=0.002, motion_px=1.5, texture_motion=True, seed=i)
        for i, bpm in enumerate((15.0, 18.0, 21.0))])
    mon = streams.MultiStreamMonitor(cfg, None, (60, 80), FPS,
                                     device="cpu")
    mon.calibrate(clips[:, :32])
    n = cfg.measure.buffer_length
    t = np.arange(n) / FPS
    rates = np.asarray([15.0, 18.0, 21.0])[:, None] / 60.0
    data = 0.15 * np.sin(2 * np.pi * rates * t[None])
    mon.states = mon.states._replace(
        data=torch.from_numpy(data.astype(np.float32)),
        t=torch.from_numpy(np.broadcast_to(t, data.shape)
                           .astype(np.float32).copy()),
        count=torch.full((3,), n, dtype=torch.int32))
    if traced:
        bench.enable()
    results = []
    for f in range(32, 36):
        r = mon.step(clips[:, f])
        results.append([r.samples, r.bpm, r.has_bpm, r.error])
    bench.disable()
    return results, bench.snapshot()


@pytest.fixture(scope="module")
def monitor_runs():
    bench.disable()
    bench.clear()
    off, _ = _monitor_run(False)
    on, snap = _monitor_run(True)
    bench.clear()
    return off, on, snap


@pytest.fixture(scope="module")
def fleet_runs():
    bench.disable()
    bench.clear()
    off, _ = _fleet_run(False)
    on, snap = _fleet_run(True)
    bench.clear()
    return off, on, snap


def _streaming_fleet_run(traced: bool):
    """Two drifting subjects through the fleet's streaming-ROI mode: a
    localize every second step, re-locks past 1 px of drift."""
    cfg = MonitorConfig(motion_extraction_method="flow", streaming_roi=True,
                        streaming_interval=2, streaming_drift_px=1.0,
                        calibration=CalibrationConfig(
                            buffer_length=16, pyramid_levels=4,
                            skip_levels_at_top=1))
    clips = np.stack([breathing_clip(
        num_frames=24, height=60, width=80, fps=FPS, bpm=37.5,
        patch_center=(20, 24), patch_size=(14, 18), amplitude=0.3,
        drift_px=d, noise=0.002, motion_px=1.5, texture_motion=True, seed=0)
        for d in ((14.0, 24.0), (12.0, 20.0))])
    mon = streams.MultiStreamMonitor(cfg, None, (60, 80), FPS,
                                     device="cpu")
    mon.calibrate(clips[:, :16])
    if traced:
        bench.enable()
    results = []
    for f in range(16, 24):
        r = mon.step(clips[:, f])
        results.append([r.samples, r.error, mon.states.roi])
    bench.disable()
    return (results, mon.relocks), bench.snapshot()


@pytest.fixture(scope="module")
def streaming_fleet_runs():
    bench.disable()
    bench.clear()
    off, _ = _streaming_fleet_run(False)
    on, snap = _streaming_fleet_run(True)
    bench.clear()
    return off, on, snap


def _tree(snap, root):
    """{span name: its parent's name} of the spans under the root span
    ``root`` (an id), and those spans."""
    by_id = {s["id"]: s for s in snap}
    mine = [s for s in snap if s["step"] == root]
    return ({s["name"]: by_id[s["parent"]]["name"] if s["parent"] else None
             for s in mine}, mine)


def _roots(snap, name):
    return [s for s in snap if s["name"] == name and s["parent"] is None]


def test_a_calibration_step_forms_its_tree(monitor_runs):
    _, _, snap = monitor_runs
    buffer_steps = [s for s in _roots(snap, "monitor.step")
                    if "monitor.buffer" in _tree(snap, s["id"])[0]]
    assert len(buffer_steps) == CAL.buffer_length
    assert _tree(snap, buffer_steps[0]["id"])[0] == {
        "monitor.step": None, "monitor.capture": "monitor.step",
        "monitor.buffer": "monitor.step"}
    located = [s for s in _roots(snap, "monitor.step")
               if "monitor.calibrate" in _tree(snap, s["id"])[0]]
    assert len(located) == 1
    tree, spans = _tree(snap, located[0]["id"])
    assert tree == {
        "monitor.step": None, "monitor.capture": "monitor.step",
        "monitor.calibrate": "monitor.step",
        "locate.pyramid": "monitor.calibrate",
        "locate.bandpass": "monitor.calibrate",
        "locate.collapse": "monitor.calibrate",
        "locate.ccl": "monitor.calibrate"}
    for s in spans:   # children inside their parents, on one clock
        if s["parent"] is not None:
            parent = next(p for p in spans if p["id"] == s["parent"])
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]


def test_a_measured_step_forms_its_tree(monitor_runs):
    _, _, snap = monitor_runs
    # The last step() finds the stream ended: a capture, nothing else.
    roots = _roots(snap, "monitor.step")
    ended = roots[-1]
    measured = [s for s in roots
                if "monitor.measure" in _tree(snap, s["id"])[0]]
    assert _tree(snap, ended["id"])[0] == {
        "monitor.step": None, "monitor.capture": "monitor.step"}
    assert len(measured) == MEASURED
    tree, spans = _tree(snap, measured[-1]["id"])
    assert tree == {
        "monitor.step": None, "monitor.capture": "monitor.step",
        "monitor.measure": "monitor.step",
        "monitor.ingest": "monitor.measure",
        "monitor.motion": "monitor.measure",
        "monitor.estimate": "monitor.measure",
        "bpm.filter": "monitor.estimate", "bpm.peaks": "monitor.estimate",
        "bpm.fit": "monitor.estimate", "bpm.lm_step": "bpm.fit",
        "monitor.host_read": "monitor.measure",
        "monitor.mirror": "monitor.measure"}
    fits = [s for s in spans if s["name"] == "bpm.fit"]
    assert len(fits) == 2   # the float32 fit and the float64 refit
    assert fits[0]["counts"]["steps"] > 0
    assert sum(f["counts"]["steps"] for f in fits) == \
        sum(s["name"] == "bpm.lm_step" for s in spans)


def test_a_fleet_step_forms_its_tree(fleet_runs):
    _, _, snap = fleet_runs
    roots = _roots(snap, "fleet.step")
    assert len(roots) == 4
    tree, spans = _tree(snap, roots[-1]["id"])
    assert tree == {
        "fleet.step": None, "fleet.ingest": "fleet.step",
        "fleet.motion": "fleet.step", "fleet.estimate": "fleet.step",
        "bpm.filter": "fleet.estimate", "bpm.peaks": "fleet.estimate",
        "bpm.fit": "fleet.estimate", "bpm.lm_step": "bpm.fit"}
    fit = next(s for s in spans if s["name"] == "bpm.fit")
    c = fit["counts"]
    assert c["lanes"] > 0 and c["steps"] > 0
    assert c["steps"] == sum(s["name"] == "bpm.lm_step" for s in spans)
    assert c["lanes"] <= c["live_lane_steps"] <= c["lanes"] * c["steps"]


def test_a_streaming_fleet_step_forms_its_tree(streaming_fleet_runs):
    _, (_, relocks), snap = streaming_fleet_runs
    roots = _roots(snap, "fleet.step")
    assert len(roots) == 8
    localized = relocked = 0
    for root in roots:
        tree, spans = _tree(snap, root["id"])
        absorb = next(x for x in spans if x["name"] == "fleet.absorb")
        assert absorb["counts"] == {"frames": 2}
        if "fleet.localize" not in tree:
            assert tree["fleet.absorb"] == "fleet.step"
            assert "fleet.relock" not in tree
            continue
        localized += 1
        # The localize holds its step's absorb and one connected-component
        # search of all its streams' masks, counting them and the sweeps.
        loc = next(x for x in spans if x["name"] == "fleet.localize")
        assert tree["fleet.localize"] == "fleet.step"
        assert tree["fleet.absorb"] == "fleet.localize"
        assert loc["counts"]["streams"] == 2
        assert 0 <= loc["counts"]["found"] <= 2
        ccls = [x for x in spans if x["name"] == "locate.ccl"]
        assert len(ccls) == 1 and ccls[0]["parent"] == loc["id"]
        assert ccls[0]["counts"]["images"] == 2
        assert ccls[0]["counts"]["sweeps"] >= 2
        for x in spans:
            if x["name"] == "fleet.relock":
                assert tree["fleet.relock"] == "fleet.step"
                assert x["start_ns"] >= loc["end_ns"]
                relocked += x["counts"]["relocked"]
    assert localized == 4
    assert relocked == relocks >= 1


def test_monitor_outputs_are_bit_identical_with_tracing_on(monitor_runs):
    off, on, _ = monitor_runs
    assert off["states"] == on["states"] and off["box"] == on["box"]
    assert off["states"][-1] == "measure" and off["freq"]
    np.testing.assert_array_equal(off["data"], on["data"])
    np.testing.assert_array_equal(off["filtered"], on["filtered"])
    assert off["freq"] == on["freq"] and off["peaks"] == on["peaks"]
    for a, b in zip(off["ring"], on["ring"]):
        assert torch.equal(a, b)


def test_fleet_outputs_are_bit_identical_with_tracing_on(fleet_runs):
    off, on, _ = fleet_runs
    assert bool(off[-1][2].any())   # the steps estimate BPMs
    for a_step, b_step in zip(off, on):
        for a, b in zip(a_step, b_step):
            assert torch.equal(a, b)


def test_streaming_fleet_outputs_are_bit_identical_with_tracing_on(
        streaming_fleet_runs):
    (off, relocks_off), (on, relocks_on), _ = streaming_fleet_runs
    assert relocks_off == relocks_on
    for a_step, b_step in zip(off, on):
        for a, b in zip(a_step, b_step):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The counts against replays of the loops
# ---------------------------------------------------------------------------

def _windows(dtype=torch.float32):
    """Noisy Gaussian windows of a few widths, and one lane with two valid
    points (it starts done)."""
    g = torch.Generator().manual_seed(3)
    t = torch.arange(12, dtype=dtype).repeat(6, 1) * 0.1
    center = torch.linspace(0.3, 0.8, 6, dtype=dtype)[:, None]
    y = torch.exp(-(t - center) ** 2 / (2 * 0.15 ** 2)) \
        + 0.05 * torch.randn(t.shape, generator=g, dtype=dtype)
    mask = torch.ones(t.shape, dtype=torch.bool)
    mask[4, 2:] = False
    mask[5, 9:] = False
    return t, y, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fit_counts_equal_a_replay_of_the_loop(dtype):
    t, y, mask = _windows(dtype)
    bench.enable()
    fit = gaussfit.gaussian_fit_batch(t, y, mask)
    bench.disable()
    (rec,) = [s for s in bench.snapshot() if s["name"] == "bpm.fit"]
    # Replay: the loop after k iterations is the fit with iters=k; a lane
    # that can converge is live until it has converged.
    can = mask.sum(-1) >= 3
    live = []
    for k in range(201):
        done = gaussfit.gaussian_fit_batch(t, y, mask, iters=k).converged
        live.append(int((can & ~done).sum()))
        if live[-1] == 0:
            break
    steps = len(live) - 1
    assert rec["counts"] == {
        "lanes": live[0], "steps": steps,
        "live_lane_steps": sum(live[:steps])}
    assert live[0] == 5 and steps > 1 and bool(fit.converged[can].all())
    bench.clear()
    bench.enable()
    gaussfit.gaussian_fit_batch(t, y, mask, iters=2)
    (rec,) = bench.snapshot()[-1:]
    assert rec["counts"] == {"lanes": live[0], "steps": 2,
                             "live_lane_steps": live[0] + live[1]}


def test_a_cpu_fit_takes_the_plain_loop():
    # The kernel is for CUDA tensors: on the CPU no launch, and one
    # bpm.lm_step span an iteration inside the bpm.fit span.
    t, y, mask = _windows()
    before = dict(_build.LAUNCHES)
    bench.enable()
    gaussfit.gaussian_fit_batch(t, y, mask)
    bench.disable()
    snap = bench.snapshot()
    fit = [s for s in snap if s["name"] == "bpm.fit"]
    steps = [s for s in snap if s["name"] == "bpm.lm_step"]
    assert _build.LAUNCHES == before
    assert len(fit) == 1 and len(steps) == fit[0]["counts"]["steps"] > 1
    assert all(s["parent"] == fit[0]["id"] for s in steps)


def _replay_sweeps(val, fg, big, neighbor):
    """Sweeps of ccl's fixed-point loop, replayed."""
    n = 0
    while True:
        new = torch.where(fg, neighbor(val, big), torch.full_like(val, big))
        new = ccl._segmented_min_scan(new, fg, 1, big)
        new = ccl._segmented_min_scan(new, fg, 0, big)
        n += 1
        if torch.equal(new, val):
            return new, n
        val = new


def test_ccl_sweeps_equal_a_replay_of_the_loops():
    g = torch.Generator().manual_seed(5)
    fg = torch.rand((40, 50), generator=g) > 0.55
    fg[10:30, 20] = True   # a long run and a ring with a hole
    fg[5:12, 5:12] = True
    fg[7:10, 7:10] = False
    bench.enable()
    box = ccl.largest_component_bbox(fg)
    bench.disable()
    (rec,) = bench.snapshot()
    bg = ~fg
    border = torch.zeros_like(bg)
    border[[0, -1], :] = True
    border[:, [0, -1]] = True
    val = torch.where(bg, torch.where(border, 0, 1), 2).to(torch.int32)
    out, n_out = _replay_sweeps(val, bg, 2, ccl._neighbor_min4)
    filled = fg | ~(bg & (out == 0))
    big = fg.numel()
    idx = torch.arange(big, dtype=torch.int32).reshape(fg.shape)
    _, n_lab = _replay_sweeps(torch.where(filled, idx, big), filled, big,
                              ccl._neighbor_min)
    assert rec["name"] == "locate.ccl"
    assert rec["counts"] == {"sweeps": n_out + n_lab, "images": 1}
    assert n_lab > 1
    assert bool(box.found)


def test_ccl_results_are_the_same_with_tracing_on():
    g = torch.Generator().manual_seed(7)
    fg = torch.rand((30, 40), generator=g) > 0.5
    fg[4:12, 4:12] = True
    fg[6:9, 6:9] = False
    off = ccl.largest_component_bbox(fg)
    bench.enable()
    on = ccl.largest_component_bbox(fg)
    bench.disable()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    # The public pieces are the counted ones without their counts.
    filled, _ = ccl._fill_holes(fg)
    assert torch.equal(ccl.fill_holes(fg), filled)
    assert bool(filled[7, 7]) and not bool(fg[7, 7])   # the hole is filled
    assert torch.equal(ccl.outside_mask(~fg), ccl._outside_mask(~fg)[0])
    assert torch.equal(ccl.label_components(filled),
                       ccl._label_components(filled)[0])


# ---------------------------------------------------------------------------
# The benchmark's readers of the spans
# ---------------------------------------------------------------------------

def _span(i, name, parent=None, step=None, **counts):
    return {"name": name, "id": i, "parent": parent,
            "step": step or i, "start_ns": i, "end_ns": i + 1,
            "counts": counts}


def _fit(i, parent, step, lanes, steps, live):
    return _span(i, "bpm.fit", parent, step, lanes=lanes, steps=steps,
                 live_lane_steps=live)


HAND_SNAPSHOT = [
    # Two single-monitor estimates: 12 + 3 and 20 LM steps.
    _fit(3, 2, 1, 4, 12, 30), _fit(4, 2, 1, 1, 3, 3),
    _span(2, "monitor.estimate", 1, 1), _span(1, "monitor.step"),
    _fit(7, 6, 5, 5, 20, 60), _span(6, "monitor.estimate", 5, 5),
    _span(5, "monitor.step"),
    # Two fleet estimates: 40 and 50 steps; lanes x steps 400 and 1000.
    _fit(12, 11, 10, 10, 40, 100), _span(11, "fleet.estimate", 10, 10),
    _span(10, "fleet.step"),
    _fit(15, 14, 13, 20, 50, 300), _span(14, "fleet.estimate", 13, 13),
    _span(13, "fleet.step"),
    # A fit under no estimate, and three calibrations' CCLs.
    _fit(16, None, None, 9, 9, 81),
    _span(17, "locate.ccl", sweeps=4), _span(18, "locate.ccl", sweeps=6),
    _span(19, "locate.ccl", sweeps=11),
]

HAND_PROFILE = {"busy_s": 0.5, "window_s": 10.0, "kernels_s": {},
                "idle_s": {"bpm.lm_step": 6.0, "bpm.fit": 1.5,
                           "estimate": 0.5, "monitor.step": 0.25,
                           "monitor.capture": 0.05, "monitor.mirror": 0.2,
                           "locate": 0.4, "host": 0.6}}

EXPECTED = {"lm_steps.cam": (15 + 20) / 2, "lm_steps.fleet": (40 + 50) / 2,
            "lm_lane_use_pct.fleet": 100.0 * 400 / 1400,
            "ccl_sweeps.locate": 7.0, "fit_idle_pct.cam": 75.0,
            "fit_idle_pct.fleet": 75.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_the_hand_built_spans(name, monkeypatch):
    monkeypatch.setattr(bench, "snapshot", lambda: HAND_SNAPSHOT)
    trace = type("Trace", (), {"profile": HAND_PROFILE})()
    read = cells.metric_reader(name)
    assert read(trace) == pytest.approx(EXPECTED[name], rel=1e-12)
    # A program without the spans (the ring empty, or no ring at all, as
    # before the spans existed) and a trace without their labels read
    # nothing, and raise nothing.
    monkeypatch.setattr(bench, "snapshot", lambda: [])
    empty = type("Trace", (), {"profile": dict(
        HAND_PROFILE, idle_s={"estimate": 9.0, "host": 0.5})})()
    assert read(empty) is None
    monkeypatch.delattr(bench, "snapshot")
    assert read(empty) is None


def test_every_metric_of_the_spans_is_in_the_benchmark():
    spec = cells.benchmark_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECTED:
        assert entries[name]["source"] == "program_span"
        (cell,) = entries[name]["workloads"]
        assert entries[name] in cells.cell(cell)["per_layer"]


def _at(i, name, parent, step, start_ms, end_ms, **counts):
    return {"name": name, "id": i, "parent": parent, "step": step,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "counts": counts}


STREAMING_SNAPSHOT = [
    # A step that only absorbs.
    _at(2, "fleet.absorb", 1, 1, 0.0, 1.0, frames=64),
    _at(1, "fleet.step", None, 1, 0.0, 100.0),
    # A localize of 900 ms holding a 10 ms absorb and CCLs of 3 + 5
    # sweeps, then its re-lock.
    _at(5, "fleet.absorb", 4, 3, 100.0, 110.0, frames=64),
    _at(6, "locate.ccl", 4, 3, 200.0, 300.0, sweeps=3),
    _at(7, "locate.ccl", 4, 3, 300.0, 400.0, sweeps=5),
    _at(4, "fleet.localize", 3, 3, 100.0, 1000.0, streams=64, found=64),
    _at(8, "fleet.relock", 3, 3, 1000.0, 1002.0, relocked=5),
    _at(3, "fleet.step", None, 3, 0.0, 1100.0),
    # A localize of 600 ms holding a 20 ms absorb and CCLs of 4 + 6 sweeps.
    _at(11, "fleet.absorb", 10, 9, 2000.0, 2020.0, frames=64),
    _at(12, "locate.ccl", 10, 9, 2100.0, 2200.0, sweeps=4),
    _at(13, "locate.ccl", 10, 9, 2200.0, 2300.0, sweeps=6),
    _at(10, "fleet.localize", 9, 9, 2000.0, 2600.0, streams=64, found=63),
    _at(9, "fleet.step", None, 9, 1900.0, 2700.0),
    # A calibration's CCL, under no localize.
    _at(14, "locate.ccl", None, 14, 3000.0, 3100.0, sweeps=11),
]

K1_RUN = SimpleNamespace(frame_hw=(1080, 1920), cfg=SimpleNamespace(
    calibration=SimpleNamespace(pyramid_levels=9, skip_levels_at_top=4)))
K1_KERNELS = {"pyr_down_levels_d1_f32": 0.9e-3, "pyr_tail_f32": 0.6e-3,
              "gauss_fit_kernel<float>": 2.0e-3}
STREAMING_EXPECTED = {
    "localize_ms.fleet": ((900.0 - 10.0) + (600.0 - 20.0)) / 2,
    "ccl_reads.localize": ((3 + 5) + (4 + 6)) / 2,
    "k1_roofline_pct.absorb": 100.0 * 3 * timing.k1_bound(
        64, 1080, 1920, 9, 4)["bound_ms"] * 1e-3 / 1.5e-3}


def _k1_trace(kernels_s):
    return SimpleNamespace(profile={"kernels_s": kernels_s}, run=K1_RUN,
                           bound=timing.k1_bound,
                           k1_seconds=timing.k1_seconds)


@pytest.mark.parametrize("name", sorted(STREAMING_EXPECTED))
def test_streaming_metric_reads_the_hand_built_spans(name, monkeypatch):
    monkeypatch.setattr(bench, "snapshot", lambda: STREAMING_SNAPSHOT)
    read = cells.metric_reader(name)
    assert read(_k1_trace(K1_KERNELS)) == pytest.approx(
        STREAMING_EXPECTED[name], rel=1e-12)
    # The parent program (no such spans, or no ring) reads nothing and
    # raises nothing; nor does a stretch that ran no K1 kernel.
    monkeypatch.setattr(bench, "snapshot", lambda: HAND_SNAPSHOT)
    assert read(_k1_trace(K1_KERNELS)) is None
    monkeypatch.delattr(bench, "snapshot")
    assert read(_k1_trace(K1_KERNELS)) is None
    if name.startswith("k1_"):
        monkeypatch.setattr(bench, "snapshot", lambda: STREAMING_SNAPSHOT,
                            raising=False)
        assert read(_k1_trace({"gauss_fit_kernel<float>": 1.0})) is None


def test_every_streaming_metric_is_in_the_drift_cell():
    spec = cells.benchmark_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    reported = cells.cell("fleet64_1080p_roi.drift")["per_layer"]
    for name in STREAMING_EXPECTED:
        assert entries[name]["workloads"] == ["fleet64_1080p_roi.drift"]
        assert entries[name]["moves"] == "stream_frames_per_s"
        assert entries[name] in reported
    assert {m["name"] for m in reported} == set(STREAMING_EXPECTED)
