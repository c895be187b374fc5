"""The re-locking fleet's cell (``fleet64_1080p_roi.drift``, traffic kind
``drift``) on the CPU at a small size: the drift generator, the plain
reference of the coarse localize and of the re-lock against the program,
a small run that comes out correct, and each fault of the streaming path
failing the check."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import cells
from benchmark.harness import frames as gen
from benchmark.kinds import drift
from benchmark.reference import config as rconfig
from benchmark.reference import streaming as ref_streaming
from benchmark.reference import system as ref
from benchmark.tests.conftest import small
from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.parallel import streams
from respmon_tpu_torch.pipeline import motion, streaming

NAME = "fleet64_1080p_roi.drift"
STREAMS = 4
# At 120x160 the coarse localize works at level 2 (boxes scaled by 4): a
# drift of (6, 12) px from peak to peak in 24 frames moves the subjects'
# centres past the 4 px threshold in most intervals.
DRIFT = {"drift_peak_px": [6, 12], "drift_half_period": 24,
         "checks": {"calibrations": 3, "steps": 3, "relocked_steps": 2,
                    "localizes": 2, "localize_streams": 2}}
# The window of a correct run holds two localize intervals or more (a CPU
# step of the small fleet takes ~0.7 s); a faulty run needs less.
SECONDS, FAULT_SECONDS = 10.0, 3.0


def small_drift():
    sizes, traffic = small(NAME, streams=STREAMS)
    traffic.update(DRIFT)
    return sizes, traffic


def run_drift(seed: int = 11, device="cpu", seconds: float = SECONDS):
    sizes, traffic = small_drift()
    return cells.execute(NAME, seed, seconds, False, device, time.time(),
                         sizes=sizes, traffic=traffic)


def _wrong(out) -> dict:
    assert out["correct"] is False
    return {k: v["value"] for k, v in out["checks"].items()
            if v["limit"] is None or v["value"] > v["limit"]}


def _frames(seed: int, streams_n: int = STREAMS):
    """The generator of a small drift run, without the run."""
    sizes, traffic = small_drift()
    t = dict(cells.cell(NAME)["traffic_data"])
    t.update(traffic)
    run = SimpleNamespace(traffic=t, streams=streams_n, seed=seed,
                          device=torch.device("cpu"),
                          frame_hw=tuple(sizes["frame_hw"]),
                          fps=float(sizes["fps"]))
    return drift.DriftFrames(run), sizes


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def test_drift_frames_are_seeded_and_share_the_content():
    a, _ = _frames(4_294_967_311)
    a2, _ = _frames(4_294_967_311)
    b, _ = _frames(12)
    for k in (-64, -1, 0, 17, 40):
        assert torch.equal(a.device_frames(k), a2.device_frames(k))
    # Another run seed orders the same streams otherwise.
    key = sorted(zip(a.clip_of, a.phase0, map(tuple, a.signs), a.start))
    assert key == sorted(zip(b.clip_of, b.phase0, map(tuple, b.signs),
                             b.start))
    frame = a.device_frames(5)
    assert frame.dtype == torch.uint8 and int(frame.max()) <= 250


def test_drift_path_stands_still_then_stays_within_its_peaks():
    src, _ = _frames(3)
    s = np.arange(STREAMS)
    for k in range(-64, 0):
        dy, dx = src.offset(s, np.full(STREAMS, k))
        assert not dy.any() and not dx.any()
    ticks = np.arange(0, 200)
    for i in s:
        dy, dx = src.offset(np.full(len(ticks), i), ticks)
        assert np.abs(dy).max() == DRIFT["drift_peak_px"][0]
        assert np.abs(dx).max() == DRIFT["drift_peak_px"][1]
        # Whole pixels, at most one peak-to-peak in a half period.
        assert np.abs(np.diff(dx)).max() <= 1
        assert (dy[:src.start[i] + 1] == 0).all()
    # Standing, a stream shows the steady kind's frames of its subject
    # (the same draws; the sums in another order, so within one level).
    sizes, traffic = small_drift()
    t = dict(cells.cell(NAME)["traffic_data"], **traffic)
    subj = gen.subjects(t, 3, tuple(sizes["frame_hw"]), 10.0)
    pools = gen.make_pools(subj, t, tuple(sizes["frame_hw"]), 3, "cpu")
    for i in s:
        k = src.clip_of[i]
        idx = (src.phase0[i] + np.arange(-8, 0)) % src.periods[k]
        diff = (src.history(i, -1, 8).to(torch.int32)
                - pools[k][torch.from_numpy(idx)].to(torch.int32)).abs()
        assert int(diff.max()) <= 1
    moved = src.make([0], [int(src.start[0]) + 6])[0]
    assert not torch.equal(src.history(0, -1, 1)[0], moved)


# ---------------------------------------------------------------------------
# The plain reference against the program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_reference_localize_equals_localize_batch(seed):
    src, sizes = _frames(seed)
    c = sizes["monitor"]["calibration"]
    cal = CalibrationConfig(**dict(c, maximum_bounding_box_area=float(
        c["maximum_bounding_box_area"])))
    rcal = rconfig.CalibrationConfig(**dict(c, maximum_bounding_box_area=float(
        c["maximum_bounding_box_area"])))
    t_len, hw, fps = cal.buffer_length, tuple(sizes["frame_hw"]), 10.0
    buffers = torch.stack([src.history(s, -1, t_len)
                           for s in range(STREAMS)])
    rings = streams.init_fleet_streaming_from_buffers(buffers, cal)
    # The rings as the fleet keeps them: warm-started, then absorbed.
    for k in range(24):
        rings = streaming.streaming_absorb_batch(rings, src.device_frames(k),
                                                 cal)
        if k % 8 != 7:
            continue
        loc = streaming.localize_batch(rings, hw, torch.float32, fps, cal,
                                       coarse=True)
        for s in range(STREAMS):
            want, heat = ref_streaming.localize(src.history(s, k, t_len),
                                                fps, rcal)
            got = (bool(loc.found[s]), int(loc.x[s]), int(loc.y[s]),
                   int(loc.w[s]), int(loc.h[s]))
            assert want[0]
            assert got == want, (k, s)
            assert torch.equal(loc.heatmap_u8[s], heat), (k, s)


def _fleet(interval=2, drift_px=2.0):
    cfg = MonitorConfig(
        motion_extraction_method="flow", streaming_roi=True,
        streaming_interval=interval, streaming_drift_px=drift_px,
        calibration=CalibrationConfig(buffer_length=32, pyramid_levels=4,
                                      skip_levels_at_top=1))
    return streams.MultiStreamMonitor(cfg, None, (120, 160), 10.0,
                                      device="cpu")


def test_reference_relock_rule_equals_the_fleets():
    rng = np.random.default_rng(0)
    mon = _fleet()
    for _ in range(50):
        s = 6
        rois = np.stack([rng.integers(0, 120, s), rng.integers(0, 80, s),
                         rng.integers(8, 40, s), rng.integers(8, 40, s)],
                        axis=1).astype(np.int32)
        boxes = np.stack([rng.integers(0, 2, s), rng.integers(-4, 150, s),
                          rng.integers(-4, 110, s), rng.integers(1, 60, s),
                          rng.integers(1, 60, s)]).astype(np.int64)
        mon._rois = rois.copy()
        moved = {}

        def fake_relock(states, frames, new_rois, apply, spec):
            moved["apply"], moved["rois"] = np.asarray(apply), \
                np.asarray(new_rois)
            return states
        mon.spec = motion.MeasureSpec.for_roi(mon.cfg, 120, 160, 40, 40,
                                              10.0)
        mon._states = streams.init_stream_states(mon.spec, rois,
                                                 device="cpu")
        real = streams.relock_streams
        streams.relock_streams = fake_relock
        try:
            mon._maybe_relock(boxes, torch.zeros((s, 120, 160)))
        finally:
            streams.relock_streams = real
        apply, want = ref_streaming.relock_rule(boxes, rois, 2.0, (120, 160))
        np.testing.assert_array_equal(mon._rois, want)
        if apply.any():
            np.testing.assert_array_equal(moved["apply"], apply)
            np.testing.assert_array_equal(moved["rois"][apply], want[apply])
        else:
            assert not moved


def test_reference_relock_equals_relock_streams():
    mon = _fleet()
    spec = motion.MeasureSpec.for_roi(mon.cfg, 120, 160, 30, 30, 10.0)
    g = torch.Generator().manual_seed(5)
    rois = torch.tensor([[10, 10, 30, 30], [60, 40, 30, 30],
                         [100, 70, 30, 30], [5, 80, 30, 30]],
                        dtype=torch.int32)
    state = streams.init_stream_states(spec, rois.numpy(), device="cpu")
    state = state._replace(
        pts=torch.rand((4, 100, 2), generator=g) * 31.0,
        pts_valid=torch.rand((4, 100), generator=g) > 0.3,
        initialized=torch.ones(4, dtype=torch.bool))
    new = rois + torch.tensor([[40, 0, 0, 0], [3, -2, 0, 0],
                               [-7, 5, 0, 0], [0, 0, 0, 0]],
                              dtype=torch.int32)
    apply = torch.tensor([True, True, True, False])
    frames = torch.randint(0, 250, (4, 120, 160), generator=g,
                           dtype=torch.uint8)
    got = streams.relock_streams(state, frames, new, apply, spec)
    rspec = ref.FlowSpec(frame_h=120, frame_w=160, crop_h=spec.crop_h,
                         crop_w=spec.crop_w, buffer_length=128)
    fields = ref.FlowState(roi=state.roi, initialized=state.initialized,
                           pts=state.pts, pts_valid=state.pts_valid,
                           motion_xy=state.motion_xy,
                           motion_count=state.motion_count)
    want = ref_streaming.relock(fields, new, apply, rspec)
    for f in ref.FlowState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # Stream 0 moved 40 px, past its 32 px window: no point is left.
    assert not bool(want.initialized[0]) and bool(want.initialized[1])


# ---------------------------------------------------------------------------
# A small run, and its faults
# ---------------------------------------------------------------------------

def test_small_drift_run_is_correct():
    out, run = run_drift()
    assert out["correct"], out["checks"]
    window = [lc for lc in run.localizes if lc.tick >= run.window[0]]
    assert len(window) >= 2 and sum(lc.relocked() for lc in window) >= 1
    # The window runs whole localize intervals.
    assert (len(run.steps) - run.window[0]) % run.cfg.streaming_interval == 0
    assert set(out["metrics"]) == {"stream_frames_per_s", "setup_s"}


def test_skipped_localize_fails(monkeypatch):
    real = streams.MultiStreamMonitor._streaming_step

    def broken(self, dev):
        if self._streaming is not None and self._stream_tick + 1 == 24:
            self._stream_tick += 1
            self._streaming = streams.absorb_streams(
                self._streaming, dev, self.cfg.calibration)
            return
        real(self, dev)
    monkeypatch.setattr(streams.MultiStreamMonitor, "_streaming_step",
                        broken)
    out, _ = run_drift(seconds=FAULT_SECONDS)
    assert "localize_faults" in _wrong(out)


def test_box_moved_16_px_fails(monkeypatch):
    real = streaming.localize_batch

    def broken(*args, **kwargs):
        loc = real(*args, **kwargs)
        return loc._replace(x=loc.x + 16)
    monkeypatch.setattr(streaming, "localize_batch", broken)
    out, _ = run_drift(seconds=FAULT_SECONDS)
    assert "localize_box_px" in _wrong(out)


def test_relock_not_applied_fails(monkeypatch):
    def broken(states, frames, new_rois, apply, spec):
        return states
    monkeypatch.setattr(streams, "relock_streams", broken)
    out, _ = run_drift(seconds=FAULT_SECONDS)
    assert "relock_faults" in _wrong(out)


def test_ring_not_absorbed_fails(monkeypatch):
    def broken(state, frames, cfg):
        return state
    monkeypatch.setattr(streaming, "streaming_absorb_batch", broken)
    out, _ = run_drift(seconds=FAULT_SECONDS)
    assert {"localize_box_px", "localize_heat_px"} & set(_wrong(out))
