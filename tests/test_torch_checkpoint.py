"""Port parity: checkpoint / resume (``runtime/checkpoint.py``) of the live
monitor and of the fleet, against the uninterrupted run and across the two
packages.

- A resumed port monitor (average mode, and flow mode in float64) repeats
  the uninterrupted one's state trace, ROI, signal and BPM bit for bit
  (the counterpart of ``tests/test_streaming_checkpoint_faults.py``'s
  resume test).
- A file the JAX monitor or fleet saved resumes in the port to what the
  JAX package computes; a file the port saved loads in the JAX package to
  the same state.  The tolerances are the parity tests' (average mode,
  float32): samples to atol 1e-5, BPM to rtol 1e-5, all else equal.
- The fleet round trip in flow mode with 8 streams (the counterpart of
  the JAX fleet test): samples equal bit for bit after the restore, also
  when the file is restored onto a 2-rank gloo mesh, and when that mesh
  saves it again.
- Neither package's file holds the streaming-ROI rings: a resumed
  streaming monitor or fleet neither absorbs nor re-locks until it
  calibrates again, in both packages.

The configs are the port's; the JAX side gets the same values
(``_jax_config``).  JAX is imported inside the tests only: the spawned
ranks of the mesh restore import this module and load no JAX.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io.capture import ArrayCapture
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.parallel import streams as tstreams
from respmon_tpu_torch.parallel.launch import run_ranks
from respmon_tpu_torch.parallel.mesh import make_mesh
from respmon_tpu_torch.runtime import RespiratoryMonitor
from respmon_tpu_torch.runtime import checkpoint

torch.set_num_threads(1)

FPS = 10.0
H, W = 60, 80
CAL = CalibrationConfig(buffer_length=32, pyramid_levels=4,
                        skip_levels_at_top=1)
N_FRAMES = 32 + 1 + 70
SPLIT = 32 + 1 + 30
BPM_RTOL = 1e-5
SAMPLE_ATOL = 1e-5


def _clip(num_frames, motion_px=0.0, dtype=np.float32, bpm=18.0, seed=0):
    return breathing_clip(num_frames=num_frames, height=H, width=W, fps=FPS,
                          bpm=bpm, patch_center=(30, 40), patch_size=(16, 20),
                          amplitude=0.25, noise=0.002, motion_px=motion_px,
                          texture_motion=motion_px > 0, seed=seed,
                          dtype=dtype)


def _jax_config(cfg):
    """The JAX package's config dataclass of the same name and values
    (``interop.config_from_reference`` the other way round)."""
    from respmon_tpu import config as jconfig

    return getattr(jconfig, type(cfg).__name__)(**{
        f.name: _jax_config(getattr(cfg, f.name))
        if dataclasses.is_dataclass(getattr(cfg, f.name))
        else getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _monitor(frames, method, cfg, **kw):
    return RespiratoryMonitor(
        capture_target="ckpt", save_all_data=False, visualize=None,
        motion_extraction_method=method, config=cfg,
        capture=ArrayCapture(frames, fps=FPS), auto_run=False,
        sync_fps=False, device="cpu", **kw)


def _jax_monitor(frames, method, cfg, **kw):
    from respmon_tpu.io.capture import ArrayCapture as JArrayCapture
    from respmon_tpu.runtime import RespiratoryMonitor as JMonitor

    return JMonitor(
        capture_target="ckpt", save_all_data=False, visualize=None,
        motion_extraction_method=method, config=_jax_config(cfg),
        capture=JArrayCapture(frames, fps=FPS), auto_run=False,
        sync_fps=False, **kw)


def _jax_fleet(cfg):
    from respmon_tpu.parallel import streams as jstreams

    return jstreams.MultiStreamMonitor(_jax_config(cfg), None, (H, W), FPS)


def _drive(mon):
    """Step to the end of the capture; after each step the state, ROI,
    BPM count and newest sample and BPM."""
    trace = []
    while mon.cap.is_open():
        if not mon.step():
            break
        trace.append((mon.state, (mon.x, mon.y, mon.w, mon.h),
                      len(mon.freq), mon.data[-1] if mon.data else None,
                      mon.freq[-1] if mon.freq else None))
    return trace


MODES = {"average_f32": ("average", 0.0, np.float32, torch.float32),
         "flow_f64": ("flow", 2.0, np.float64, torch.float64)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resumed_monitor_continues_bit_for_bit(tmp_path, mode):
    method, motion_px, np_dtype, dtype = MODES[mode]
    cfg = MonitorConfig(calibration=CAL)
    clip = _clip(N_FRAMES, motion_px, np_dtype)
    whole = _monitor(clip, method, cfg, compute_dtype=dtype)
    want = _drive(whole)

    first = _monitor(clip[:SPLIT], method, cfg, compute_dtype=dtype)
    head = _drive(first)
    assert first.state == "measure"
    path = str(tmp_path / "monitor.npz")
    checkpoint.save_checkpoint(path, first)

    resumed = _monitor(clip[SPLIT:], method, cfg, compute_dtype=dtype)
    checkpoint.load_checkpoint(path, resumed)
    assert resumed.state == "measure"
    assert (resumed.x, resumed.y, resumed.w, resumed.h) == \
        (first.x, first.y, first.w, first.h)
    assert checkpoint.checkpoint_roundtrip_equal(first._measure_state,
                                                 resumed._measure_state)
    assert resumed._measure_state.data.device == resumed.device
    got = _drive(resumed)
    assert head + got == want
    assert list(resumed.data) == list(whole.data)
    assert list(resumed.freq) == list(whole.freq)
    assert len(whole.freq) > 0


def _assert_traces_close(got, want):
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[3], w[3], atol=SAMPLE_ATOL)
        if w[4] is not None:
            np.testing.assert_allclose(g[4], w[4], rtol=BPM_RTOL)


def test_monitor_files_cross_between_the_packages(tmp_path):
    from respmon_tpu.runtime import checkpoint as jcheckpoint

    cfg = MonitorConfig(calibration=CAL)
    clip = _clip(N_FRAMES)
    jfirst = _jax_monitor(clip[:SPLIT], "average", cfg)
    _drive(jfirst)
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(jpath, jfirst)

    jresumed = _jax_monitor(clip[SPLIT:], "average", cfg)
    jcheckpoint.load_checkpoint(jpath, jresumed)
    want = _drive(jresumed)
    resumed = _monitor(clip[SPLIT:], "average", cfg)
    checkpoint.load_checkpoint(jpath, resumed)
    assert checkpoint.checkpoint_roundtrip_equal(jfirst._measure_state,
                                                 resumed._measure_state)
    got = _drive(resumed)
    _assert_traces_close(got, want)
    assert len(resumed.freq) == len(jresumed.freq) > 0

    # The port's file, saved at the end, loads in the JAX package.
    tpath = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(tpath, resumed)
    jback = _jax_monitor(clip[:1], "average", cfg)
    jcheckpoint.load_checkpoint(tpath, jback)
    assert jback.state == "measure"
    assert (jback.x, jback.y, jback.w, jback.h) == \
        (resumed.x, resumed.y, resumed.w, resumed.h)
    assert list(jback.data) == list(resumed.data)
    assert list(jback.freq) == list(resumed.freq)
    assert checkpoint.checkpoint_roundtrip_equal(jback._measure_state,
                                                 resumed._measure_state)


# ---------------------------------------------------------------------------
# The fleet.
# ---------------------------------------------------------------------------

FLOW_CFG = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
FLEET_S = 8


def _fleet_clips(s=FLEET_S, num_frames=80, method="flow"):
    """tests/test_streaming_checkpoint_faults.py's fleet clips."""
    return np.stack([
        breathing_clip(num_frames=num_frames, height=H, width=W, fps=FPS,
                       bpm=18.0 + i, patch_center=(30, 40),
                       patch_size=(16, 20), amplitude=0.25, noise=0.002,
                       motion_px=1.5 if method == "flow" else 0.0,
                       texture_motion=method == "flow", seed=i)
        for i in range(s)])


def _fleet(cfg, mesh=None, device="cpu"):
    return tstreams.MultiStreamMonitor(cfg, mesh, (H, W), FPS,
                                       device=device)


def _rows(fleet, clips, frames):
    rows = []
    for f in frames:
        r = fleet.step(clips[:, f])
        rows.append(np.stack([r.samples.double().numpy(),
                              r.bpm.double().numpy(),
                              r.has_bpm.double().numpy()]))
    return np.stack(rows)


def resume_on_mesh_rank(device, path, out_path):
    """Restore the fleet file onto a mesh over every rank, step it over
    frames 50..59 and save it again from the mesh.  Returns the rows and
    what the rank loaded of JAX and the JAX package."""
    mesh = make_mesh(axis_names=("streams",), device=device)
    fleet = _fleet(FLOW_CFG, mesh, device)
    checkpoint.load_fleet_checkpoint(path, fleet)
    rows = _rows(fleet, _fleet_clips(), range(50, 60))
    checkpoint.save_fleet_checkpoint(out_path, fleet)
    return rows, sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "respmon_tpu"))


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """The 8-stream flow fleet: calibrated on frames 0..31, stepped over
    33..49, saved, and stepped on over 50..59 uninterrupted."""
    clips = _fleet_clips()
    fleet = _fleet(FLOW_CFG)
    fleet.calibrate(clips[:, :32])
    _rows(fleet, clips, range(33, 50))
    path = str(tmp_path_factory.mktemp("fleet") / "fleet.npz")
    checkpoint.save_fleet_checkpoint(path, fleet)
    saved = [f.clone() for f in fleet.states]
    rows = _rows(fleet, clips, range(50, 60))
    return {"path": path, "saved": saved, "rows": rows,
            "final": fleet.states, "clips": clips}


def test_fleet_checkpoint_roundtrip(fleet_run):
    resumed = _fleet(FLOW_CFG)
    checkpoint.load_fleet_checkpoint(fleet_run["path"], resumed)
    assert checkpoint.checkpoint_roundtrip_equal(
        type(resumed.states)(*fleet_run["saved"]), resumed.states)
    assert resumed._cache is None
    assert resumed.states.data.device == resumed.device
    got = _rows(resumed, fleet_run["clips"], range(50, 60))
    np.testing.assert_array_equal(got, fleet_run["rows"])


def test_fleet_checkpoint_restores_onto_a_mesh(fleet_run, tmp_path):
    out_path = str(tmp_path / "from_mesh.npz")
    per_rank = run_ranks(resume_on_mesh_rank, 2,
                         args=(fleet_run["path"], out_path))
    for rows, jax_modules in per_rank:
        np.testing.assert_array_equal(rows, fleet_run["rows"])
        assert jax_modules == []
    # What the mesh saved is the uninterrupted fleet's final state.
    back = _fleet(FLOW_CFG)
    checkpoint.load_fleet_checkpoint(out_path, back)
    assert checkpoint.checkpoint_roundtrip_equal(fleet_run["final"],
                                                 back.states)


def test_fleet_files_cross_between_the_packages(tmp_path):
    from respmon_tpu.runtime import checkpoint as jcheckpoint

    cfg = MonitorConfig(calibration=CAL)
    clips = _fleet_clips(2, 60, method="average")
    jfleet = _jax_fleet(cfg)
    jfleet.calibrate(clips[:, :32])
    for f in range(33, 45):
        jfleet.step(clips[:, f])
    jpath = str(tmp_path / "jax_fleet.npz")
    jcheckpoint.save_fleet_checkpoint(jpath, jfleet)
    want = []
    for f in range(45, 55):
        r = jfleet.step(clips[:, f])
        want.append(np.stack([np.asarray(r.samples, np.float64),
                              np.asarray(r.bpm, np.float64),
                              np.asarray(r.has_bpm, np.float64)]))
    want = np.stack(want)

    fleet = _fleet(cfg)
    checkpoint.load_fleet_checkpoint(jpath, fleet)
    got = _rows(fleet, clips, range(45, 55))
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=SAMPLE_ATOL)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    has = want[:, 2] > 0
    np.testing.assert_allclose(got[:, 1][has], want[:, 1][has],
                               rtol=BPM_RTOL)

    # The port's file loads in the JAX package to the port's state.
    tpath = str(tmp_path / "port_fleet.npz")
    checkpoint.save_fleet_checkpoint(tpath, fleet)
    jback = _jax_fleet(cfg)
    jcheckpoint.load_fleet_checkpoint(tpath, jback)
    assert checkpoint.checkpoint_roundtrip_equal(jback.states, fleet.states)
    assert (jback.spec.crop_h, jback.spec.crop_w, jback.spec.method) == \
        (fleet.spec.crop_h, fleet.spec.crop_w, fleet.spec.method)
    assert jback._needs_init == fleet._needs_init
    assert jback.min_dist == fleet.min_dist


def test_resume_drops_the_streaming_state_in_both_packages(tmp_path):
    # Neither package's file holds the rolling rings (ROADMAP.md queue 3):
    # a resumed streaming monitor and fleet neither absorb nor re-lock
    # until they calibrate again.
    from respmon_tpu.runtime import checkpoint as jcheckpoint

    cfg = dataclasses.replace(MonitorConfig(calibration=CAL),
                              streaming_roi=True, streaming_interval=4)
    clip = _clip(32 + 1 + 10 + 8 + 1 + 32 + 6)
    cut = 32 + 1 + 10
    tail = clip[cut:]
    monitors = {}
    for name, make, ckpt in (("port", _monitor, checkpoint),
                             ("jax", _jax_monitor, jcheckpoint)):
        first = make(clip[:cut], "average", cfg, error_reset_delay=0.0)
        _drive(first)
        assert first.state == "measure" and first._streaming_state is not None
        path = str(tmp_path / f"{name}_monitor.npz")
        ckpt.save_checkpoint(path, first)
        resumed = make(tail, "average", cfg, error_reset_delay=0.0)
        ckpt.load_checkpoint(path, resumed)
        states = [resumed.state for _ in range(8) if resumed.step()]
        assert states == ["measure"] * 8
        assert resumed._streaming_state is None and resumed.relocks == 0
        # An error and the recalibration after it bring the rings back.
        resumed.trigger_error("test")
        _drive(resumed)
        assert resumed.state == "measure"
        assert resumed._streaming_state is not None
        monitors[name] = resumed
    absorbed = monitors["port"].streaming_absorbed
    assert absorbed["measure"] > 0
    assert absorbed["measure"] < len(tail) - 8 - 32

    clips = _fleet_clips(2, 60, method="average")
    fleets = {"port": (_fleet(cfg), checkpoint),
              "jax": (_jax_fleet(cfg), jcheckpoint)}
    for name, (fleet, ckpt) in fleets.items():
        fleet.calibrate(clips[:, :32])
        fleet.step(clips[:, 33])
        path = str(tmp_path / f"{name}_fleet.npz")
        ckpt.save_fleet_checkpoint(path, fleet)
        resumed = _fleet(cfg) if name == "port" else _jax_fleet(cfg)
        ckpt.load_fleet_checkpoint(path, resumed)
        for f in range(34, 42):
            resumed.step(clips[:, f])
        assert resumed._streaming is None and resumed.relocks == 0
        resumed.calibrate(clips[:, 10:42])
        resumed.step(clips[:, 42])
        assert resumed._streaming is not None
        if name == "port":
            assert resumed.streaming_absorbed == 1
