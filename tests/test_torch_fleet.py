"""Port parity: the multi-stream fleet (``parallel/streams.py``) against the
JAX package's (``mesh=None``), step for step, and against the port's own
single-stream step.

Sizes are ``tests/test_parallel.py``'s: 60x80 frames, a 32-frame
calibration buffer, a few streams.  Tolerances are the single-stream
parity tests' (``tests/test_torch_monitor.py``): average mode (float32)
gives equal ROI, ``has_bpm``, ``error`` and samples to atol 1e-5, BPM to
rtol 1e-5; flow mode in float64 samples to atol 1e-9 and everything else
equal; flow mode in float32 drifts from frame to frame (``ROADMAP.md``
queue 3), so there only the ROIs, ``error`` and BPM within 0.5 are held.
In flow mode both monitors step through their carried-LK-cache step, so
the step-for-step cases hold the port's cached step against the JAX
package's.  Each JAX fleet run is built once per module and shared.  To hold BPM
from the first step on, both fleets get the same full signal rings (a sine
at each stream's rate) right after calibrating, as ``bench.py``'s fleet
bench installs them; the measured samples then push into them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu.parallel import streams as jstreams
from respmon_tpu_torch import interop
from respmon_tpu_torch.ops import filters as tfilters
from respmon_tpu_torch.parallel import launch
from respmon_tpu_torch.parallel import mesh as tmesh
from respmon_tpu_torch.parallel import streams as tstreams
from respmon_tpu_torch.pipeline import bpm as tbpm
from respmon_tpu_torch.pipeline import evm as tevm
from respmon_tpu_torch.pipeline import motion as tmotion

torch.set_num_threads(1)

FPS = 10.0
H, W = 60, 80
CAL = CalibrationConfig(buffer_length=32, pyramid_levels=4,
                        skip_levels_at_top=1)
SMALL_CFG = MonitorConfig(calibration=CAL)
FLOW_CFG = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
BPMS = [15.0, 18.0, 21.0]
STEPS = 8
BPM_RTOL = 1e-5
# The average mode ingests camera-native uint8 (calibration buffers and
# frames); the flow modes float frames.
MODES = {"average_u8": ("average", np.float32),
         "flow_f64": ("flow", np.float64),
         "flow_f32": ("flow", np.float32)}


def _stream_clips(s, t, seed0=0, bpms=None, method="average",
                  dtype=np.float32):
    bpms = bpms or [18.0] * s
    flow = method == "flow"
    return np.stack([
        breathing_clip(num_frames=t, height=H, width=W, fps=FPS,
                       bpm=bpms[i], patch_center=(30, 40),
                       patch_size=(16, 20), amplitude=0.25, noise=0.002,
                       motion_px=1.5 if flow else 0.0, texture_motion=flow,
                       seed=seed0 + i, dtype=dtype)
        for i in range(s)])


def _torch_dtype(np_dtype):
    return torch.float64 if np_dtype == np.float64 else torch.float32


def _monitors(cfg, np_dtype=np.float32, **kw):
    jmon = jstreams.MultiStreamMonitor(
        cfg, None, (H, W), FPS,
        dtype=jnp.float64 if np_dtype == np.float64 else jnp.float32, **kw)
    tmon = tstreams.MultiStreamMonitor(
        interop.config_from_reference(cfg), None, (H, W), FPS,
        dtype=_torch_dtype(np_dtype), device="cpu", **kw)
    return jmon, tmon


def _record(res):
    return {f: np.asarray(getattr(res, f)) if not torch.is_tensor(
        getattr(res, f)) else getattr(res, f).numpy()
        for f in ("samples", "bpm", "has_bpm", "error")}


def _full_rings(n, np_dtype):
    """(data, t, count) of full rings: each stream's breathing rate as a
    sine, with a little noise, made from a seed."""
    rng = np.random.default_rng(7)
    t = np.arange(n) / FPS
    rate = np.asarray(BPMS)[:, None] / 60.0
    data = 0.15 * np.sin(2 * np.pi * rate * t[None, :] + rng.uniform(
        0, 2 * np.pi, (len(BPMS), 1))) \
        + 0.01 * rng.standard_normal((len(BPMS), n))
    return (data.astype(np_dtype),
            np.broadcast_to(t, data.shape).astype(np_dtype).copy(),
            np.full(len(BPMS), n, np.int32))


def _fleet_run(mode):
    """Calibrate both fleets on 3 streams with different BPMs, then step
    both ``STEPS`` frames; each step's results and ROIs on both sides."""
    method, np_dtype = MODES[mode]
    cfg = dataclasses.replace(SMALL_CFG, motion_extraction_method=method)
    clips = _stream_clips(3, 32 + 2 + STEPS, bpms=BPMS, method=method,
                          dtype=np_dtype)
    if method == "average":
        clips = _u8(clips)
    jmon, tmon = _monitors(cfg, np_dtype)
    jloc = jmon.calibrate(clips[:, :32])
    tloc = tmon.calibrate(clips[:, :32])
    data, t, count = _full_rings(cfg.measure.buffer_length, np_dtype)
    jmon.states = jmon.states._replace(data=jnp.asarray(data),
                                       t=jnp.asarray(t),
                                       count=jnp.asarray(count))
    tmon.states = tmon.states._replace(data=torch.from_numpy(data),
                                       t=torch.from_numpy(t),
                                       count=torch.from_numpy(count))
    trace = []
    for f in range(33, 33 + STEPS):
        jr = jmon.step(clips[:, f])
        tr = tmon.step(clips[:, f])
        trace.append((_record(jr), _record(tr),
                      np.asarray(jmon.states.roi),
                      tmon.states.roi.numpy()))
    return dict(mode=mode, method=method, dtype=np_dtype,
                cfg=cfg, clips=clips, jloc=jloc, tloc=tloc, trace=trace,
                jmon=jmon, tmon=tmon)


@pytest.fixture(scope="module")
def fleet_runs():
    """``_fleet_run`` of each mode, built once per module when first
    asked for."""
    runs = {}

    def get(mode):
        if mode not in runs:
            runs[mode] = _fleet_run(mode)
        return runs[mode]
    return get


@pytest.fixture(params=sorted(MODES))
def fleet_run(request, fleet_runs):
    return fleet_runs(request.param)


def test_locate_streams_equals_jax_and_the_single_stream_locate(fleet_runs):
    fleet_run = fleet_runs("average_u8")
    jloc, tloc = fleet_run["jloc"], fleet_run["tloc"]
    assert tloc.found.all()
    np.testing.assert_array_equal(tloc.found.numpy(), np.asarray(jloc.found))
    np.testing.assert_array_equal(tloc.boxes.numpy(), np.asarray(jloc.boxes))
    for i, clip in enumerate(fleet_run["clips"][:, :32]):
        r = tevm.locate(torch.from_numpy(clip), FPS,
                        interop.config_from_reference(CAL))
        assert [int(r.x), int(r.y), int(r.w), int(r.h)] == \
            tloc.boxes[i].tolist()


def test_fleet_steps_equal_jax(fleet_run):
    method, np_dtype = fleet_run["method"], fleet_run["dtype"]
    f32_flow = method == "flow" and np_dtype == np.float32
    for k, (j, t, jroi, troi) in enumerate(fleet_run["trace"]):
        np.testing.assert_array_equal(troi, jroi)
        np.testing.assert_array_equal(t["error"], j["error"], err_msg=k)
        if f32_flow:
            both = j["has_bpm"] & t["has_bpm"]
            assert (np.abs(t["bpm"][both] - j["bpm"][both]) <= 0.5).all(), k
            continue
        np.testing.assert_array_equal(t["has_bpm"], j["has_bpm"],
                                      err_msg=k)
        atol = 1e-9 if np_dtype == np.float64 else 1e-5
        np.testing.assert_allclose(t["samples"], j["samples"], rtol=0,
                                   atol=atol, err_msg=k)
        has = j["has_bpm"]
        rtol = 1e-12 if np_dtype == np.float64 else BPM_RTOL
        np.testing.assert_allclose(t["bpm"][has], j["bpm"][has], rtol=rtol,
                                   err_msg=k)
    assert all(t["has_bpm"].all() for _, t, _, _ in fleet_run["trace"])


def test_fleet_row_equals_the_single_stream_step(fleet_run):
    # Row i of every fleet step is the port's own single-stream
    # measure_step + estimate_bpm on stream i (f64_refine off, as the
    # fleet runs it), bit for bit.
    cfg, clips = fleet_run["cfg"], fleet_run["clips"]
    tmon = fleet_run["tmon"]
    tcfg = interop.config_from_reference(cfg)
    mcfg = dataclasses.replace(tcfg.measure, f64_refine=False)
    coeffs = tfilters.design_butter_lowpass(
        tcfg.calibration.freq_max * 0.5, FPS, tcfg.measure.filter_order)
    for i in (0, 2):
        roi = fleet_run["tloc"].boxes[i].tolist()
        data, t, count = _full_rings(tcfg.measure.buffer_length,
                                     fleet_run["dtype"])
        st = tmotion.init_state(tmon.spec, roi,
                                _torch_dtype(fleet_run["dtype"]), "cpu")
        st = st._replace(data=torch.from_numpy(data[i]),
                         t=torch.from_numpy(t[i]),
                         count=torch.tensor(int(count[i]), dtype=torch.int32))
        for k, f in enumerate(range(33, 33 + STEPS)):
            st, sample = tmotion.measure_step(
                st, torch.from_numpy(clips[i, f]), tmon.spec)
            res = tbpm.estimate_bpm(st.data[None], st.t[None],
                                    st.count[None], coeffs, tmon.min_dist,
                                    mcfg)
            row = fleet_run["trace"][k][1]
            assert torch.equal(sample, torch.as_tensor(row["samples"][i])) \
                or (sample.isnan() and np.isnan(row["samples"][i])), (i, k)
            has = bool(res.has_bpm[0]) and int(st.count) > \
                mcfg.initialization_length
            assert has == bool(row["has_bpm"][i]), (i, k)
            if has:
                assert float(res.bpm[0]) == float(row["bpm"][i]), (i, k)
            assert bool(st.error) == bool(row["error"][i]), (i, k)


def _u8(clips):
    return np.clip(np.trunc(clips * 255.0), 0, 255).astype(np.uint8)


def test_fleet_u8_ingest_bit_identical_to_float():
    # Camera-native uint8 frames and the float [0,1] convention land on the
    # same u8-lattice crops: samples and BPM agree bit for bit
    # (tests/test_parallel.py:405, for the port).
    clips_u8 = _u8(_stream_clips(3, 10, method="flow"))
    clips_f = clips_u8.astype(np.float32) / np.float32(255.0)
    tcfg = interop.config_from_reference(FLOW_CFG)
    spec = tmotion.MeasureSpec.for_roi(tcfg, H, W, 30, 24, FPS)
    coeffs = tfilters.design_butter_lowpass(0.5, FPS, 3)
    boxes = np.tile(np.asarray([[2, 2, 30, 24]], np.int32), (3, 1))
    results = {}
    for name, frames in (("f32", clips_f), ("u8", clips_u8)):
        states = tstreams.init_stream_states(spec, boxes, device="cpu")
        samples, bpms = [], []
        for t in range(8):
            res = tstreams.monitor_step_streams(
                states, torch.from_numpy(frames[:, t]), spec, coeffs, 3,
                tcfg.measure, initialized=t > 0)
            states = res.state
            samples.append(res.samples)
            bpms.append(res.bpm)
        assert not states.error.any()
        results[name] = (torch.stack(samples), torch.stack(bpms))
    assert torch.equal(results["u8"][0], results["f32"][0])
    assert torch.equal(results["u8"][1], results["f32"][1])


def test_fleet_calibrate_accepts_u8_buffers():
    # u8 calibration buffers find the ROIs of the host-converted float ones
    # (tests/test_parallel.py:571), and recalibrate takes u8 too.
    clips = _stream_clips(3, 34)
    clips_u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)
    clips_f = (clips_u8.astype(np.float64) * (1.0 / 255.0)).astype(
        np.float32)
    _, mon_u8 = _monitors(SMALL_CFG)
    _, mon_f = _monitors(SMALL_CFG)
    loc_u8 = mon_u8.calibrate(clips_u8[:, :32])
    loc_f = mon_f.calibrate(clips_f[:, :32])
    assert torch.equal(loc_u8.found, loc_f.found)
    assert torch.equal(loc_u8.boxes, loc_f.boxes)
    loc_r = mon_u8.recalibrate(clips_u8[:, 1:33])
    assert loc_r.found.shape == (3,)


def test_recalibrate_subset_of_streams_equals_jax():
    # tests/test_parallel.py:114 for the port, beside the JAX fleet.
    clips = _stream_clips(3, 40)
    jmon, tmon = _monitors(SMALL_CFG)
    for mon in (jmon, tmon):
        mon.calibrate(clips[:, :32])
        for f in range(33, 36):
            mon.step(clips[:, f])
    counts_before = tmon.states.count.numpy().copy()
    rois_before = tmon.states.roi.numpy().copy()
    new_clips = _stream_clips(3, 32, seed0=100)
    mask = np.zeros(3, bool)
    mask[[0, 2]] = True
    jloc = jmon.recalibrate(new_clips, stream_mask=mask)
    tloc = tmon.recalibrate(new_clips, stream_mask=mask)
    assert tloc.found[[0, 2]].all()
    np.testing.assert_array_equal(tloc.boxes.numpy(), np.asarray(jloc.boxes))
    counts_after = tmon.states.count.numpy()
    rois_after = tmon.states.roi.numpy()
    assert (counts_after[[0, 2]] == 0).all()
    assert counts_after[1] == counts_before[1]
    np.testing.assert_array_equal(rois_after[1], rois_before[1])
    np.testing.assert_array_equal(rois_after, np.asarray(jmon.states.roi))
    np.testing.assert_array_equal(counts_after,
                                  np.asarray(jmon.states.count))
    np.testing.assert_array_equal(tmon._rois, jmon._rois)
    j, t = _record(jmon.step(clips[:, 36])), _record(tmon.step(clips[:, 36]))
    np.testing.assert_allclose(t["samples"], j["samples"], rtol=0, atol=1e-5)


def test_recalibrate_with_no_stream_applied_changes_nothing():
    # The early return: no stream applied leaves states, the carried LK
    # cache and the streaming rings as they were.
    cfg = dataclasses.replace(FLOW_CFG, streaming_roi=True)
    clips = _stream_clips(3, 40, method="flow")
    _, tmon = _monitors(cfg)
    tmon.calibrate(clips[:, :32])
    for f in range(33, 36):
        tmon.step(clips[:, f])
    states, rings, cache = tmon.states, tmon._streaming, tmon._cache
    assert cache is not None
    loc = tmon.recalibrate(clips[:, 4:36], stream_mask=np.zeros(3, bool))
    assert loc.found.all()
    assert tmon.states is states and tmon._streaming is rings
    assert tmon._cache is cache


def _fixed_fleet(s=3):
    clips = _stream_clips(s, 12, method="flow")
    tcfg = interop.config_from_reference(FLOW_CFG)
    spec = tmotion.MeasureSpec.for_roi(tcfg, H, W, 30, 24, FPS)
    coeffs = tfilters.design_butter_lowpass(0.5, FPS, 3)
    boxes = np.tile(np.asarray([[2, 2, 30, 24]], np.int32), (s, 1))
    return clips, tcfg, spec, coeffs, boxes


def test_cached_fleet_step_bit_identical_to_uncached():
    # tests/test_parallel.py:597 for the port: the carried prev-frame LK
    # stacks give every output bit for bit, the rebuild variant
    # (cache_valid=False) included.
    clips, tcfg, spec, coeffs, boxes = _fixed_fleet()
    states_u = tstreams.init_stream_states(spec, boxes, device="cpu")
    states_c = tstreams.init_stream_states(spec, boxes, device="cpu")
    cache = tstreams.init_fleet_cache(spec, 3, device="cpu")
    cache_valid = False
    for t in range(9):
        frames = torch.from_numpy(clips[:, t])
        res_u = tstreams.monitor_step_streams(
            states_u, frames, spec, coeffs, 3, tcfg.measure,
            initialized=t > 0)
        states_u = res_u.state
        res_c, cache = tstreams.monitor_step_streams_cached(
            states_c, cache, frames, spec, coeffs, 3, tcfg.measure,
            initialized=t > 0, cache_valid=cache_valid)
        states_c = res_c.state
        assert torch.equal(res_u.samples, res_c.samples)
        assert torch.equal(res_u.bpm, res_c.bpm)
        assert torch.equal(res_u.state.pts, res_c.state.pts)
        # Re-enter through the rebuild variant mid-chain (t == 3 stands
        # for a restore or an outside install of the states).
        cache_valid = t != 3
    assert torch.equal(states_u.data, states_c.data)
    assert not states_c.error.any()


def test_fleet_cache_dropped_by_external_states_assignment():
    # tests/test_parallel.py:646 for the port.
    clips = _stream_clips(3, 40, method="flow")
    _, tmon = _monitors(FLOW_CFG)
    tmon.calibrate(clips[:, :32])
    assert tmon._cache is None
    tmon.step(clips[:, 33])
    tmon.step(clips[:, 34])
    assert tmon._cache is not None
    tmon.states = tmon.states          # an outside install
    assert tmon._cache is None
    res = tmon.step(clips[:, 35])      # the rebuild variant recovers
    assert torch.isfinite(res.samples).all()
    assert tmon._cache is not None
    tmon.recalibrate(clips[:, 4:36])   # goes through the setter too
    assert tmon._cache is None


def test_step_many_matches_sequential_steps():
    # tests/test_parallel.py:516 for the port.
    clips = _stream_clips(3, 40, method="flow")
    _, mon_a = _monitors(FLOW_CFG)
    _, mon_b = _monitors(FLOW_CFG)
    mon_a.calibrate(clips[:, :32])
    mon_b.calibrate(clips[:, :32])
    seq = [mon_a.step(clips[:, f]) for f in range(33, 39)]
    batch = mon_b.step_many(np.swapaxes(clips[:, 33:39], 0, 1))
    assert torch.equal(torch.stack([r.samples for r in seq]), batch.samples)
    assert torch.equal(torch.stack([r.has_bpm for r in seq]), batch.has_bpm)
    assert torch.equal(torch.stack([r.bpm for r in seq])[batch.has_bpm],
                       batch.bpm[batch.has_bpm])
    assert torch.equal(mon_a.states.data, mon_b.states.data)
    assert torch.equal(mon_a.states.count, mon_b.states.count)


def _op_count(s):
    """Operator calls the profiler records in one steady-state fleet step
    of ``s`` copies of one stream (the same loop counts in every row)."""
    from torch.profiler import ProfilerActivity, profile

    clip = _stream_clips(1, 40, method="flow")[0]
    clips = np.broadcast_to(clip, (s,) + clip.shape).copy()
    _, tmon = _monitors(FLOW_CFG)
    tmon.calibrate(clips[:, :32])
    for f in range(33, 36):
        tmon.step(clips[:, f])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tmon.step(clips[:, 36])
    return sum(e.count for e in prof.key_averages())


def test_fleet_step_work_does_not_grow_with_streams():
    # One step runs the same operator calls for 2 streams as for 4: no
    # per-stream loop in the measure step, the estimate or the cache.
    assert _op_count(2) == _op_count(4)


def test_one_rank_mesh_steps_as_no_mesh():
    # A fleet on a one-rank gloo mesh (its rows are all the streams)
    # gathers its results and steps as the fleet without a mesh.
    clips = _stream_clips(2, 40, method="flow")
    tcfg = interop.config_from_reference(FLOW_CFG)
    rows = {}
    with launch.single_rank("gloo"):
        for name, mesh in (("none", None),
                           ("mesh", tmesh.make_mesh(device="cpu"))):
            tmon = tstreams.MultiStreamMonitor(tcfg, mesh, (H, W), FPS,
                                               device="cpu")
            tmon.calibrate(clips[:, :32])
            res = [tmon.step(clips[:, f]) for f in range(33, 37)]
            rows[name] = [torch.stack([r.samples.double(), r.bpm.double(),
                                       r.has_bpm.double(),
                                       r.error.double()]) for r in res]
        assert mesh.collectives == {"all_gather": 1 + 4}
    for a, b in zip(rows["mesh"], rows["none"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_fleet_runs_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tstreams.MultiStreamMonitor(
            interop.config_from_reference(SMALL_CFG), None, (H, W), FPS)


def test_fleet_lk_sampling_is_slices():
    tcfg = interop.config_from_reference(FLOW_CFG)
    assert tstreams.fleet_lk_sample(tcfg, 64, 64, 4) == "slices"
    assert tstreams.fleet_lk_prev_sample(tcfg) == "slices"


def test_measure_clip_streams_equals_each_stream():
    clips = _stream_clips(2, 40)
    tcfg = interop.config_from_reference(SMALL_CFG)
    spec = tmotion.MeasureSpec.for_roi(tcfg, H, W, 20, 16, FPS)
    coeffs = tfilters.design_butter_lowpass(0.5, FPS, 3)
    rois = np.asarray([[30, 22, 20, 16], [28, 20, 20, 16]], np.int32)
    got = tstreams.measure_clip_streams(torch.from_numpy(clips), rois, spec,
                                        coeffs, 10, tcfg.measure)
    from respmon_tpu_torch.pipeline import scan as tscan
    for i in range(2):
        one = tscan.measure_clip(torch.from_numpy(clips[i]), rois[i].tolist(),
                                 spec, coeffs, 10, tcfg.measure)
        assert torch.equal(got.samples[i], one.samples)
        assert torch.equal(got.bpm[i], one.bpm)
        assert torch.equal(got.final_state.roi[i], one.final_state.roi)


def test_jax_fleet_state_and_cache_cross_into_the_port(fleet_runs):
    # The JAX fleet's batched MeasureState and FlowCache after the run make
    # a round trip through numpy into the port and back unchanged, and the
    # port steps on from them as the JAX fleet does (float64 flow).
    fleet_run = fleet_runs("flow_f64")
    jmon, tmon = fleet_run["jmon"], fleet_run["tmon"]
    jd = {f: np.asarray(getattr(jmon.states, f))
          for f in jmon.states._fields}
    jc = {f"stacks.{k}": np.asarray(s)
          for k, s in enumerate(jmon._cache.stacks)}
    tstates = interop.measure_state_from_numpy(jd, device="cpu")
    tcache = interop.flow_cache_from_numpy(jc, device="cpu")
    back = interop.measure_state_to_numpy(tstates)
    for f, v in jd.items():
        assert back[f].dtype == v.dtype and np.array_equal(back[f], v), f
    for k, v in interop.flow_cache_to_numpy(tcache).items():
        assert np.array_equal(v, jc[k]), k
    frame = fleet_run["clips"][:, 33 + STEPS]
    tres, _ = tstreams.monitor_step_streams_cached(
        tstates, tcache, torch.from_numpy(frame), tmon.spec, tmon.coeffs,
        tmon.min_dist, tmon.measure_cfg, initialized=True, cache_valid=True)
    jres = jmon.step(frame)
    np.testing.assert_allclose(tres.samples.numpy(), np.asarray(jres.samples),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tres.bpm.numpy(), np.asarray(jres.bpm),
                               rtol=1e-12)
    np.testing.assert_allclose(tres.state.pts.numpy(),
                               np.asarray(jmon.states.pts), rtol=0,
                               atol=1e-9)
