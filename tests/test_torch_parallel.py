"""Port parity: the sharded paths (``parallel/{mesh,temporal,spatial}.py``
and the stream-sharded fleet of ``parallel/streams.py``) over 2 and 4 gloo
ranks on the CPU.

Sizes and tolerances are ``tests/test_parallel.py``'s:

- the W-sharded locate and pyrDown equal the port's single-device
  ``evm.locate`` / ``pyr_down`` bit for bit (every cross-shard reduction is
  a min, a max or a concatenation);
- the T-sharded locate has the bbox and ``thresh > 0`` of the port's
  ``evm.locate`` and of the JAX ``locate_tsharded`` (on the 8-device CPU
  mesh of ``tests/conftest.py``), and a heatmap within 1 (the sums over T
  reassociate across ranks);
- the W-sharded locate also has the bbox and ``thresh > 0`` of the JAX
  ``locate_wsharded`` (on that mesh), and a heatmap within 1 of it;
- the sharded fleet's ``step``, ``step_many``, subset recalibration and
  streaming re-lock equal the unsharded port fleet's bit for bit, and a
  step sends one collective: the gather of its per-stream results;
- each ``make_sharded_*`` factory on a rank's rows gives the batch
  function's global outputs and rows of state bit for bit.

Each case spawns its ranks once per module (``run_ranks``); the rank
functions live here, at module level, and this module imports JAX only
inside the tests, so that a spawned rank loads neither JAX nor the JAX
package (``test_ranks_load_no_jax``).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.ops.pyramid import pyr_down, pyramid_shapes
from respmon_tpu_torch.parallel import spatial, streams, temporal
from respmon_tpu_torch.parallel.dryrun import dryrun_multichip
from respmon_tpu_torch.parallel.launch import run_ranks, single_rank
from respmon_tpu_torch.parallel.mesh import (make_mesh, replicated,
                                             stream_sharding)
from respmon_tpu_torch.pipeline import evm, motion

torch.set_num_threads(1)

FPS = 10.0
H, W = 60, 80
CAL = CalibrationConfig(buffer_length=32, pyramid_levels=4,
                        skip_levels_at_top=1)
RANKS = [2, 4]
# (height, width, levels, skip, frames, seed, uint8): tests/test_parallel.py's
# two W-sharded cases; a 60x80 u8 one whose pyramid stops sharding inside
# the kept levels at 2 and at 4 ranks (the whole-to-sharded boundary); and
# the 120x160 u8 fixture of tests/test_torch_chip_smoke.py with 64 frames,
# where a T-mean whose summation order follows the shard's width (as
# Tensor.mean's does) moves raw_heat_u8 by 2.
W_CASES = [(48, 64, 4, 1, 16, 3, False), (96, 128, 5, 1, 16, 5, False),
           (60, 80, 5, 1, 16, 7, True), (120, 160, 6, 2, 64, 1, True)]
T_LENGTHS = [32, 27]   # 27 divides over neither 2 nor 4 ranks
S = 4


def _stream_clips(s, t, seed0=0, bpms=None, method="average"):
    bpms = bpms or [18.0] * s
    flow = method == "flow"
    return np.stack([
        breathing_clip(num_frames=t, height=H, width=W, fps=FPS,
                       bpm=bpms[i], patch_center=(30, 40),
                       patch_size=(16, 20), amplitude=0.25, noise=0.002,
                       motion_px=1.5 if flow else 0.0, texture_motion=flow,
                       seed=seed0 + i)
        for i in range(s)])


def _w_clip(h, w, levels, skip, t_len, seed, u8):
    clip = breathing_clip(num_frames=t_len, height=h, width=w, fps=FPS,
                          bpm=18.0 + levels, patch_center=(h // 2, w // 2),
                          patch_size=(16, 20), amplitude=0.2, seed=seed,
                          motion_px=2.0 if u8 else 0.0, texture_motion=u8)
    if u8:
        clip = np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)
    return clip, CalibrationConfig(buffer_length=t_len,
                                   pyramid_levels=levels,
                                   skip_levels_at_top=skip)


def _numpy(res):
    return {k: np.asarray(v.cpu()) for k, v in res._asdict().items()}


# ---------------------------------------------------------------------------
# Rank functions (spawned: module level, no JAX).
# ---------------------------------------------------------------------------

def locates_rank(device):
    """The T- and W-sharded locates and pyrDowns of every case, and what
    this rank loaded of JAX and the JAX package."""
    mesh_t = make_mesh(axis_names=("time",), device=device)
    mesh_w = make_mesh(axis_names=("space",), device=device)
    clip = _stream_clips(1, 32)[0]
    out = {"t": {t: _numpy(temporal.locate_tsharded(clip[:t], mesh_t, FPS,
                                                    CAL))
                 for t in T_LENGTHS}}
    out["w"] = {}
    for case in W_CASES:
        vid, cfg = _w_clip(*case)
        out["w"][case] = _numpy(spatial.locate_wsharded(vid, mesh_w, FPS,
                                                        cfg))
    x = np.random.default_rng(0).random((3, 48, 64)).astype(np.float32)
    out["pyr_down"] = spatial.pyr_down_w_sharded(x, mesh_w).numpy()
    out["collectives"] = (dict(mesh_t.collectives),
                          dict(mesh_w.collectives))
    out["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "respmon_tpu"))
    return out


def _row(res):
    return np.stack([res.samples.double().numpy(), res.bpm.double().numpy(),
                     res.has_bpm.double().numpy(),
                     res.error.double().numpy()])


def _states(mon):
    st = mon.states if mon.mesh is None else \
        streams.gather_rows(mon.mesh, mon.states)
    return [np.asarray(f) for f in st]


def fleet_scenario(mesh, device):
    """A flow fleet through steps, a counted step, ``step_many``, a subset
    recalibration and more steps; an average fleet of drifting subjects in
    streaming-ROI mode.  ``mesh=None`` runs both unsharded."""
    out = {}
    flow = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
    clips = _stream_clips(S, 48, method="flow", bpms=[15.0, 18.0, 21.0,
                                                      24.0])
    mon = streams.MultiStreamMonitor(flow, mesh, (H, W), FPS, device=device)
    out["boxes"] = mon.calibrate(clips[:, :32]).boxes.numpy()
    rows = [_row(mon.step(clips[:, f])) for f in range(33, 37)]
    if mesh is not None:
        mesh.collectives.clear()
    rows.append(_row(mon.step(clips[:, 37])))
    if mesh is not None:
        out["step_collectives"] = dict(mesh.collectives)
    batch = mon.step_many(np.swapaxes(clips[:, 38:42], 0, 1))
    out["batch"] = np.stack([batch.samples.numpy(), batch.bpm.numpy(),
                             batch.has_bpm.numpy().astype(float)])
    mask = np.zeros(S, bool)
    mask[[0, 3]] = True
    loc = mon.recalibrate(_stream_clips(S, 32, seed0=100, method="flow"),
                          stream_mask=mask)
    out["recal_boxes"] = loc.boxes.numpy()
    rows += [_row(mon.step(clips[:, f])) for f in range(42, 48)]
    out["rows"] = np.stack(rows)
    out["states"] = _states(mon)

    cfg = dataclasses.replace(
        MonitorConfig(calibration=CalibrationConfig(
            buffer_length=16, pyramid_levels=4, skip_levels_at_top=1)),
        streaming_roi=True, streaming_interval=4, streaming_drift_px=2.0)
    drifts = [(14.0, 24.0), (12.0, 20.0), (10.0, 26.0), (14.0, 18.0)]
    moving = np.stack([
        breathing_clip(num_frames=48, height=H, width=W, fps=FPS, bpm=37.5,
                       patch_center=(20, 24), patch_size=(14, 18),
                       amplitude=0.3, drift_px=drifts[i], noise=0.002,
                       seed=0)
        for i in range(S)])
    moving = np.clip(np.round(moving * 255.0), 0, 255).astype(np.uint8)
    smon = streams.MultiStreamMonitor(cfg, mesh, (H, W), FPS, device=device)
    smon.calibrate(moving[:, :16])
    srows = []
    for f in range(17, 48):
        if mesh is not None:
            mesh.collectives.clear()
        srows.append(_row(smon.step(moving[:, f])))
        if mesh is not None and f == 17:
            out["absorb_collectives"] = dict(mesh.collectives)
    out["stream_rows"] = np.stack(srows)
    out["relocks"] = smon.relocks
    out["rois"] = smon._rois.copy()
    out["stream_states"] = _states(smon)
    return out


def factory_scenario(mesh, device):
    """Each ``make_sharded_*`` factory on this rank's rows (``mesh=None``:
    the batch function it wraps, on every row): a locate, a step, two
    cached steps, a scan, an absorb, an update and a masked re-lock.
    Returns the global outputs and the gathered state."""
    flow = MonitorConfig(motion_extraction_method="flow", calibration=CAL)
    clips = torch.from_numpy(_stream_clips(S, 44, method="flow",
                                           bpms=[15.0, 18.0, 21.0, 24.0]))
    mon = streams.MultiStreamMonitor(flow, None, (H, W), FPS, device=device)
    mon.calibrate(clips[:, :32])
    args = (mon.spec, mon.coeffs, mon.min_dist, mon.measure_cfg)
    if mesh is None:
        def own(x, dim=0):
            return x

        def full(tree):
            return list(tree)
        locate = streams.locate_streams(clips[:, :32], FPS, CAL)
        step = streams.monitor_step_streams
        cached = streams.monitor_step_streams_cached
        scan = streams.monitor_scan_streams
        absorb = streams.absorb_streams
        update = streams.update_streams
        relock = streams.relock_streams
    else:
        def own(x, dim=0):
            if isinstance(x, tuple):
                return streams.shard_streams(x, mesh)
            return x[(slice(None),) * dim + (stream_sharding(mesh, S),)]

        def full(tree):
            return streams.gather_rows(mesh, tree)
        locate = streams.make_sharded_locate(mesh, FPS, CAL)(
            streams.shard_streams(clips[:, :32], mesh))

        def step(st, fr, *a):
            return streams.make_sharded_monitor_step(mesh, *a)(st, fr)

        def cached(st, c, fr, *a, cache_valid):
            return streams.make_sharded_monitor_step_cached(
                mesh, *a, cache_valid=cache_valid)(st, c, fr)

        def scan(st, fr, *a):
            return streams.make_sharded_monitor_scan(mesh, *a)(st, fr)

        def absorb(ss, fr, cal):
            return streams.make_sharded_absorb(mesh, cal)(ss, fr)

        def update(ss, fr, fps, cal):
            return streams.make_sharded_update(mesh, fps, cal)(ss, fr)

        def relock(st, fr, rois, apply, spec):
            return streams.make_sharded_relock(mesh, spec)(st, fr, rois,
                                                           apply)
    out = {"locate": np.asarray(torch.cat([locate.found[:, None].int(),
                                           locate.boxes], 1))}
    r = step(own(mon.states), own(clips[:, 33]), *args)
    rows = [_row(r)]
    cache = own(streams.init_fleet_cache(mon.spec, S, device=device))
    for f, valid in ((34, False), (35, True)):
        r, cache = cached(r.state, cache, own(clips[:, f]), *args,
                          cache_valid=valid)
        rows.append(_row(r))
    out["rows"] = np.stack(rows)
    r = scan(r.state, own(clips[:, 36:39].transpose(0, 1), dim=1), *args)
    out["scan"] = np.stack([r.samples.numpy(), r.bpm.numpy(),
                            r.has_bpm.numpy().astype(float)])
    rings = own(streams.init_fleet_streaming_from_buffers(clips[:, :32],
                                                          CAL))
    rings = absorb(rings, own(clips[:, 39]), CAL)
    rings, loc = update(rings, own(clips[:, 40]), FPS, CAL)
    out["streaming_locate"] = [np.asarray(f) for f in loc]
    out["rings"] = [np.asarray(f) for f in full(rings.levels)]
    boxes = locate.boxes.numpy()
    new_rois = np.stack([np.minimum(boxes[:, 0] + 2, W - boxes[:, 2]),
                         boxes[:, 1], boxes[:, 2], boxes[:, 3]], 1)
    apply = np.asarray([True, False, True, False])
    st = relock(r.state, own(clips[:, 41]), own(new_rois.astype(np.int32)),
                own(apply), mon.spec)
    out["states"] = [np.asarray(f) for f in full(st)]
    return out


def fleet_rank(device):
    mesh = make_mesh(axis_names=("streams",), device=device)
    return fleet_scenario(mesh, device), factory_scenario(mesh, device)


# ---------------------------------------------------------------------------
# Runs, once per module.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    """``run_ranks`` of a rank function at n ranks, each run once."""
    done = {}

    def get(fn, n):
        if (fn, n) not in done:
            done[fn, n] = run_ranks(fn, n)
        return done[fn, n]
    return get


@pytest.fixture(scope="module")
def unsharded_fleet():
    return fleet_scenario(None, "cpu")


@pytest.fixture(scope="module")
def unsharded_factories():
    return factory_scenario(None, "cpu")


@pytest.fixture(scope="module")
def jax_tsharded():
    import jax
    import jax.numpy as jnp

    from respmon_tpu.config import CalibrationConfig as JCal
    from respmon_tpu.parallel.mesh import make_mesh as jmake_mesh
    from respmon_tpu.parallel.temporal import locate_tsharded as jlocate

    jcal = JCal(buffer_length=32, pyramid_levels=4, skip_levels_at_top=1)
    mesh = jmake_mesh(axis_names=("time",))
    assert len(jax.devices()) == 8
    clip = _stream_clips(1, 32)[0]
    return {t: {k: np.asarray(v) for k, v in jlocate(
        jnp.asarray(clip[:t]), mesh, FPS, jcal)._asdict().items()}
        for t in T_LENGTHS}


@pytest.fixture(scope="module")
def jax_wsharded():
    import jax
    import jax.numpy as jnp

    from respmon_tpu.config import CalibrationConfig as JCal
    from respmon_tpu.parallel.mesh import make_mesh as jmake_mesh
    from respmon_tpu.parallel.spatial import locate_wsharded as jlocate

    mesh = jmake_mesh(axis_names=("space",))
    assert len(jax.devices()) == 8
    out = {}
    for case in W_CASES:
        vid, cfg = _w_clip(*case)
        jcal = JCal(buffer_length=cfg.buffer_length,
                    pyramid_levels=cfg.pyramid_levels,
                    skip_levels_at_top=cfg.skip_levels_at_top)
        out[case] = {k: np.asarray(v) for k, v in jlocate(
            jnp.asarray(vid), mesh, FPS, jcal)._asdict().items()}
    return out


def _box(r):
    return [int(r[k]) for k in ("found", "x", "y", "w", "h")]


# ---------------------------------------------------------------------------
# Tests.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("t_len", T_LENGTHS)
def test_locate_tsharded_matches_locate_and_jax(ranks, jax_tsharded, n,
                                                t_len):
    clip = torch.from_numpy(_stream_clips(1, 32)[0][:t_len])
    want = _numpy(evm.locate(clip, FPS, CAL))
    jax_want = jax_tsharded[t_len]
    for got in (r["t"][t_len] for r in ranks(locates_rank, n)):
        assert _box(got) == _box(want) == _box(jax_want)
        for ref in (want, jax_want):
            assert np.abs(got["heatmap_u8"].astype(np.int32)
                          - ref["heatmap_u8"].astype(np.int32)).max() <= 1
            np.testing.assert_array_equal(got["thresh"] > 0,
                                          ref["thresh"] > 0)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", W_CASES)
def test_locate_wsharded_bit_identical_to_locate(ranks, n, case):
    vid, cfg = _w_clip(*case)
    want = _numpy(evm.locate(torch.from_numpy(vid), FPS, cfg))
    for r in ranks(locates_rank, n):
        got = r["w"][case]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", W_CASES)
def test_locate_wsharded_matches_jax(ranks, jax_wsharded, n, case):
    # raw_heat_u8 is left out: it normalises the T-mean of DC-free bands,
    # rounding noise whose bits follow each package's summation order.
    want = jax_wsharded[case]
    for got in (r["w"][case] for r in ranks(locates_rank, n)):
        assert _box(got) == _box(want)
        assert np.abs(got["heatmap_u8"].astype(np.int32)
                      - want["heatmap_u8"].astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(got["thresh"] > 0, want["thresh"] > 0)


@pytest.mark.parametrize("n", RANKS)
def test_wsharded_cases_cross_the_whole_to_sharded_boundary(n):
    h, w, levels = W_CASES[2][:3]
    last = levels - 2
    split = spatial._split_level(pyramid_shapes(h, w, levels), last, n)
    assert 1 <= split <= last


@pytest.mark.parametrize("n", RANKS)
def test_pyr_down_w_sharded_bit_identical(ranks, n):
    x = np.random.default_rng(0).random((3, 48, 64)).astype(np.float32)
    want = pyr_down(torch.from_numpy(x)).numpy()
    for r in ranks(locates_rank, n):
        np.testing.assert_array_equal(r["pyr_down"], want)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_locates_use_their_collectives(ranks, n):
    # T: one reduce-scatter a kept level (2 levels) and three all-reduces
    # (min, max, the two sums) a locate; W: halo exchanges, one gather of
    # the whole level, one of the heatmaps, and min / max.
    t_counts, w_counts = ranks(locates_rank, n)[0]["collectives"]
    assert t_counts == {"reduce_scatter": 2 * len(T_LENGTHS),
                        "all_reduce": 3 * len(T_LENGTHS)}
    assert set(w_counts) == {"exchange", "all_gather", "all_reduce"}
    assert w_counts["all_reduce"] == 2 * len(W_CASES)


@pytest.mark.parametrize("n", RANKS)
def test_ranks_load_no_jax(ranks, n):
    for r in ranks(locates_rank, n):
        assert r["jax_modules"] == []


@pytest.mark.parametrize("n", RANKS)
def test_sharded_fleet_equals_unsharded(ranks, unsharded_fleet, n):
    want = unsharded_fleet
    for got, _ in ranks(fleet_rank, n):
        for key in ("boxes", "batch", "recal_boxes", "rows", "stream_rows",
                    "rois"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in ("states", "stream_states"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
        assert got["relocks"] == want["relocks"] >= 1


@pytest.mark.parametrize("n", RANKS)
def test_sharded_fleet_step_gathers_once(ranks, n):
    # The counterpart of the JAX fleet's collective-free step: the one
    # collective is the gather of the per-stream results.
    for got, _ in ranks(fleet_rank, n):
        assert got["step_collectives"] == {"all_gather": 1}
        assert got["absorb_collectives"] == {"all_gather": 1}


@pytest.mark.parametrize("n", RANKS)
def test_sharded_factories_equal_batch_functions(ranks, unsharded_factories,
                                                 n):
    want = unsharded_factories
    for _, got in ranks(fleet_rank, n):
        for key in ("locate", "rows", "scan"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in ("streaming_locate", "rings", "states"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)


def test_unsharded_factory_scenario_relocks_the_masked_streams(
        unsharded_factories):
    roi = unsharded_factories["states"][motion.MeasureState._fields.index(
        "roi")]
    boxes = unsharded_factories["locate"][:, 1:]
    moved = roi[:, 0] != boxes[:, 0]
    assert moved.tolist() == [True, False, True, False]


def test_unsharded_fleet_scenario_recalibrates_and_relocks(
        unsharded_fleet):
    got = unsharded_fleet
    assert (got["states"][2][[0, 3]] < got["states"][2][[1, 2]]).all(), \
        "the recalibrated streams' counts restart"
    assert got["relocks"] >= S


def test_dryrun_multichip():
    results = dryrun_multichip(2)
    assert len(results) == 2
    assert results[0]["pyr_down"] == (8, 8)
    assert results[0]["fleet_samples"] == (2,)


def test_make_mesh_raises_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_make_mesh_is_one_axis_over_every_rank():
    with single_rank("gloo"):
        mesh = make_mesh(axis_names=("space",), device="cpu")
        assert mesh.shape == {"space": 1} and mesh.index("space") == 0
        assert make_mesh((1,), device="cpu").shape == {"streams": 1}
        with pytest.raises(KeyError, match="space"):
            mesh.index("time")
        for sizes, names in (((1, 1), ("a", "b")), ((2,), ("streams",))):
            with pytest.raises(ValueError, match="1-D"):
                make_mesh(sizes, names, device="cpu")


def test_stream_sharding_rows():
    class OneAxis:
        shape = {"streams": 4}

        @staticmethod
        def index(axis):
            return 2

    assert stream_sharding(OneAxis, 8) == slice(4, 6)
    assert replicated(OneAxis) == slice(None)
    with pytest.raises(ValueError, match="divide"):
        stream_sharding(OneAxis, 6)
