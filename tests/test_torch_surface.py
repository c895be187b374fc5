"""The port's public surface against the JAX package's: every public
function, class and method of ``respmon_tpu/`` has a counterpart in
``respmon_tpu_torch/`` (read from the sources, not imported), and the
functions that completed it are held to their JAX counterparts on the
CPU: the single-stream ``measure_step_cached``,
``measure_step(initialized_hint=)``, ``filtfilt``, ``peak_indexes``,
``gaussian_fit_single`` and ``entry``.

Tolerances are those of the JAX package's own tests and of the port's
parity tests for the same functions: float64 flow samples to 1e-9
and float32 average-mode samples to 1e-5 (``tests/test_torch_flow.py``),
filtfilt to scipy at rtol 1e-8 / atol 1e-10 (``tests/test_filters.py``)
and float32 to JAX at 1e-5 (``tests/test_torch_bpm.py``), peak indices
and fit decisions bit for bit, converged fit parameters to rtol 1e-4 /
atol 1e-6 in float32 on clean windows (``tests/test_torch_bpm.py``) and in
float64 to 1e-9 on clean windows, 1e-6 relative on noisy ones.  The
cached step is held to the uncached one bit for bit, as the JAX docstring
promises.
"""

import ast
import functools
import os

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from respmon_tpu.config import MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip, motion_trace
from respmon_tpu.ops import filters as jfilters
from respmon_tpu.ops import gaussfit as jgauss
from respmon_tpu.ops import peaks as jpeaks
from respmon_tpu.pipeline import motion as jmotion
from respmon_tpu_torch import entry as tentry
from respmon_tpu_torch import interop
from respmon_tpu_torch.ops import filters as tfilters
from respmon_tpu_torch.ops import gaussfit as tgauss
from respmon_tpu_torch.ops import peaks as tpeaks
from respmon_tpu_torch.parallel import dryrun
from respmon_tpu_torch.parallel import streams as tstreams
from respmon_tpu_torch.pipeline import motion as tmotion

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS = 10.0

# -- the surface --------------------------------------------------------------

# What of the JAX package's public surface the port leaves out on purpose
# (ROADMAP.md, "Deliberate omissions"): (module, name) -> the arguments
# (or fields) left out, or None for the whole name.
ALLOWED = {
    # The Pallas kernels themselves: their counterparts are
    # ops/pyramid_cuda (K1, K2) and ops/pyramid_mm (K3), CUDA on the card.
    ("ops.pyramid_pallas", "laplacian_band_levels"): None,
    ("ops.pyramid_pallas", "gauss_level_tiled"): None,
    ("ops.pyramid_pallas", "laplacian_band_levels_mm"): None,
    # LK's TPU gather modes ("onehot", "onehot1", "patches") and what
    # selects or feeds them: MXU strategies equal to "slices", the one
    # mode the port runs.
    ("ops.lk", "LKFrameInputs"): {"patches"},
    ("ops.lk", "precompute_frame_inputs"): {"with_patches", "patch_dtype"},
    ("ops.lk", "lk_track_precomputed"): {"wprimes", "sample", "prev_sample",
                                         "bf16_split"},
    ("ops.lk", "calc_optical_flow_pyr_lk"): {"sample", "prev_sample",
                                             "bf16_split"},
    ("pipeline.motion", "MeasureSpec"): {"lk_sample", "lk_prev_sample",
                                         "clip_lk_sample",
                                         "clip_prev_sample"},
    ("pipeline.motion", "MeasureSpec.for_roi"): {"lk_sample"},
    # The forward-difference jacobian: no production path reaches it.
    ("ops.gaussfit", "gaussian_fit_single"): {"fd_jacobian"},
    ("ops.gaussfit", "gaussian_fit_batch"): {"fd_jacobian"},
    # A jax.jit wrapper; the port's estimate_bpm is the same call.
    ("pipeline.bpm", "estimate_bpm_jit"): None,
    # The port's level_geometry returns the shapes only, which need no
    # window (ROADMAP.md, "Deliberate omissions").
    ("ops.lk", "level_geometry"): {"win"},
    # A mesh is one rank per process over torch.distributed: make_mesh
    # takes this rank's device, not a list of JAX devices.
    ("parallel.mesh", "make_mesh"): {"devices"},
    # The stream axis is split by rows, not by a JAX sharding of a given
    # rank: stream_sharding takes the number of streams, not ndim.
    ("parallel.mesh", "stream_sharding"): {"ndim"},
}


def _args(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _surface(path: str, module: str = None) -> dict:
    """{(module, name): (kind, argument or field names)} of the public
    top-level functions and classes and the public methods (and
    ``__init__``) of the public classes in the sources under ``path``."""
    files = [path] if path.endswith(".py") else sorted(
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py"))
    out = {}
    for p in files:
        mod = module or os.path.relpath(p, path)[:-3].replace(os.sep, ".")
        with open(p) as fh:
            tree = ast.parse(fh.read())
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                    or node.name.startswith("_"):
                continue
            if isinstance(node, ast.FunctionDef):
                out[mod, node.name] = ("function", _args(node))
            elif isinstance(node, ast.ClassDef):
                out[mod, node.name] = ("class", [
                    s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)])
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and (
                            not sub.name.startswith("_")
                            or sub.name == "__init__"):
                        out[mod, f"{node.name}.{sub.name}"] = (
                            "method", _args(sub))
    return out


def _gaps(theirs: dict, ours: dict) -> dict:
    """What of ``theirs`` has no counterpart in ``ours``: (module, name) ->
    None for a missing name, else the set of missing arguments."""
    gaps = {}
    for key, (kind, names) in theirs.items():
        if key not in ours:
            gaps[key] = None
            continue
        assert ours[key][0] == kind, (key, kind, ours[key][0])
        missing = set(names) - set(ours[key][1])
        if missing:
            gaps[key] = missing
    return gaps


def test_the_port_covers_the_jax_package_surface():
    theirs = _surface(os.path.join(REPO, "respmon_tpu"))
    ours = _surface(os.path.join(REPO, "respmon_tpu_torch"))
    assert len(theirs) > 200
    assert _gaps(theirs, ours) == ALLOWED


def test_the_entry_module_mirrors_graft_entry():
    theirs = _surface(os.path.join(REPO, "__graft_entry__.py"), "entry")
    ours = _surface(os.path.join(REPO, "respmon_tpu_torch", "entry.py"),
                    "entry")
    ours.update(_surface(os.path.join(REPO, "respmon_tpu_torch", "parallel",
                                      "dryrun.py"), "entry"))
    assert set(theirs) == {("entry", "entry"), ("entry", "dryrun_multichip")}
    assert _gaps(theirs, ours) == {}
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip


def test_the_bench_module_mirrors_bench_py():
    theirs = _surface(os.path.join(REPO, "bench.py"), "bench")
    ours = _surface(os.path.join(REPO, "respmon_tpu_torch", "bench.py"),
                    "bench")
    assert {name for _, name in theirs} >= {
        "log", "corpus_traces", "main_headline", "main_bpm_corpus",
        "main_multistream", "main_fleet_breakdown", "main_live",
        "main_fleet_live", "main_recovery", "main_streaming", "main"}
    assert _gaps(theirs, ours) == {}


def test_the_surface_check_finds_a_missing_name_and_argument():
    theirs = {("m", "f"): ("function", ["a", "b"]),
              ("m", "C"): ("class", ["x"]), ("m", "g"): ("function", [])}
    ours = {("m", "f"): ("function", ["a"]), ("m", "C"): ("class", ["x"])}
    assert _gaps(theirs, ours) == {("m", "f"): {"b"}, ("m", "g"): None}
    with pytest.raises(AssertionError):
        _gaps(theirs, {**ours, ("m", "g"): ("class", [])})


# -- measure_step_cached, one stream ------------------------------------------

ROI = (50, 30, 40, 30)
FLOW = MonitorConfig(motion_extraction_method="flow")
AVERAGE = MonitorConfig()
STEPS = 24


def _clip(dtype):
    return breathing_clip(num_frames=STEPS, height=120, width=160, fps=FPS,
                          bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12,
                          motion_px=2.0, texture_motion=True, seed=1,
                          dtype=dtype)


def _specs(cfg):
    js = jmotion.MeasureSpec.for_roi(cfg, 120, 160, ROI[2], ROI[3], FPS)
    ts = tmotion.MeasureSpec.for_roi(interop.config_from_reference(cfg),
                                     120, 160, ROI[2], ROI[3], FPS)
    return js, ts


@functools.lru_cache(maxsize=None)
def _jax_cached_step(spec, cache_valid):
    return jax.jit(functools.partial(jmotion.measure_step_cached, spec=spec,
                                     cache_valid=cache_valid))


def _tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _port_runs(cfg, dtype, cache=True):
    """Per frame: (cached sample, uncached sample) of the port's
    single-stream steps, and their final states and cache."""
    _, ts = _specs(cfg)
    tdt = _tdtype(dtype)
    st_c = tmotion.init_state(ts, ROI, tdt, device="cpu")
    st_u = st_c
    cch = tmotion.init_flow_cache(ts, tdt, device="cpu") if cache else None
    out = []
    for i, frame in enumerate(_clip(dtype)):
        st_c, cch, s_c = tmotion.measure_step_cached(
            st_c, cch, torch.from_numpy(frame), ts, cache_valid=i > 0)
        st_u, s_u = tmotion.measure_step(st_u, torch.from_numpy(frame), ts)
        assert s_c.shape == () and s_c.dtype == tdt
        out.append((s_c, s_u))
    return out, st_c, st_u, cch


def _same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("method", ["flow", "average"])
def test_cached_step_equals_the_uncached_step_bit_for_bit(method):
    cfg = FLOW if method == "flow" else AVERAGE
    dtype = np.float64 if method == "flow" else np.float32
    out, st_c, st_u, cch = _port_runs(cfg, dtype)
    for s_c, s_u in out:
        assert torch.equal(s_c, s_u)
    assert _same_state(st_c, st_u)
    assert st_c.data.dim() == 1 and int(st_c.count) == STEPS
    if method == "flow":
        assert bool(st_c.initialized) and not bool(st_c.error)
        assert any(float(s) != 0.0 for s, _ in out)


def test_cached_step_flow_float64_matches_jax():
    # The single-stream call as the JAX package makes it, on a 120x160
    # float64 flow state with ROI (50, 30, 40, 30): the rebuild variant on
    # the first frame, the carried cache after.
    js, _ = _specs(FLOW)
    out, st, _, cch = _port_runs(FLOW, np.float64)
    jst = jmotion.init_state(js, ROI, jnp.float64)
    jc = jmotion.init_flow_cache(js, jnp.float64)
    for i, frame in enumerate(_clip(np.float64)):
        jst, jc, jsample = _jax_cached_step(js, i > 0)(jst, jc,
                                                       jnp.asarray(frame))
        np.testing.assert_allclose(float(out[i][0]), float(jsample),
                                   rtol=0, atol=1e-9, err_msg=f"frame {i}")
    np.testing.assert_allclose(st.data.numpy(), np.asarray(jst.data),
                               rtol=0, atol=1e-9)
    assert np.array_equal(st.pts_valid.numpy(), np.asarray(jst.pts_valid))
    for got, want in zip(cch.stacks, jc.stacks):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)


def test_cached_step_average_float32_matches_jax_and_keeps_the_cache():
    # Average mode: the ROI mean, within test_torch_flow.py's float32
    # tolerance of JAX's (the two sum the crop in another order); the
    # cache comes back untouched, as JAX returns it.
    js, ts = _specs(AVERAGE)
    tst = tmotion.init_state(ts, ROI, torch.float32, device="cpu")
    jst = jmotion.init_state(js, ROI, jnp.float32)
    tc = tmotion.init_flow_cache(ts, device="cpu")
    jc = jmotion.init_flow_cache(js)
    for i, frame in enumerate(_clip(np.float32)):
        tst, tc2, ts_ = tmotion.measure_step_cached(
            tst, tc, torch.from_numpy(frame), ts, cache_valid=i > 0)
        jst, jc2, js_ = _jax_cached_step(js, i > 0)(jst, jc,
                                                    jnp.asarray(frame))
        assert tc2 is tc
        assert all(np.array_equal(a, b) for a, b in zip(jc2.stacks,
                                                         jc.stacks))
        np.testing.assert_allclose(float(ts_), float(js_), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(tst.data.numpy(), np.asarray(jst.data),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["flow", "average"])
def test_cached_step_takes_no_cache_on_a_rebuild(method):
    cfg = FLOW if method == "flow" else AVERAGE
    _, ts = _specs(cfg)
    frames = _clip(np.float64)[:3]
    st = tmotion.init_state(ts, ROI, torch.float64, device="cpu")
    st, cch, _ = tmotion.measure_step_cached(
        st, None, torch.from_numpy(frames[0]), ts, cache_valid=False)
    assert (cch is None) == (method == "average")
    ref = tmotion.init_state(ts, ROI, torch.float64, device="cpu")
    ref, _ = tmotion.measure_step(ref, torch.from_numpy(frames[0]), ts)
    assert _same_state(st, ref)
    # A rebuild in the middle of a run, from no cache.
    st, cch, s = tmotion.measure_step_cached(
        st, None, torch.from_numpy(frames[1]), ts, cache_valid=False)
    ref, s_ref = tmotion.measure_step(ref, torch.from_numpy(frames[1]), ts)
    assert torch.equal(s, s_ref) and _same_state(st, ref)
    # The batched form takes no cache either.
    states = tstreams.init_stream_states(ts, [ROI] * 2, torch.float64,
                                         device="cpu")
    frames2 = torch.from_numpy(np.stack([frames[0], frames[0]]))
    _, bc, bs = tmotion.measure_step_cached(states, None, frames2, ts,
                                            cache_valid=False)
    assert bs.shape == (2,) and (bc is None) == (method == "average")


def test_batched_cached_step_still_equals_the_fleet_steps():
    # The fleet's form: every row bit-equal to the uncached batched step
    # and to the single-stream cached step of that stream.
    _, ts = _specs(FLOW)
    rois = [ROI, (40, 50, 40, 30), (60, 20, 40, 30)]
    clips = np.stack([_clip(np.float64)[:8],
                      _clip(np.float64)[:8][:, ::-1, ::-1].copy(),
                      _clip(np.float64)[1:9]])
    states_c = tstreams.init_stream_states(ts, rois, torch.float64,
                                           device="cpu")
    states_u = states_c
    cache = tstreams.init_fleet_cache(ts, 3, torch.float64, device="cpu")
    singles = [[tmotion.init_state(ts, r, torch.float64, device="cpu"),
                tmotion.init_flow_cache(ts, torch.float64, device="cpu")]
               for r in rois]
    for t in range(clips.shape[1]):
        frames = torch.from_numpy(clips[:, t])
        states_c, cache, s_c = tmotion.measure_step_cached(
            states_c, cache, frames, ts, t > 0, t > 0)
        states_u, s_u = tmotion.measure_step_batch(states_u, frames, ts,
                                                   t > 0)
        assert s_c.shape == (3,) and torch.equal(s_c, s_u)
        for k, one in enumerate(singles):
            one[0], one[1], s = tmotion.measure_step_cached(
                one[0], one[1], frames[k], ts, cache_valid=t > 0)
            assert torch.equal(s, s_c[k])
            assert all(torch.equal(a, b[k])
                       for a, b in zip(one[1].stacks, cache.stacks))
    assert _same_state(states_c, states_u)


# -- measure_step(initialized_hint=) -------------------------------------------

class _NoHostRead(torch.Tensor):
    """A tensor whose truth value must not be read on the host."""

    def __bool__(self):
        raise AssertionError("the host read state.initialized")


def test_measure_step_initialized_hint_matches_jax():
    js, ts = _specs(FLOW)
    frames = _clip(np.float64)[:6]
    tst = tmotion.init_state(ts, ROI, torch.float64, device="cpu")
    jst = jmotion.init_state(js, ROI, jnp.float64)
    for frame in frames[:4]:
        tst, _ = tmotion.measure_step(tst, torch.from_numpy(frame), ts)
        jst, _ = jmotion.measure_step(jst, jnp.asarray(frame), js)
    assert bool(tst.initialized)
    for frame in frames[4:]:
        hinted, s_h = tmotion.measure_step(tst, torch.from_numpy(frame), ts,
                                           initialized_hint=True)
        plain, s_p = tmotion.measure_step(tst, torch.from_numpy(frame), ts,
                                          initialized_hint=False)
        assert torch.equal(s_h, s_p) and _same_state(hinted, plain)
        jst, js_ = jmotion.measure_step(jst, jnp.asarray(frame), js,
                                        initialized_hint=True)
        np.testing.assert_allclose(float(s_h), float(js_), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(hinted.pts.numpy(), np.asarray(jst.pts),
                                   rtol=0, atol=1e-9)
        tst = hinted
    # The hint skips the host's read of ``initialized``; without it the
    # step reads it.
    frame = torch.from_numpy(frames[-1])
    unread = tst._replace(
        initialized=tst.initialized.clone().as_subclass(_NoHostRead))
    got, s = tmotion.measure_step(unread, frame, ts, initialized_hint=True)
    assert torch.equal(s, tmotion.measure_step(tst, frame, ts)[1])
    got, _, s_c = tmotion.measure_step_cached(unread, None, frame, ts,
                                              initialized_hint=True,
                                              cache_valid=False)
    assert torch.equal(s_c, s)
    with pytest.raises(AssertionError, match="host read"):
        tmotion.measure_step(unread, frame, ts)


# -- filtfilt, peak_indexes ----------------------------------------------------

COEFFS = tfilters.design_butter_lowpass(0.5, FPS, 3)
JCOEFFS = jfilters.design_butter_lowpass(0.5, FPS, 3)


@pytest.mark.parametrize("n", [20, 128])
def test_filtfilt_float64_matches_jax_and_scipy(n):
    x = np.random.default_rng(n).standard_normal(n)
    got = tfilters.filtfilt(COEFFS, torch.from_numpy(x)).numpy()
    want = np.asarray(jfilters.filtfilt(JCOEFFS, jnp.asarray(x)))
    ref = sps.filtfilt(np.asarray(COEFFS.b), np.asarray(COEFFS.a), x)
    assert got.shape == (n,) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_filtfilt_float32_rows_match_jax():
    _, y = motion_trace(num_samples=128 * 3, fps=FPS, bpm=18.0, noise=0.05)
    rows = np.asarray(y, np.float32).reshape(3, 128)
    got = tfilters.filtfilt(COEFFS, torch.from_numpy(rows)).numpy()
    assert got.shape == rows.shape and got.dtype == np.float32
    for r in range(3):
        want = np.asarray(jfilters.filtfilt(JCOEFFS, jnp.asarray(rows[r])))
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)
        assert np.array_equal(got[r], tfilters.filtfilt(
            COEFFS, torch.from_numpy(rows[r])).numpy())


def _peak_cases():
    rng = np.random.default_rng(7)
    t = np.arange(128) / FPS
    noisy = np.sin(2 * np.pi * 0.3 * t) + 0.3 * rng.standard_normal(128)
    stepped = np.round(noisy * 3) / 3          # plateaus everywhere
    plateau = np.zeros(128)
    plateau[40:44] = 1.0                      # a plateau peak
    plateau[80] = plateau[90] = 0.7           # an equal-height tie
    plateau[:3] = plateau[-3:] = 0.9          # plateaus at both edges
    short = np.array([0., 1., 1., 1., 0., 2., 2., 0., 3., 0., 0., 5., 5., 5.,
                      5., 0.])
    return [noisy, stepped, plateau, short, np.zeros(64)]


@pytest.mark.parametrize("min_dist,thres,max_peaks", [
    (1, 0.3, 32), (10, 0.3, 32), (3, 0.0, 8), (5, 0.6, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_peak_indexes_match_jax(min_dist, thres, max_peaks, dtype):
    for y in _peak_cases():
        y = y.astype(dtype)
        idx, mask = tpeaks.peak_indexes(torch.from_numpy(y), min_dist,
                                        thres=thres, max_peaks=max_peaks)
        want_idx, want_mask = jpeaks.peak_indexes(
            jnp.asarray(y), min_dist, thres=thres, max_peaks=max_peaks)
        assert idx.dtype == torch.int32 and idx.shape == (max_peaks,)
        assert np.array_equal(idx.numpy(), np.asarray(want_idx))
        assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    rows = np.stack([c.astype(dtype) for c in _peak_cases()[:3]])
    idx, mask = tpeaks.peak_indexes(torch.from_numpy(rows), min_dist,
                                    thres=thres, max_peaks=max_peaks)
    for r, y in enumerate(rows):
        one, one_mask = tpeaks.peak_indexes(torch.from_numpy(y), min_dist,
                                            thres=thres, max_peaks=max_peaks)
        assert torch.equal(idx[r], one) and torch.equal(mask[r], one_mask)


# -- gaussian_fit_single -------------------------------------------------------

def _windows(seed, noisy, count=12, width=20):
    """Masked Gaussian-peak windows as the BPM stage cuts them
    (``tests/test_torch_bpm.py``'s, lengths 2 to ``width``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        k = int(rng.integers(2, width + 1))
        ti = rng.uniform(0, 10) + np.arange(k) / FPS
        c = ti[0] + rng.uniform(0.2, 1.8) * (k / FPS) / 2
        sig = rng.uniform(0.5, 2.0) * np.exp(
            -(ti - c) ** 2 / (2 * rng.uniform(0.1, 0.6) ** 2))
        noise = rng.uniform(0.0, 0.3 if i % 4 else 1.0) if noisy else 0.0
        t, y, m = np.zeros(width), np.zeros(width), np.zeros(width, bool)
        t[:k], m[:k] = ti, True
        y[:k] = sig + noise * rng.standard_normal(k)
        out.append((t, y, m))
    return out


@functools.lru_cache(maxsize=None)
def _jax_fit(iters, ftol, xtol):
    return jax.jit(functools.partial(jgauss.gaussian_fit_single, iters=iters,
                                     ftol=ftol, xtol=xtol))


@pytest.mark.parametrize("dtype,noisy,iters,ftol,xtol", [
    (np.float32, False, 200, None, None),
    (np.float32, False, 200, 1e-3, 1e-2),
    (np.float32, True, 200, None, None),
    (np.float64, True, 500, None, None),
    (np.float64, True, 500, 1e-6, 1e-5),
    (np.float64, False, 500, None, None),
    (np.float64, False, 500, 1e-12, None)])
def test_gaussian_fit_single_matches_jax(dtype, noisy, iters, ftol, xtol):
    # Float64: clean windows to 1e-9; a noisy window's cost valley is flat
    # enough that exp()'s last bits move its minimum (up to 1.4e-7
    # relative on these windows), so those are held to 1e-6.
    if dtype == np.float64:
        atol, rtol = (1e-9, 1e-6) if noisy else (1e-9, 1e-9)
    else:
        atol, rtol = 1e-6, 1e-4
    for t, y, m in _windows(11 if noisy else 12, noisy):
        t, y = t.astype(dtype), y.astype(dtype)
        got = tgauss.gaussian_fit_single(
            torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(m),
            iters=iters, ftol=ftol, xtol=xtol)
        want = _jax_fit(iters, ftol, xtol)(jnp.asarray(t), jnp.asarray(y),
                                           jnp.asarray(m))
        assert got.converged.shape == () and got.ampl.dtype == _tdtype(dtype)
        assert bool(got.converged) == bool(want.converged)
        # Float32 parameters of noisy windows stop up to ~2% apart
        # (tests/test_torch_bpm.py): those are held by their decisions.
        if bool(want.converged) and (dtype == np.float64 or not noisy):
            for name in ("ampl", "center", "dev"):
                np.testing.assert_allclose(
                    float(getattr(got, name)), float(getattr(want, name)),
                    rtol=rtol, atol=atol, err_msg=name)


def test_gaussian_fit_single_is_the_batch_at_one_window():
    for t, y, m in _windows(11, True) + _windows(12, False):
        args = [torch.from_numpy(a.astype(np.float32)
                                 if a.dtype != bool else a)
                for a in (t, y, m)]
        one = tgauss.gaussian_fit_single(*args)
        batch = tgauss.gaussian_fit_batch(*(a[None] for a in args))
        for a, b in zip(one, batch):
            assert torch.equal(a, b[0])
    # The default tolerances, given explicitly, change no bit.
    t, y, m = _windows(11, True)[1]
    args = [torch.from_numpy(a) for a in (t, y, m)]
    assert all(torch.equal(a, b) for a, b in zip(
        tgauss.gaussian_fit_single(*args),
        tgauss.gaussian_fit_single(*args, ftol=1.49e-8, xtol=1.49e-8)))


# -- entry ---------------------------------------------------------------------

def test_entry_matches_graft_entry():
    fn, (buffer,) = tentry.entry(device="cpu")
    jfn, (jbuffer,) = __graft_entry__.entry()
    assert buffer.dtype == torch.float32 and buffer.device.type == "cpu"
    assert np.array_equal(buffer.numpy(), np.asarray(jbuffer))
    got, want = fn(buffer), jfn(jbuffer)
    assert bool(got[0]) and bool(want[0])
    assert [int(v) for v in got[1:5]] == [int(v) for v in want[1:5]]
    assert np.array_equal(got[5].numpy(), np.asarray(want[5]))
