"""The port's own copies (config, utils/bbox, io/synthetic) against the
JAX package's, the config bridge in interop, the port's independence from
``jax`` and ``respmon_tpu``, and the default device of its entry points."""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from respmon_tpu import config as jconfig
from respmon_tpu.io import synthetic as jsyn
from respmon_tpu.utils.bbox import reduce_bounding_box as jreduce
import respmon_tpu_torch
from respmon_tpu_torch import config as tconfig
from respmon_tpu_torch import device as tdevice
from respmon_tpu_torch import interop
from respmon_tpu_torch.io import synthetic as tsyn
from respmon_tpu_torch.ops import dtype as tdtype
from respmon_tpu_torch.parallel import launch
from respmon_tpu_torch.parallel import mesh as tmesh
from respmon_tpu_torch.parallel import streams as tstreams
from respmon_tpu_torch.pipeline import motion as tmotion
from respmon_tpu_torch.pipeline import scan as tscan
from respmon_tpu_torch.utils.bbox import reduce_bounding_box as treduce

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["FeatureParams", "LKParams", "CalibrationConfig",
           "MeasureConfig", "MonitorConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_classes_mirror_the_jax_package(name):
    ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
    fo, ft = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in fo] == [f.name for f in ft]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours(), fo[0].name, None)
    hash(ours())


@pytest.mark.parametrize("name", CLASSES)
def test_config_from_reference_round_trip(name):
    theirs = getattr(jconfig, name)()
    got = interop.config_from_reference(theirs)
    assert type(got) is getattr(tconfig, name)
    assert interop.config_to_dict(got) == interop.config_to_dict(theirs)


def test_config_from_reference_keeps_values_and_nests():
    theirs = jconfig.MonitorConfig(
        motion_extraction_method="flow", roi_bucket=16, fleet_exact_lk=True,
        calibration=jconfig.CalibrationConfig(buffer_length=64,
                                              pyramid_levels=6),
        lk=jconfig.LKParams(win_size=(11, 11), max_iters=7))
    got = interop.config_from_reference(theirs)
    assert type(got.calibration) is tconfig.CalibrationConfig
    assert type(got.lk) is tconfig.LKParams
    assert got.lk.win_size == (11, 11) and got.lk.max_iters == 7
    assert got.calibration.buffer_length == 64 and got.roi_bucket == 16
    assert interop.config_to_dict(got) == dataclasses.asdict(theirs)
    assert got.validate() is got
    assert got.peak_minimum_sample_distance(25.0) == \
        theirs.peak_minimum_sample_distance(25.0)


def test_config_from_reference_rejects_unknown_and_missing():
    @dataclasses.dataclass(frozen=True)
    class LKParams:            # a field too many
        win_size: tuple = (15, 15)
        max_level: int = 2
        max_iters: int = 10
        epsilon: float = 0.03
        extra: int = 0

    with pytest.raises(TypeError, match="unknown"):
        interop.config_from_reference(LKParams())

    @dataclasses.dataclass(frozen=True)
    class FeatureParams:       # a field too few
        max_corners: int = 100

    with pytest.raises(TypeError, match="missing"):
        interop.config_from_reference(FeatureParams())

    @dataclasses.dataclass(frozen=True)
    class Other:
        x: int = 0

    with pytest.raises(TypeError, match="no port config class"):
        interop.config_from_reference(Other())
    with pytest.raises(TypeError):
        interop.config_from_reference({"max_corners": 100})
    with pytest.raises(AssertionError):
        tconfig.MonitorConfig(motion_extraction_method="x").validate()


@pytest.mark.parametrize("kwargs", [
    dict(num_frames=6, height=48, width=64),
    dict(num_frames=5, height=40, width=56, motion_px=2.0, seed=3),
    dict(num_frames=5, height=40, width=56, motion_px=2.0,
         texture_motion=True, patch_center=(20, 30), patch_size=(12, 16)),
    dict(num_frames=4, height=32, width=32, drift_px=(3.0, -2.0), noise=0.0,
         dtype=np.float64),
])
def test_breathing_clip_equals_the_jax_package(kwargs):
    got, want = tsyn.breathing_clip(**kwargs), jsyn.breathing_clip(**kwargs)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_motion_trace_and_reduce_bounding_box_equal_the_jax_package():
    for kw in (dict(), dict(num_samples=50, fps=25.0, bpm=12.0, seed=4)):
        for a, b in zip(tsyn.motion_trace(**kw), jsyn.motion_trace(**kw)):
            assert np.array_equal(a, b)
    for box in [(10, 20, 100, 80, float("inf")), (10, 20, 100, 80, 2000.0),
                (0, 0, 7, 5, 12.5)]:
        assert treduce(*box) == jreduce(*box)


def _port_sources():
    root = os.path.join(REPO, "respmon_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


def test_no_port_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|respmon_tpu)(\.|\s|$)", re.M)
    paths = _port_sources()
    assert len(paths) > 20
    assert os.path.join(REPO, "respmon_tpu_torch", "pipeline",
                        "streaming.py") in paths
    for part in (("parallel", "streams.py"), ("parallel", "__init__.py"),
                 ("runtime", "fleet_feeder.py"), ("runtime", "checkpoint.py"),
                 ("parallel", "mesh.py"), ("parallel", "temporal.py"),
                 ("parallel", "spatial.py"), ("parallel", "launch.py"),
                 ("parallel", "dryrun.py")):
        assert os.path.join(REPO, "respmon_tpu_torch", *part) in paths
    for path in paths:
        with open(path) as fh:
            hit = pattern.search(fh.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_test_modules_with_rank_functions_import_no_jax_at_top():
    # A spawned rank imports the module of its function: these import JAX
    # inside their tests only (their ranks check sys.modules as well).
    pattern = re.compile(r"^(from|import)\s+(jax|jaxlib|respmon_tpu)(\.|\s|$)",
                         re.M)
    for name in ("test_torch_parallel.py", "test_torch_checkpoint.py"):
        with open(os.path.join(REPO, "tests", name)) as fh:
            hit = pattern.search(fh.read())
        assert hit is None, f"{name}: {hit.group(0)!r}"


def test_importing_every_port_module_loads_neither_jax_nor_the_jax_package():
    names = ["respmon_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(respmon_tpu_torch.__path__,
                                              "respmon_tpu_torch.")]
    assert "respmon_tpu_torch.ops.lk" in names
    assert "respmon_tpu_torch.pipeline.streaming" in names
    assert "respmon_tpu_torch.parallel.streams" in names
    assert "respmon_tpu_torch.runtime.fleet_feeder" in names
    for name in ("runtime.checkpoint", "parallel.mesh", "parallel.temporal",
                 "parallel.spatial", "parallel.launch", "parallel.dryrun"):
        assert "respmon_tpu_torch." + name in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'respmon_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("ok")


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def _small_clip():
    return tsyn.breathing_clip(num_frames=40, height=48, width=64,
                               patch_center=(24, 32), patch_size=(12, 16),
                               amplitude=0.12)


SMALL_CFG = tconfig.MonitorConfig(calibration=tconfig.CalibrationConfig(
    buffer_length=32, pyramid_levels=4, skip_levels_at_top=1))


def _no_card_calls():
    spec = tmotion.MeasureSpec.for_roi(SMALL_CFG, 48, 64, 16, 12, 10.0)
    clip = _small_clip()
    return {
        "resolve": lambda: tdevice.resolve(None),
        "resolve_cpu_tensor": lambda: tdevice.resolve(None, torch.zeros(2)),
        "ingest_numpy": lambda: tdtype.ingest_frames(clip),
        "ingest_cpu_tensor": lambda: tdtype.ingest_frames(
            torch.from_numpy(clip)),
        "process_clip": lambda: tscan.process_clip(clip, 10.0, SMALL_CFG),
        "process_clip_cpu_tensor": lambda: tscan.process_clip(
            torch.from_numpy(clip), 10.0, SMALL_CFG),
        "process_clip_auto": lambda: tscan.process_clip_auto(
            clip, 10.0, SMALL_CFG),
        "init_state": lambda: tmotion.init_state(spec, (0, 0, 16, 12)),
        "measure_state_from_numpy": lambda: interop.measure_state_from_numpy(
            interop.measure_state_to_numpy(
                tmotion.init_state(spec, (0, 0, 16, 12), device="cpu"))),
        "multi_stream_monitor": lambda: tstreams.MultiStreamMonitor(
            SMALL_CFG, None, (48, 64), 10.0),
        "init_stream_states": lambda: tstreams.init_stream_states(
            spec, [(0, 0, 16, 12)] * 2),
        "init_fleet_streaming": lambda: tstreams.init_fleet_streaming(
            (48, 64), SMALL_CFG.calibration, 2),
        "make_mesh": lambda: _one_rank_mesh(),
        "flow_cache_from_numpy": lambda: interop.flow_cache_from_numpy(
            interop.flow_cache_to_numpy(
                tmotion.init_flow_cache(spec, device="cpu"))),
    }


def _one_rank_mesh():
    with launch.single_rank("gloo"):
        tmesh.make_mesh()


@pytest.mark.parametrize("entry", sorted(_no_card_calls()))
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _no_card_calls()[entry]()


def test_device_resolve_takes_what_it_is_given():
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.resolve(torch.device("cpu"),
                           torch.zeros(1)) == torch.device("cpu")
    assert tdevice.resolve("cuda:0") == torch.device("cuda", 0)
    got = tscan.process_clip(_small_clip(), 10.0, SMALL_CFG, device="cpu")
    assert got.found and got.measure.samples.device.type == "cpu"
