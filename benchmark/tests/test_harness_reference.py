"""The plain reference agrees with the program at small sizes on the CPU:
the calibration box, the flow step's samples and the BPM estimate."""

import numpy as np
import pytest
import torch

from benchmark.harness import frames as gen
from benchmark.reference import config as rconfig
from benchmark.reference import system as ref
from respmon_tpu_torch.config import CalibrationConfig, MeasureConfig, \
    MonitorConfig
from respmon_tpu_torch.ops import filters
from respmon_tpu_torch.pipeline import bpm, evm, motion

TRAFFIC = {"rates_bpm": [18.75], "positions_per_rate": 1,
           "patch_frac": [0.25, 0.25], "center_frac": [[0.3, 0.7],
                                                      [0.3, 0.7]],
           "amplitude": 0.12, "motion_frac": 0.0125, "noise": 0.005}
HW = (120, 160)


def _clip(seed, n):
    subj = gen.subjects(TRAFFIC, seed, HW, 10.0)
    pool = gen.make_pools(subj, TRAFFIC, HW, seed, "cpu")[0]
    return pool[torch.arange(n) % len(pool)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_locate_box(seed):
    cal = CalibrationConfig(buffer_length=64, pyramid_levels=6,
                            skip_levels_at_top=2)
    rcal = rconfig.CalibrationConfig(buffer_length=64, pyramid_levels=6,
                                     skip_levels_at_top=2)
    clip = _clip(seed, 64)
    got = evm.locate(clip, 10.0, cal)
    want, heat = ref.locate(clip, 10.0, rcal)
    assert bool(got.found) and want[0]
    assert (int(got.x), int(got.y), int(got.w), int(got.h)) == want[1:]
    assert torch.equal(got.heatmap_u8, heat)


@pytest.mark.parametrize("seed", [1, 2])
def test_flow_steps_and_estimate(seed):
    cfg = MonitorConfig(motion_extraction_method="flow")
    rcfg = rconfig.MonitorConfig(motion_extraction_method="flow")
    clip = _clip(seed, 40)
    box = (50, 30, 50, 50)
    spec = motion.MeasureSpec.for_roi(cfg, *HW, box[2], box[3], 10.0)
    rspec = ref.FlowSpec(frame_h=HW[0], frame_w=HW[1], crop_h=spec.crop_h,
                         crop_w=spec.crop_w, buffer_length=128,
                         features=rcfg.features, lk=rcfg.lk)
    state = motion.init_state(spec, box, device="cpu")
    rstate = None
    coeffs = filters.design_butter_lowpass(0.5, 10.0, 3)
    prev = None
    for i in range(len(clip)):
        s0 = state
        state, sample = motion.measure_step(state, clip[i], spec)
        fields = ref.FlowState(*(x[None] for x in (
            s0.roi, s0.initialized, s0.pts, s0.pts_valid, s0.motion_xy,
            s0.motion_count)))
        step = ref.flow_step(prev, clip[i][None], fields, rspec)
        assert float(step.sample[0]) == float(sample), i
        own = ref.flow_step(prev, clip[i][None], rstate or fields, rspec)
        rstate = own.state
        assert float(own.sample[0]) == float(sample), i
        prev = clip[i][None]
    res = bpm.estimate_bpm(state.data[None], state.t[None],
                           state.count[None], coeffs, 10, cfg.measure)
    has, val = ref.estimate(state.data[None], state.t[None],
                            state.count[None], 10.0, rcfg.calibration,
                            rcfg.measure)
    assert bool(res.has_bpm[0]) == bool(has[0])
    assert float(res.bpm[0]) == float(val[0])


def test_estimate_on_rings():
    rng = np.random.default_rng(5)
    n = 128
    t = np.arange(n, dtype=np.float32) / 10.0
    rings = np.stack([np.sin(2 * np.pi * f * t + p)
                      + 0.05 * rng.standard_normal(n)
                      for f, p in ((0.25, 0.3), (0.31, 1.0), (0.4, 2.0))])
    data = torch.from_numpy(rings.astype(np.float32))
    tt = torch.from_numpy(t).expand(3, n).clone()
    count = torch.tensor([n, 90, 40], dtype=torch.int32)
    m = MeasureConfig()
    res = bpm.estimate_bpm(data, tt, count,
                           filters.design_butter_lowpass(0.5, 10.0, 3), 10, m)
    has, val = ref.estimate(data, tt, count, 10.0,
                            rconfig.CalibrationConfig(),
                            rconfig.MeasureConfig())
    assert torch.equal(res.has_bpm, has)
    assert torch.equal(torch.where(has, res.bpm, 0.0),
                       torch.where(has, val, 0.0))
