"""Small CPU runs of the benchmark's cells for its tests."""

import copy
import time

import pytest
import torch

from benchmark.harness import cells

# At 120x160 a 64-frame calibration over 6 levels finds the subject, and a
# larger patch moving 1.5 px keeps LK's points; a single steady subject
# breathes at 24 BPM into a 48-sample signal ring, so the window's
# estimates give BPMs (the cells' own sizes are for the card).
TRAFFIC = {"patch_frac": [0.25, 0.25], "motion_frac": 0.0125,
           "checks": {"calibrations": 3, "steps": 3}}
RING = 48
SINGLE_RATE = {"rates_bpm": [24.0]}


def small(name: str, streams: int = 3):
    """(sizes, traffic) overrides that make cell ``name`` small."""
    conf = copy.deepcopy(cells.cell(name)["config_data"])
    conf["frame_hw"] = [120, 160]
    conf["monitor"]["calibration"].update(
        buffer_length=64, pyramid_levels=6, skip_levels_at_top=2)
    conf["monitor"]["measure"]["buffer_length"] = RING
    traffic = dict(TRAFFIC)
    if conf["system"] == "fleet":
        conf["streams"] = streams
    elif "rates_bpm" in cells.cell(name)["traffic_data"]:
        traffic.update(SINGLE_RATE)
    return conf, traffic


def run_small(name: str, seed: int = 7, seconds: float = 1.0,
              trace: bool = False, device="cpu"):
    sizes, traffic = small(name)
    return cells.execute(name, seed, seconds, trace, device, time.time(),
                         sizes=sizes, traffic=traffic)


@pytest.fixture
def card():
    """The card, for the tests that need one; skips without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)
