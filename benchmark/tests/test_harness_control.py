"""The control (the reference in TF32 put in the program's place) comes
out as not correct under each cell's limits, on the card at a small size;
the full-size readings come from ``benchmark/control.py``."""

import pytest

from benchmark.harness import check
from benchmark.tests.conftest import run_small


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cam640.flow", "fleet64_1080p.flow",
                                  "cam640.recover"])
def test_control_fails(card, name):
    out, run = run_small(name, device=card, seconds=2.0)
    assert out["correct"], out["checks"]
    control = check.readings(run, "control", run.traffic.get("checks"))
    ok, _ = check.judge(control, run.cell["limits"])
    assert not ok, control
