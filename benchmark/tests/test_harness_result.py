"""The result line has exactly the contract's keys, ``checks`` last."""

import json

import pytest

from benchmark import run
from benchmark.tests.conftest import run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,trace", [("cam640.recover", False),
                                        ("cam640.recover", True),
                                        ("cam640.flow", False),
                                        ("fleet64_1080p.flow", False)])
def test_result_line(name, trace):
    out, _ = run_small(name, trace=trace, seconds=1.5)
    line = run.result_line(out)
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) == set(KEYS) | {"checks"} | ({"breakdown"} if trace
                                                  else set())
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert "idle_pct.recover" in line["metrics"]
    else:
        assert "setup_s" in line["metrics"]
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"}
    json.loads(json.dumps(line))
