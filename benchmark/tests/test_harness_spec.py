"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it resolves to its files."""

import json
import re
import subprocess
import sys

import pytest

from benchmark.harness import cells, drive

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = cells.benchmark_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("benchmark/")
    data = cells.load_json(ROOT / entry["file"])
    assert data["system"] in drive.SYSTEMS
    assert data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
    assert 1 <= len(entry["source"]) <= 200 and "\n" not in entry["source"]


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_workloads_resolve(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200
    c = cells.cell(entry["name"])
    kind = drive.kind_module(c["traffic_data"]["kind"])
    assert c["config_data"]["system"] in kind.SYSTEMS
    for fn in ("source", "warm", "unit_ends", "after_step", "end_to_end",
               "readings"):
        assert callable(getattr(kind, fn)), fn
    assert c["limits"]
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]


@pytest.mark.parametrize("entry", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entries(entry):
    keys = {"name", "unit", "better", "source"}
    if entry in SPEC["end_to_end"]:
        keys |= {"bound"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert callable(cells.metric_reader(entry["name"]))
    assert set(entry) - {"workloads"} == keys
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    work = {w["name"] for w in SPEC["workloads"]}
    assert set(entry.get("workloads", work)) <= work


def test_harness_names_no_kind():
    """The harness dispatches on no traffic kind: each lives in
    ``benchmark/kinds/<kind>.py``, found by the name in its traffic file."""
    kinds = [p.stem for p in (cells.BENCH / "kinds").glob("*.py")
             if p.stem != "__init__"]
    assert kinds
    for path in (cells.BENCH / "harness").glob("*.py"):
        text = path.read_text()
        for kind in kinds:
            assert f'"{kind}"' not in text and f"'{kind}'" not in text, \
                (path.name, kind)


def test_per_layer_cells_report_what_they_move():
    for m in SPEC["per_layer"]:
        for w in m["workloads"]:
            reported = {e["name"] for e in cells.cell(w)["end_to_end"]}
            assert m["moves"] in reported


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    names = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_under_paths_are_named_from_names():
    files = subprocess.run(["git", "ls-files", "--others", "--cached",
                            "--exclude-standard", "benchmark"], cwd=ROOT,
                           capture_output=True, text=True).stdout.split()
    for f in files:
        assert re.match(r"^[A-Za-z0-9_./\-]+$", f), f


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: run.py would run the cell")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cam640.flow",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
