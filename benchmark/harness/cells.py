"""Find a cell's files by the names ``BENCHMARK.json`` gives, run it, and
turn the run into the result's metrics.

- a configuration: ``configs[].file`` (JSON: the system, its sizes, the
  ``MonitorConfig`` as run);
- a traffic mix: ``benchmark/traffic/<traffic>.json`` (parameters of the
  one generator, ``harness/frames.py``, and of its kind), whose ``kind``
  names ``benchmark/kinds/<kind>.py``: the frames, set-up's steps, the
  unit of the window's work, its end-to-end values and the compared
  numbers;
- a per-layer metric: ``benchmark/metrics/<name>.py``, whose ``read(trace)``
  gives the number or None;
- the limits of the compared numbers: ``benchmark/limits/<cell>.json``.

Adding a configuration, a traffic mix or kind, a cell or a per-layer
metric adds files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.harness import check, drive, timing

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, spec: dict = None) -> dict:
    """The workload entry ``name`` with its configuration, traffic and
    limits read, and the metrics it reports."""
    spec = spec or benchmark_spec()
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(work[name])
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    w["config_data"] = load_json(ROOT / conf["file"])
    w["traffic_data"] = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    w["limits"] = load_json(BENCH / "limits" / f"{name}.json")
    w["end_to_end"] = [m for m in spec["end_to_end"]
                       if name in m.get("workloads", [name])]
    reported = {m["name"] for m in w["end_to_end"]}
    w["per_layer"] = [m for m in spec["per_layer"]
                      if name in m.get("workloads", [name])
                      and m["moves"] in reported]
    return w


def metric_reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def end_to_end(run, cell_: dict, setup_s: float):
    """The cell's end-to-end metrics, read off the window by the host's
    clock as the traffic's kind reads them.  Returns (metrics, attempted,
    failed)."""
    values, attempted, failed = run.kind.end_to_end(run)
    values["setup_s"] = setup_s
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell_["end_to_end"]}
    return metrics, attempted, failed


def per_layer(cell_: dict, trace) -> dict:
    out = {}
    for m in cell_["per_layer"]:
        v = metric_reader(m["name"])(trace)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(profile: dict) -> dict:
    top = sorted(profile["kernels_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(profile["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, sizes: dict = None, traffic: dict = None):
    """One run of cell ``name``: set-up, the window, the check.  Returns
    the result's fields (``checks`` last) and the run.  ``sizes`` and
    ``traffic`` override entries of the cell's files (small CPU runs)."""
    c = cell(name)
    run = drive.make_run(c, seed, device, sizes, traffic)
    run.setup()
    if trace and run.device.type == "cuda":
        # The profiler's own first start, outside the window.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=run.device).add_(1)
        torch.cuda.synchronize(run.device)
    setup_s = time.time() - t_start
    profile, timed, traced = drive.window(run, seconds, trace)
    e2e, attempted, failed = end_to_end(run, c, setup_s)
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(run.device)
              if run.device.type == "cuda" else "cpu",
              "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                  run.device)) if run.device.type == "cuda" else 0}
    run.release()
    out = {"attempted": attempted, "failed": failed, "device": device}
    if trace:
        tr = SimpleNamespace(spans=timed, profile=profile,
                             k1_calls=traced.calls.get("k1", []),
                             run=run, bound=timing.k1_bound,
                             k1_seconds=timing.k1_seconds)
        out["metrics"] = per_layer(c, tr)
        device["busy_s"] = profile["busy_s"]
        device["window_s"] = profile["window_s"]
        out["breakdown"] = breakdown(profile)
    else:
        out["metrics"] = e2e
    values = check.readings(run, "program", run.traffic.get("checks"))
    ok, rows = check.judge(values, c["limits"])
    out["correct"] = ok
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out, run
