"""Run one cell of the benchmark of respmon_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``respmon_tpu_torch``.  Set-up makes the cell's frames from the seed,
calibrates and warms the program; the window then drives it closed-loop
for ``--seconds``; after the window the program's outputs are held against
the plain reference (``benchmark/reference``).  With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy seconds and a breakdown.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown``), and last
``checks``, each compared number beside its limit; the last lines of
standard error repeat those numbers.

It exits non-zero and prints no result without a CUDA device, and when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``respmon_tpu`` is
loaded once the window has closed.
"""

import os
import time

T_START = time.time()
# One host thread for PyTorch's and the libraries' CPU work: their idle
# worker threads spin on the cores the launching thread needs.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "respmon_tpu")


def forbidden_modules(names) -> list:
    """Top-level names (before the first dot, compared whole) among
    ``names`` that the benchmark's process may not hold."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    cache = ROOT / "build" / "bench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def result_line(out: dict) -> dict:
    """The result's JSON object: the contract's keys, ``breakdown`` with a
    trace, and ``checks`` last."""
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch

    from benchmark.harness import cells

    c = cells.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(c["chips"]):
        print(f"{args.workload} needs {c['chips']} CUDA device(s); {found} "
              "found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    # The monitor warns once a cycle of the recovery traffic; keep the
    # output to the result and its checks.
    logging.getLogger("respmon_tpu_torch").setLevel(logging.ERROR)
    out, run = cells.execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda:0", T_START)
    del run
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    result = result_line(out)
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
