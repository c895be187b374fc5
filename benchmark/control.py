"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set
from: for each seed, one run of the cell (set-up and a short window at the
cell's own size and load) and every compared number twice, the program's
against the reference and the control's (the reference computed in TF32,
put in the program's place) against the reference.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10

One process runs all the seeds; each prints one JSON line
``{"seed", "program": {...}, "control": {...}}``.  The benchmark's own
runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    import logging

    import torch

    from benchmark.harness import cells, check

    logging.getLogger("respmon_tpu_torch").setLevel(logging.ERROR)

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out, run = cells.execute(args.workload, seed, args.seconds, False,
                                 "cuda:0", t0)
        control = check.readings(run, "control",
                                 run.traffic.get("checks"))
        print(json.dumps({"seed": seed,
                          "program": {k: v["value"]
                                      for k, v in out["checks"].items()},
                          "control": control,
                          "metrics": {k: v["value"]
                                      for k, v in out["metrics"].items()},
                          "seconds": time.time() - t0}), flush=True)
        del out, run
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
