"""Time the live monitor's flow motion step on several trees of this
repository, one process per tree, one after another, on one card.

    python3 tools/motion_step_ab.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``respmon_tpu_torch`` (this
repository's root, or an unpacked ``git archive`` of another commit);
give them in an order such as A B B A so that a drift of the host shows.
Every tree steps ``respmon_tpu_torch.pipeline.motion.measure_step`` in flow
mode over the same 640x480 u8 clip (``chip_smoke.py``'s fixture, 18 BPM,
its calibrated ROI), as ``RespiratoryMonitor`` does on a measured frame:
a host frame in, one step, then a synchronise (``chip_smoke.py``'s split
timer ends each motion step the same way).  The first step detects the
corners and the next five warm up; the following 80 are timed
on the host clock.  Prints one JSON line per tree (median, p95 and max ms)
and fails unless every tree gives the same samples bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROI = (255, 188, 130, 107)   # the fixture's calibrated (x, y, w, h)
FPS = 10.0
WARMUP = 5
STEPS = 80

CHILD = r"""
import json, sys, time
import numpy as np
import torch
import respmon_tpu_torch
from respmon_tpu_torch.config import MonitorConfig
from respmon_tpu_torch.pipeline import motion

clip = np.load(sys.argv[1])
roi, fps, warm = json.loads(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4])
cfg = MonitorConfig(motion_extraction_method="flow")
spec = motion.MeasureSpec.for_roi(cfg, clip.shape[1], clip.shape[2],
                                  roi[2], roi[3], fps)
state = motion.init_state(spec, roi, device="cuda")
samples, ms = [], []
for i, frame in enumerate(clip):
    t0 = time.perf_counter()
    state, sample = motion.measure_step(state, frame, spec)
    torch.cuda.synchronize()
    if i > warm:
        ms.append((time.perf_counter() - t0) * 1e3)
    samples.append(float(sample))
print(json.dumps({"source": respmon_tpu_torch.__file__, "ms": ms,
                  "samples": samples}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from respmon_tpu_torch.io.synthetic import breathing_clip

    import numpy as np

    clip = breathing_clip(num_frames=1 + WARMUP + STEPS, height=480,
                          width=640, fps=FPS, bpm=18.0,
                          patch_center=(240, 320), patch_size=(80, 100),
                          amplitude=0.12, motion_px=2.0, texture_motion=True)
    clip = np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)
    runs = []
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        path = os.path.join(tmp, "clip.npy")
        np.save(path, clip)
        for tree in args.trees:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            out = subprocess.run(
                [sys.executable, "-c", CHILD, path, json.dumps(ROI),
                 str(FPS), str(WARMUP)],
                env=env, cwd=os.path.abspath(tree), check=True,
                capture_output=True, text=True).stdout
            run = json.loads(out.strip().splitlines()[-1])
            ms = sorted(run["ms"])
            print(json.dumps({
                "tree": tree, "source": run["source"], "steps": len(ms),
                "median_ms": statistics.median(ms),
                "p95_ms": ms[int(0.95 * (len(ms) - 1))],
                "max_ms": ms[-1]}), flush=True)
            runs.append(run)
    same = len({json.dumps(r["samples"]) for r in runs}) == 1
    print(json.dumps({"same_samples": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
