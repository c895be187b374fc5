"""Time the calibration locate and the fleet's streaming localize on
several trees of this repository, one process per tree, one after
another, on one card.

    python3 tools/locate_ab.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``respmon_tpu_torch`` (this
repository's root, or an unpacked ``git archive`` of another commit);
give them in an order such as A B B A so that a drift of the host shows.
Every tree times, on the host clock with a synchronise after each call:

- ``evm.locate`` of a 640x480 u8 clip, T = 128 (``chip_smoke.py``'s
  fixture), 5 warm-up calls and 30 timed;
- ``evm.locate`` of a 1080p u8 clip, T = 128 (``chip_smoke.py``'s 1080p
  fixture), 2 warm-up calls and 10 timed, and the device memory one call
  allocates above what it was given (``max_memory_allocated``);
- ``streaming.localize_batch`` of 64 streams of full 1080p rings
  (``chip_smoke.py``'s 64 x 1080p fleet: the 1080p clip tiled over the
  streams, coarse), 1 warm-up call and 3 timed.

A tree whose ``evm`` has ``_tmean`` also times it against
``Tensor.mean(dim=0)`` on the suppress-top maps of the three calls (CUDA
events, median of 20).  Prints one JSON line per tree and, last, whether
every tree found the same boxes.  ``--device cpu`` rehearses the
children on the CPU (no memory or event timing).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

FPS = 10.0
FLEET = 64

CHILD = r"""
import json, statistics, sys, time
import numpy as np
import torch
import respmon_tpu_torch
from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.parallel import streams
from respmon_tpu_torch.pipeline import evm, streaming

dev = torch.device(sys.argv[5])
cuda = dev.type == "cuda"
vga = torch.from_numpy(np.load(sys.argv[1])).to(dev)
hd = torch.from_numpy(np.load(sys.argv[2])).to(dev)
fps, fleet = float(sys.argv[3]), int(sys.argv[4])
cfg = CalibrationConfig()


def sync():
    if cuda:
        torch.cuda.synchronize()


def timed(fn, warm, n):
    for _ in range(warm):
        out = fn()
    sync()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def box(r):
    return [int(v) for v in (r.found, r.x, r.y, r.w, r.h)]


out = {"source": respmon_tpu_torch.__file__}
res, out["locate_vga_ms"] = timed(lambda: evm.locate(vga, fps, cfg), 5, 30)
out["box_vga"] = box(res)
res, out["locate_1080p_ms"] = timed(lambda: evm.locate(hd, fps, cfg), 2, 10)
out["box_1080p"] = box(res)
del res
if cuda:
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    evm.locate(hd, fps, cfg)
    sync()
    out["locate_1080p_peak_above_input_gb"] = (
        torch.cuda.max_memory_allocated() - base) / 1e9

rings = streams.init_fleet_streaming_from_buffers(
    hd[None].expand((fleet,) + tuple(hd.shape)), cfg)
loc, out["localize_64x1080p_ms"] = timed(
    lambda: streaming.localize_batch(rings, tuple(hd.shape[1:]),
                                     torch.float32, fps, cfg, True), 1, 3)
out["boxes_64x1080p"] = torch.stack(
    [loc.found.int(), loc.x, loc.y, loc.w, loc.h]).cpu().tolist()
del rings, loc

if cuda and hasattr(evm, "_tmean"):
    def events(fn):
        ms = []
        for _ in range(21):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms[1:])

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = cfg.buffer_length
    shapes = {"vga": (t, 480, 640), "1080p": (t, 1080, 1920),
              "fleet_64x1080p_coarse": (t, fleet, 68, 120)}
    out["tmean_vs_mean_ms"] = {}
    for name, shape in shapes.items():
        x = torch.rand(shape, generator=gen, device="cuda")
        out["tmean_vs_mean_ms"][name] = [events(lambda: evm._tmean(x)),
                                         events(lambda: x.mean(dim=0))]
        del x
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np

    from respmon_tpu_torch.io.synthetic import breathing_clip

    def u8(clip):
        return np.clip(np.round(clip * 255.0), 0, 255).astype(np.uint8)

    vga = u8(breathing_clip(num_frames=128, height=480, width=640, fps=FPS,
                            bpm=18.0, patch_center=(240, 320),
                            patch_size=(80, 100), amplitude=0.12,
                            motion_px=2.0, texture_motion=True))
    hd = u8(breathing_clip(num_frames=128, height=1080, width=1920, fps=FPS,
                           bpm=18.0, patch_center=(540, 960),
                           patch_size=(180, 225), amplitude=0.12))
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    runs = []
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        paths = [os.path.join(tmp, f"{n}.npy") for n in ("vga", "hd")]
        np.save(paths[0], vga)
        np.save(paths[1], hd)
        del vga, hd
        for tree in args.trees:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            out = subprocess.run(
                [sys.executable, "-c", CHILD, *paths, str(FPS), str(FLEET),
                 args.device],
                env=env, cwd=os.path.abspath(tree), check=True,
                capture_output=True, text=True).stdout
            run = json.loads(out.strip().splitlines()[-1])
            row = {"tree": tree, "source": run.pop("source")}
            for key in [k for k in run if k.endswith("_ms")
                        and isinstance(run[k], list)]:
                ms = sorted(run.pop(key))
                row[key] = {"median": statistics.median(ms),
                            "p95": ms[int(0.95 * (len(ms) - 1))],
                            "min": ms[0], "max": ms[-1]}
            row.update(run)
            print(json.dumps(row), flush=True)
            runs.append(row)
    same = len({json.dumps([r["box_vga"], r["box_1080p"],
                            r["boxes_64x1080p"]]) for r in runs}) == 1
    print(json.dumps({"same_boxes": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
