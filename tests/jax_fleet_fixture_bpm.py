"""The tail-median BPM that the JAX package's fleet and the port's fleet
read on ``chip_smoke.py``'s 640x480 fleet fixture.

    JAX_PLATFORMS=cpu python3 tests/jax_fleet_fixture_bpm.py \
        --bpms 12 15 18 21 --measured 96 --runs jax port-cpu
    python3 tests/jax_fleet_fixture_bpm.py --runs port-cuda --dump DIR

A script, not a test (pytest collects only ``test_*.py``): it shows how the
reference's estimator reads the fixture that ``phase_fleet`` holds the port
to.  The clips are ``chip_smoke.fleet_clips``' (stream i at its centre and
seed, at the rates given), u8: frame 0, 128 calibration frames, 1 dropped,
then ``--measured`` frames.  The streams run as one fleet in flow mode
(float32), as ``phase_fleet`` runs them: through
``respmon_tpu.parallel.streams.MultiStreamMonitor`` (``mesh=None``, run
``jax``; JAX is imported for it alone), and through the port's on the CPU
(``port-cpu``) or on the card (``port-cuda``): ``calibrate`` on frames
1..128, one ``step`` per measured frame, and, as ``phase_fleet`` reads it,
each stream's median of its last 10 BPM readings.  Prints one JSON line per
stream with every run's reading, and the first step at which each run's
samples leave the first run's.  ``--dump DIR`` saves each run's per-step
(samples, BPM, has_bpm, error) as ``DIR/<run>.npy``; ``--compare FILE``
adds a saved run (a card run read back on the CPU, say).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tail_median(bpm, has) -> float | None:
    got = bpm[has]
    return float(np.median(got[-10:])) if got.size else None


def run_jax(clips, cal_len, fps):
    import jax.numpy as jnp

    from respmon_tpu.config import MonitorConfig
    from respmon_tpu.parallel import streams

    mon = streams.MultiStreamMonitor(
        MonitorConfig(motion_extraction_method="flow"), None,
        clips.shape[2:], fps, dtype=jnp.float32)
    mon.calibrate(clips[:, 1:cal_len + 1])
    rows = []
    for f in range(cal_len + 2, clips.shape[1]):
        res = mon.step(clips[:, f])
        rows.append(np.stack([np.asarray(getattr(res, k), np.float64)
                              for k in ("samples", "bpm", "has_bpm",
                                        "error")]))
    return np.stack(rows)


def run_port(clips, cal_len, fps, device):
    import torch

    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.parallel import streams

    mon = streams.MultiStreamMonitor(
        MonitorConfig(motion_extraction_method="flow"), None,
        clips.shape[2:], fps, dtype=torch.float32, device=device)
    frames = torch.from_numpy(clips).to(device)
    mon.calibrate(frames[:, 1:cal_len + 1])
    rows = []
    for f in range(cal_len + 2, clips.shape[1]):
        res = mon.step(frames[:, f])
        rows.append(torch.stack([getattr(res, k).double() for k in (
            "samples", "bpm", "has_bpm", "error")]).cpu().numpy())
    return np.stack(rows)


def summary(rows, i) -> dict:
    """Stream i's tail-median BPM, BPM count and errors; ``rows`` is
    (steps, 4, S): samples, BPM, has_bpm, error."""
    has = rows[:, 2, i] > 0
    return {"bpm_tail_median": tail_median(rows[:, 1, i], has),
            "bpm_count": int(has.sum()), "errors": int(rows[:, 3, i].sum())}


def first_gap(a, b, i) -> int | None:
    """The first step at which stream i's samples differ in a and b."""
    gap = np.flatnonzero(~np.isclose(a[:, 0, i], b[:, 0, i], rtol=0.0,
                                     atol=1e-6, equal_nan=True))
    return int(gap[0]) if gap.size else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bpms", type=float, nargs="+",
                    default=[12.0, 15.0, 18.0, 21.0])
    ap.add_argument("--measured", type=int, default=96)
    ap.add_argument("--runs", nargs="*", default=["jax", "port-cpu"],
                    choices=["jax", "port-cpu", "port-cuda"])
    ap.add_argument("--dump")
    ap.add_argument("--compare", nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke

    cal_len = 128
    clips = chip_smoke.fleet_clips(1 + cal_len + 1 + args.measured,
                                   bpms=tuple(args.bpms))
    runs, seconds = {}, {}
    for name in args.runs:
        t0 = time.perf_counter()
        runs[name] = run_jax(clips, cal_len, chip_smoke.FPS) \
            if name == "jax" else run_port(clips, cal_len, chip_smoke.FPS,
                                           name.removeprefix("port-"))
        seconds[name] = time.perf_counter() - t0
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            np.save(os.path.join(args.dump, f"{name}.npy"), runs[name])
    for path in args.compare:
        runs[os.path.basename(path).removesuffix(".npy")] = np.load(path)
    first = next(iter(runs.values()))
    for i, rate in enumerate(args.bpms):
        print(json.dumps({
            "stream": i, "fixture_bpm": rate, "measured": args.measured,
            **{name: dict(summary(rows, i),
                          first_sample_gap=first_gap(first, rows, i))
               for name, rows in runs.items()},
            "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
