# Port of examples/multiaxis_demo.py.
"""Dual-axis plot demo (reference prototypes/multiaxis.py:1-36 analog).

The reference prototype demonstrates pyqtgraph's two-y-axes technique: a
second ViewBox linked to the right axis of the main plot, geometry-synced on
resize.  Here the same technique renders the monitor's two natural series on
one time axis (the raw motion signal on the left axis and the per-frame BPM
trace on the right), produced by the real BPM pipeline on a synthetic
breathing trace.

Headless by default (prints series stats, CI-safe); ``--plot`` opens the
pyqtgraph dual-axis window.
"""

import argparse

import numpy as np


def dual_axis_window(t, y, t_bpm, bpm):
    """The prototype's linked-ViewBox dual-axis layout (multiaxis.py:12-30):
    right axis drives a second ViewBox that shares the x link with the main
    plotItem and re-syncs its scene geometry whenever the view resizes."""
    import pyqtgraph as pg

    app = pg.mkQApp()
    pw = pg.PlotWidget()
    pw.setWindowTitle("respmon_tpu_torch: motion signal + BPM (dual axis)")
    p1 = pw.plotItem
    p1.setLabels(left="motion signal", bottom="time (s)")

    p2 = pg.ViewBox()
    p1.showAxis("right")
    p1.scene().addItem(p2)
    p1.getAxis("right").linkToView(p2)
    p2.setXLink(p1)
    p1.getAxis("right").setLabel("BPM", color="#0000ff")

    def update_views():
        p2.setGeometry(p1.vb.sceneBoundingRect())
        p2.linkedViewChanged(p1.vb, p2.XAxis)

    update_views()
    p1.vb.sigResized.connect(update_views)

    p1.plot(np.asarray(t), np.asarray(y), pen="y")
    p2.addItem(pg.PlotCurveItem(np.asarray(t_bpm), np.asarray(bpm), pen="b"))
    pw.show()
    app.exec() if hasattr(app, "exec") else app.exec_()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--bpm", type=float, default=18.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--plot", action="store_true",
                    help="open the pyqtgraph dual-axis window")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.config import MonitorConfig
    from respmon_tpu_torch.io.synthetic import motion_trace
    from respmon_tpu_torch.ops import filters
    from respmon_tpu_torch.pipeline.scan import bpm_trace

    device = device_mod.resolve(args.device)
    cfg = MonitorConfig()
    t, y = motion_trace(num_samples=args.samples, fps=args.fps, bpm=args.bpm,
                        noise=0.05)
    coeffs = filters.design_butter_lowpass(
        cfg.calibration.freq_max * 0.5, args.fps, cfg.measure.filter_order)
    min_dist = cfg.peak_minimum_sample_distance(args.fps)

    bpm, has = bpm_trace(torch.tensor(y, dtype=torch.float32, device=device),
                         args.fps, coeffs, min_dist, cfg.measure)
    bpm = bpm.cpu().numpy()
    has = has.cpu().numpy()
    t_bpm, bpm_v = t[has], bpm[has]
    print(f"motion signal: {args.samples} samples @ {args.fps:.0f} fps, "
          f"true BPM {args.bpm}")
    if has.any():
        print(f"BPM trace: {has.sum()} estimates, final "
              f"{bpm_v[-1]:.2f}, tail median "
              f"{np.median(bpm_v[-10:]):.2f}")
    else:
        print("BPM trace: no estimates (trace too short)")

    if args.plot:
        dual_axis_window(t, y, t_bpm, bpm_v)


if __name__ == "__main__":
    main()
