# Port of examples/flow_demo.py.
"""Flow-mode motion extraction demo (reference prototypes/flow.py analog):
track corners through a clip, PCA-project, lowpass, report mean per-frame
device time and the recovered BPM.  On the card the calibration runs the
pyramid kernel K1."""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", help="video path (default: synthetic 18 BPM)")
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    from respmon_tpu_torch import device as device_mod
    from respmon_tpu_torch.config import CalibrationConfig, MonitorConfig
    from respmon_tpu_torch.io.synthetic import breathing_clip
    from respmon_tpu_torch.pipeline import scan

    device = device_mod.resolve(args.device)
    fps = 10.0
    if args.clip:
        import cv2

        cap = cv2.VideoCapture(args.clip)
        fps = cap.get(cv2.CAP_PROP_FPS) or fps
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) / 255.0)
        clip = np.stack(frames).astype(np.float32)
    else:
        clip = breathing_clip(num_frames=args.frames, height=120, width=160,
                              fps=fps, bpm=18.0, patch_center=(60, 80),
                              patch_size=(30, 40), amplitude=0.12,
                              motion_px=2.0)

    cfg = MonitorConfig(
        motion_extraction_method="flow",
        calibration=CalibrationConfig(buffer_length=64, pyramid_levels=6,
                                      skip_levels_at_top=2))
    t0 = time.time()
    res = scan.process_clip(clip, fps, cfg, device=device)
    wall = time.time() - t0
    n_meas = clip.shape[0] - cfg.calibration.buffer_length - 1
    print(f"ROI: {res.roi}")
    print(f"final BPM: {res.final_bpm}")
    print(f"mean per-frame compute: {wall / clip.shape[0] * 1e3:.2f} ms "
          f"(incl. compile; {n_meas} measured frames)")

    if args.plot and res.measure is not None:
        import matplotlib.pyplot as plt

        m = res.measure
        fig, (a, b) = plt.subplots(2, 1, sharex=True)
        t = m.t.cpu().numpy()
        a.plot(t, m.samples.cpu().numpy())
        a.set_ylabel("motion")
        has = m.has_bpm.cpu().numpy()
        b.plot(t[has], m.bpm.cpu().numpy()[has])
        b.set_ylabel("BPM")
        b.set_xlabel("t (s)")
        plt.show()


if __name__ == "__main__":
    main()
