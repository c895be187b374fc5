"""``python -m respmon_tpu_torch``: the port's CLI on a recorded clip, in
the streaming monitor and with ``--fast`` (the whole-clip path), against
the JAX package's CLI on the same clip."""

import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from respmon_tpu.__main__ import main as jax_main
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu_torch.__main__ import main

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS = 10.0
FINAL = re.compile(r"Final BPM estimate: ([0-9.]+)")


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    # The CLI runs MonitorConfig() defaults: a 128-frame calibration.
    path = str(tmp_path_factory.mktemp("cli") / "breathing.avi")
    clip = breathing_clip(num_frames=128 + 2 + 50, height=120, width=160,
                          fps=FPS, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    u8 = np.clip(clip * 255, 0, 255).astype(np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                         (160, 120))
    assert vw.isOpened()
    for f in u8:
        vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    vw.release()
    return path


def _final_bpm(text):
    found = FINAL.findall(text)
    assert found, text[-2000:]
    return float(found[-1])


@pytest.mark.parametrize("fast", [False, True], ids=["monitor", "fast"])
def test_cli_gives_the_jax_cli_final_bpm(clip_path, fast, tmp_path, caplog):
    flags = ["--method", "average", "--no-viz", "--no-save", "--no-sync"]
    if fast:
        flags.append("--fast")
    # The monitor writes its calibration montage into the working
    # directory.
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "respmon_tpu_torch", clip_path, *flags,
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = _final_bpm(out.stderr)

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with caplog.at_level(logging.INFO):
            assert jax_main([clip_path, *flags]) == 0
    finally:
        os.chdir(cwd)
    want = _final_bpm(caplog.text)
    # The monitor logs two decimals, --fast the whole float.
    assert got == pytest.approx(want, rel=1e-5, abs=0 if fast else 0.011)
    assert abs(got - 18.0) <= 1.0
    if not fast:
        assert os.path.exists(tmp_path / "calibration0.png")


def test_fast_refuses_skip_calibration(clip_path, capsys):
    with pytest.raises(SystemExit) as exc:
        main([clip_path, "--fast", "--skip-calibration", "1", "2", "3", "4",
              "--device", "cpu"])
    assert exc.value.code == 2
    assert "--fast does not support --skip-calibration" in \
        capsys.readouterr().err


def test_fast_refuses_a_live_camera(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["0", "--fast", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--fast requires a recorded clip path" in capsys.readouterr().err
