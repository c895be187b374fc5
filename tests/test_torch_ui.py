"""The port's UI backends (``viz/ui``): the contract of
``tests/test_ui_contract.py`` for the port, its keypoint overlay against the
JAX package's, and the optional imports (cv2, pyqtgraph) staying lazy."""

import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

from respmon_tpu.viz import ui as jui
import respmon_tpu_torch
from respmon_tpu_torch.viz import ui as tui
from respmon_tpu_torch.viz.ui import (HeadlessUI, PyqtgraphUI, make_ui,
                                      overlay_keypoints)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public_methods(cls):
    return {n: m for n, m in vars(cls).items()
            if callable(m) and not n.startswith("_")}


def test_backends_expose_identical_method_signatures():
    head = _public_methods(HeadlessUI)
    qt = _public_methods(PyqtgraphUI)
    assert set(head) == set(qt), (
        f"backend method sets diverge: only-headless="
        f"{set(head) - set(qt)}, only-qt={set(qt) - set(head)}")
    for name in head:
        sh = inspect.signature(head[name])
        sq = inspect.signature(qt[name])
        assert sh == sq, f"{name}: {sh} != {sq}"


@pytest.mark.parametrize("name", ["HeadlessUI", "PyqtgraphUI"])
def test_backends_match_the_jax_package(name):
    ours = _public_methods(getattr(tui, name))
    theirs = _public_methods(getattr(jui, name))
    assert set(ours) == set(theirs)
    for n in ours:
        assert inspect.signature(ours[n]) == inspect.signature(theirs[n]), n


def test_constructor_signatures_compatible():
    sig = inspect.signature(PyqtgraphUI.__init__)
    params = [p for p in sig.parameters.values() if p.name != "self"]
    assert params and params[0].name == "fig_size"
    assert params[0].default is None


def test_make_ui_falls_back_headless():
    ui = make_ui("pyqtgraph")
    assert isinstance(ui, HeadlessUI)
    assert isinstance(make_ui(None), HeadlessUI)


def test_headless_ui_full_surface_smoke():
    # Drive every public method the monitor uses, end to end.
    ui = make_ui(None)
    t = np.linspace(0.0, 12.8, 128)
    y = np.sin(t)
    ui.set_window_title("Respiration Monitor")
    ui.set_image(np.zeros((48, 64), np.uint8))
    ui.set_plot_autoscale(True)
    ui.set_plot_autoscale(False, axes="x")
    ui.set_plot_x_range(0.0, 12.8)
    ui.set_raw_signal(t, y)
    ui.set_peaks(t[::16], y[::16])
    ui.set_frequency(t[13:], np.full(115, 18.0))
    ui.set_keypoints(np.zeros((3, 1, 2), np.float32))
    ui.set_bpm_text("18.0 BPM")
    ui.process_events()
    ui.clear_plots()
    ui.close()
    assert ui.bpm_text == "??? BPM" and ui.keypoints is None


def test_pyqtgraph_ui_constructs_offscreen(monkeypatch):
    pytest.importorskip("pyqtgraph")
    monkeypatch.setenv("QT_QPA_PLATFORM", "offscreen")
    ui = PyqtgraphUI()
    ui.set_window_title("t")
    ui.set_image(np.zeros((8, 8), np.uint8))
    ui.set_raw_signal([0.0, 1.0], [0.0, 1.0])
    ui.set_keypoints(None)
    ui.set_bpm_text("18.0 BPM")
    ui.process_events()
    ui.clear_plots()
    ui.close()


def _points():
    return np.asarray([[[5.2, 7.8]], [[30.0, 20.0]], [[54.9, 38.6]],
                       [[0.4, 0.4]], [[-1.0, 39.5]]], np.float32)


def test_overlay_keypoints_matches_reference_drawing():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    base = rng.integers(0, 200, (40, 56), dtype=np.uint8)
    pts = _points()[:3]
    got = overlay_keypoints(base, pts)
    mask = np.zeros_like(base)
    disp = base.copy()
    for new in pts:
        a, b = new.ravel()
        mask = cv2.circle(mask, (int(round(float(a))),
                                 int(round(float(b)))), 2,
                          (255, 255, 255), -1)
        disp = cv2.add(disp, mask)
    np.testing.assert_array_equal(got, disp)
    np.testing.assert_array_equal(overlay_keypoints(base, None), base)
    np.testing.assert_array_equal(
        overlay_keypoints(base, np.zeros((0, 1, 2), np.float32)), base)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_overlay_keypoints_equals_the_jax_package(with_cv2, monkeypatch):
    # With cv2 both draw through it; without it both fall back to the
    # radius-2 disc.
    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (40, 56), dtype=np.uint8)
    for pts in (_points(), _points()[:1], None):
        np.testing.assert_array_equal(overlay_keypoints(base, pts),
                                      jui.overlay_keypoints(base, pts))


def test_every_qt_method_is_smoke_covered():
    import ast
    import textwrap

    src = ast.parse(textwrap.dedent(inspect.getsource(
        test_headless_ui_full_surface_smoke)))
    called = {node.func.attr for node in ast.walk(src)
              if isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "ui"}
    assert set(_public_methods(HeadlessUI)) <= called


def test_importing_the_port_loads_neither_cv2_nor_pyqtgraph():
    # cv2 and pyqtgraph are optional: imported where a capture, recorder,
    # overlay, montage or Qt window uses them, never by an import.
    names = ["respmon_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(respmon_tpu_torch.__path__,
                                              "respmon_tpu_torch.")]
    assert "respmon_tpu_torch.runtime.monitor" in names
    assert "respmon_tpu_torch.__main__" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "from respmon_tpu_torch.runtime import RespiratoryMonitor\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'pyqtgraph', 'PyQt5', 'PyQt6')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
