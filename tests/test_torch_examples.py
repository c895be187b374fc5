"""Port parity: each demo of ``respmon_tpu_torch/examples`` against the JAX
package's demo of the same name.

Both run in subprocesses, side by side, with the arguments of
``tests/test_examples_smoke.py``'s ``CASES`` (the port's with ``--device
cpu``; the JAX demo through that file's ``WRAPPER``, without x64, as a
user runs it).  Their printed lines must match: the same text, and the
same numbers within each number's stated tolerance
(``respmon_tpu_torch.examples.RULES``: exact unless a rule says
otherwise).  Timing lines and the ``devices:`` line are not compared.

This module imports no JAX: its rank function is spawned by
``parallel.launch.run_ranks``, which re-imports it."""

import contextlib
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from respmon_tpu_torch.examples import mismatches
from tests.test_examples_smoke import CASES, WRAPPER

REPO = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = REPO / "respmon_tpu_torch" / "examples"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    env.setdefault("MPLBACKEND", "Agg")
    return env


def _port_cmd(script, args, device="cpu"):
    cmd = [sys.executable, "-m",
           "respmon_tpu_torch.examples." + script.removesuffix(".py"), *args]
    return cmd + (["--device", device] if device else [])


def compare_outputs(script, got, want):
    wrong = mismatches(script.removesuffix(".py"), got, want)
    assert not wrong, "\n".join(wrong)


def test_compare_outputs_holds_each_rule():
    line = "stream 0: true  12.0 BPM -> measured  18.3"
    compare_outputs("multistream_demo.py", line,
                    line.replace("18.3", "18.7"))
    with pytest.raises(AssertionError):
        compare_outputs("multistream_demo.py", line,
                        line.replace("18.3", "18.9"))
    with pytest.raises(AssertionError):   # not a BPM: exact
        compare_outputs("multistream_demo.py", line,
                        line.replace("12.0", "12.2"))
    with pytest.raises(AssertionError):   # a has-BPM decision
        compare_outputs("flow_demo.py", "final BPM: 18.2", "final BPM: None")
    with pytest.raises(AssertionError):   # a bbox
        compare_outputs("locating_demo.py", "bbox=(6,21,48,26)",
                        "bbox=(6,21,48,27)")
    compare_outputs("wavelet_demo.py", "energy 146.6", "energy 146.7")
    with pytest.raises(AssertionError):
        compare_outputs("wavelet_demo.py", "energy 146.6", "energy 146.8")
    row = "     0.80   0.15     0.814  True    True"
    with pytest.raises(AssertionError):   # an accepted fit's dev: 2%
        compare_outputs("gaussian_explorer.py", row,
                        row.replace("0.814", "0.834"))
    compare_outputs("gaussian_explorer.py", row.replace("True    True",
                                                        "True   False"),
                    row.replace("0.814  True    True", "0.900  True   False"))
    compare_outputs("flow_demo.py", "mean per-frame compute: 1 ms",
                    "mean per-frame compute: 9 ms")


def test_all_jax_examples_have_a_port():
    jax_demos = {p.name for p in (REPO / "examples").glob("*.py")}
    port_demos = {p.name for p in PORT_EXAMPLES.glob("*.py")} - {
        "__init__.py"}
    assert port_demos == jax_demos
    assert {name for name, _ in CASES} == jax_demos


@pytest.mark.parametrize("script,args", CASES,
                         ids=[name + ("[feeder]" if "--feeder" in a else "")
                              for name, a in CASES])
def test_port_example_prints_what_the_jax_example_prints(script, args):
    env = _env()
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", WRAPPER, str(REPO / "examples" / script)]
        + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    # The port's demo beside it, on one thread: the tests run several
    # workers on the host's cores.
    port = subprocess.run(_port_cmd(script, args), capture_output=True,
                          text=True, timeout=600,
                          env=dict(env, OMP_NUM_THREADS="1"))
    want, jax_err = jax_proc.communicate(timeout=600)
    assert port.returncode == 0, port.stderr
    assert jax_proc.returncode == 0, jax_err
    assert port.stdout.strip(), f"{script} printed nothing"
    compare_outputs(script, port.stdout, want)
    if script == "multistream_demo.py":
        assert "calibrated: [True, True]" in port.stdout
    if script == "locating_demo.py":
        assert "found=True" in port.stdout


def test_a_port_example_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(_port_cmd("signal_measurement_demo.py", [], None),
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode != 0 and out.stdout == ""
    assert "none is available" in out.stderr


def _demo_on_rank(device, argv):
    """Run the port's multistream demo in this rank; return its stdout."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["multistream_demo", *argv, "--device", str(device)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module("respmon_tpu_torch.examples.multistream_demo",
                             run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def test_multistream_demo_shards_over_the_ranks_of_a_process_group():
    from respmon_tpu_torch.parallel.launch import run_ranks

    argv = ["--streams", "4", "--frames", "70"]
    ranks = run_ranks(_demo_on_rank, 2, args=(argv,))
    one = subprocess.run(_port_cmd("multistream_demo.py", argv),
                         capture_output=True, text=True, timeout=600,
                         env=dict(_env(), OMP_NUM_THREADS="1"))
    assert one.returncode == 0, one.stderr
    for out in ranks:
        assert out.splitlines()[0] == "devices: 2, mesh: sharded"
        # Every rank prints the same global results as one process does.
        assert out.splitlines()[1:] == one.stdout.splitlines()[1:]
    assert one.stdout.splitlines()[0] == "devices: 1, mesh: single"
