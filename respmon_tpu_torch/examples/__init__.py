"""The port's examples: one demo per script of the JAX package's
``examples/``, with the same file name, arguments, defaults and printed
lines, plus ``--device`` (the card unless told otherwise; ``--device cpu``
runs on the CPU).  Run one as ``python -m
respmon_tpu_torch.examples.<name>``; ``README.md`` lists them.

``mismatches`` compares two runs of a demo by their printed lines: the
port's against the JAX demo's (``tests/test_torch_examples.py``), and a
run on the card against one on the CPU (``chip_smoke.py``)."""

from __future__ import annotations

import math
import re
from typing import List, Tuple

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\d+)|\bnan\b")
BPM = ("abs", 0.5)

# Lines not compared: host timings, and the device count (the JAX demo
# counts devices, the port ranks).
SKIP = re.compile(r"^(mean per-frame compute|devices:)")

# Per demo, (line pattern, {index of a number in the line: tolerance}).
# Numbers without a rule: integers exact, decimals within one unit of
# their last printed digit.  BPMs within 0.5 (float32 flow and fits are
# fixture-dependent).  An accepted Gaussian fit's dev within 2% (the
# port's limit for float32 fits of noisy windows); a rejected fit's dev
# only through its printed decisions: the one the demo rejects (dev 3.2,
# noise 0.15) has wandered into a flat valley of its cost, its centre
# 15-87 s outside its 2 s window, where the JAX package's and the port's
# fits stop 13% apart in float32 (their costs equal to 4e-4) and 1.9% apart
# even in float64.
RULES = {
    "flow_demo": [(r"^final BPM:", {0: BPM})],
    "gaussian_explorer": [(r"^\s+\d.*True$", {2: ("rel", 0.02)}),
                          (r"^\s+\d.*False$", {2: "decisions only"})],
    "multiaxis_demo": [(r"^BPM trace:", {1: BPM, 2: BPM})],
    "multistream_demo": [(r"^stream \d", {2: BPM})],
    "signal_measurement_demo": [(r"^BPM:", {0: BPM})],
    "temporal_analysis_demo": [(r"^dominant frequency:", {1: BPM})],
}


def printed_lines(text: str) -> List[Tuple[str, List[str]]]:
    """Each compared line of a demo's output as (the line with each number
    replaced by '#', its numbers as printed)."""
    return [(NUMBER.sub("#", ln), NUMBER.findall(ln))
            for ln in text.splitlines() if not SKIP.match(ln)]


def _close(a: str, b: str, tol) -> bool:
    if a == b or tol == "decisions only":
        return True
    if "nan" in (a, b):
        return False
    if tol is None:
        if "." not in a:
            return False
        tol = ("abs", 1.0001 * 10.0 ** -len(a.split(".")[1]))
    kind, limit = tol
    x, y = float(a), float(b)
    return math.fabs(x - y) <= (limit if kind == "abs"
                                else limit * max(abs(x), abs(y)))


def mismatches(demo: str, got: str, want: str) -> List[str]:
    """Where the printed output ``got`` of ``demo`` (a module name, e.g.
    ``"flow_demo"``) differs from ``want`` beyond ``RULES``: the text
    around the numbers must be equal (True / False / None included), and
    each number within its tolerance."""
    g_lines, w_lines = printed_lines(got), printed_lines(want)
    if len(g_lines) != len(w_lines):
        return [f"{len(g_lines)} lines against {len(w_lines)}"]
    wrong = []
    kept = [ln for ln in want.splitlines() if not SKIP.match(ln)]
    for (g_text, g_nums), (w_text, w_nums), line in zip(g_lines, w_lines,
                                                        kept):
        if g_text != w_text:
            wrong.append(f"{g_text!r} against {w_text!r}")
            continue
        rules = {}
        for pattern, tols in RULES.get(demo, []):
            if re.match(pattern, line):
                rules = tols
        wrong += [f"number {i} of {line!r}: {a} against {b}"
                  for i, (a, b) in enumerate(zip(g_nums, w_nums))
                  if not _close(a, b, rules.get(i))]
    return wrong
