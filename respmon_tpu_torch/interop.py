"""State carried between the JAX package and the port.

The system has no weights; what crosses is configuration (the shared
frozen dataclasses of ``respmon_tpu.config``) and measurement state.  A
``MeasureState`` travels as ``{field: numpy array}``, the form
``respmon_tpu/runtime/checkpoint.py`` writes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from respmon_tpu_torch.pipeline.motion import MeasureState


def measure_state_from_numpy(d: Mapping[str, np.ndarray],
                             device=None) -> MeasureState:
    """A port ``MeasureState`` from ``{field: array}`` (dtypes kept)."""
    missing = set(MeasureState._fields) - set(d)
    if missing:
        raise KeyError(f"MeasureState fields missing: {sorted(missing)}")
    return MeasureState(**{
        f: torch.from_numpy(np.array(d[f], copy=True)).to(device)
        for f in MeasureState._fields})


def measure_state_to_numpy(st: MeasureState) -> dict:
    """``{field: numpy array}`` of a port ``MeasureState``."""
    return {f: getattr(st, f).detach().cpu().numpy()
            for f in MeasureState._fields}
