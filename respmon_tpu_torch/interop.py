"""State carried between the JAX package and the port.

The system has no weights; what crosses is configuration and measurement
state.  A configuration crosses as one of the frozen dataclasses of
``respmon_tpu/config.py``: ``config_from_reference`` rebuilds it as the
port's class of the same name, without importing that package.  A
``MeasureState`` travels as ``{field: numpy array}``, the form
``respmon_tpu/runtime/checkpoint.py`` writes; in flow mode it carries the
tracked points, the previous crop and the motion ring, so a measurement
begun in one package continues in the other; a fleet's batched state is
the same with a leading stream axis on every array.  The fleet's carried LK
cache (``FlowCache``) travels as ``{"stacks.0": array, ...}``, one
(S, 3, Hp, Wp) stack per pyramid level.  A ``StreamingState`` (the
streaming localizer's rings) travels as ``{"count": array, "levels.0":
array, "levels.1": array, ...}``, one ring per kept level in order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from respmon_tpu_torch import config as config_mod
from respmon_tpu_torch import device as device_mod
from respmon_tpu_torch.pipeline.motion import FlowCache, MeasureState
from respmon_tpu_torch.pipeline.streaming import StreamingState

_CONFIG_CLASSES = {cls.__name__: cls for cls in (
    config_mod.FeatureParams, config_mod.LKParams,
    config_mod.CalibrationConfig, config_mod.MeasureConfig,
    config_mod.MonitorConfig)}


def config_from_reference(obj: Any):
    """The port's config dataclass for an instance of the JAX package's
    class of the same name (any of the five; nested ones convert too).

    The two classes must have exactly the same fields: one that either
    side lacks raises ``TypeError``."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"not a config dataclass instance: {obj!r}")
    cls = _CONFIG_CLASSES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port config class named {type(obj).__name__}")
    theirs = [f.name for f in dataclasses.fields(obj)]
    ours = [f.name for f in dataclasses.fields(cls)]
    if set(theirs) != set(ours):
        raise TypeError(
            f"{cls.__name__}: fields differ; unknown "
            f"{sorted(set(theirs) - set(ours))}, missing "
            f"{sorted(set(ours) - set(theirs))}")
    kwargs = {}
    for name in theirs:
        value = getattr(obj, name)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = config_from_reference(value)
        kwargs[name] = value
    return cls(**kwargs)


def config_to_dict(cfg: Any) -> dict:
    """A config dataclass (either package's) as nested plain dicts."""
    if not dataclasses.is_dataclass(cfg) or isinstance(cfg, type):
        raise TypeError(f"not a config dataclass instance: {cfg!r}")
    return dataclasses.asdict(cfg)


def measure_state_from_numpy(d: Mapping[str, np.ndarray],
                             device=None) -> MeasureState:
    """A port ``MeasureState`` from ``{field: array}`` (dtypes kept), on
    the card unless ``device`` says otherwise."""
    missing = set(MeasureState._fields) - set(d)
    if missing:
        raise KeyError(f"MeasureState fields missing: {sorted(missing)}")
    device = device_mod.resolve(device)
    return MeasureState(**{
        f: torch.from_numpy(np.array(d[f], copy=True)).to(device)
        for f in MeasureState._fields})


def measure_state_to_numpy(st: MeasureState) -> dict:
    """``{field: numpy array}`` of a port ``MeasureState``."""
    return {f: getattr(st, f).detach().cpu().numpy()
            for f in MeasureState._fields}


def streaming_state_from_numpy(d: Mapping[str, np.ndarray],
                               device=None) -> StreamingState:
    """A port ``StreamingState`` from ``{"count": ..., "levels.<k>": ...}``
    (dtypes kept), on the card unless ``device`` says otherwise."""
    n = sum(1 for k in d if k.startswith("levels."))
    keys = ["count"] + [f"levels.{k}" for k in range(n)]
    missing = [k for k in keys if k not in d]
    if missing or n == 0:
        raise KeyError(f"StreamingState fields missing: "
                       f"{missing or ['levels.0']}")
    device = device_mod.resolve(device)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return StreamingState(levels=tuple(put(d[k]) for k in keys[1:]),
                          count=put(d["count"]))


def streaming_state_to_numpy(st: StreamingState) -> dict:
    """``{"count": array, "levels.<k>": array}`` of a port
    ``StreamingState``."""
    out = {"count": st.count.detach().cpu().numpy()}
    for k, ring in enumerate(st.levels):
        out[f"levels.{k}"] = ring.detach().cpu().numpy()
    return out


def flow_cache_from_numpy(d: Mapping[str, np.ndarray],
                          device=None) -> FlowCache:
    """A port ``FlowCache`` from ``{"stacks.<k>": ...}`` (dtypes kept), on
    the card unless ``device`` says otherwise."""
    n = sum(1 for k in d if k.startswith("stacks."))
    keys = [f"stacks.{k}" for k in range(n)]
    missing = [k for k in keys if k not in d]
    if missing or n == 0:
        raise KeyError(f"FlowCache fields missing: {missing or ['stacks.0']}")
    device = device_mod.resolve(device)
    return FlowCache(stacks=tuple(
        torch.from_numpy(np.array(d[k], copy=True)).to(device) for k in keys))


def flow_cache_to_numpy(cache: FlowCache) -> dict:
    """``{"stacks.<k>": array}`` of a port ``FlowCache``."""
    return {f"stacks.{k}": s.detach().cpu().numpy()
            for k, s in enumerate(cache.stacks)}
