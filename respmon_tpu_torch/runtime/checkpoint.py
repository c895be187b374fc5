"""Monitor checkpoint / resume.

Port of ``respmon_tpu/runtime/checkpoint.py``.  A monitor's whole state
(ROI, fps, the signal deques, the frequency history and the measurement
state: flow points, motion ring, previous crop) goes to one ``.npz``, so a
resumed monitor measures on without a recalibration and with its signal
history intact.  The files are the JAX package's, key for key, dtype for
dtype: a file written by either package loads in the other.

The monitor file holds ``fps``, ``roi``, ``state_name``, ``data``, ``t``,
``freq``, ``peak_min_dist`` and ``ms_<field>`` for each ``MeasureState``
field; the fleet file holds ``fps``, ``frame_hw``, ``crop_hw``, ``method``,
``lk_sample``, ``needs_init`` and the batched ``ms_<field>``.  Neither
holds the streaming-ROI rings, as in the JAX package: a resumed streaming
monitor or fleet neither absorbs frames nor re-locks until its next
calibration.  Restored tensors land on the monitor's or the fleet's own
device (with a mesh, each rank takes its rows of the streams).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from respmon_tpu_torch import interop
from respmon_tpu_torch.parallel.streams import gather_rows, shard_streams
from respmon_tpu_torch.pipeline import motion

_STATE_FIELDS = motion.MeasureState._fields

# LK sampling modes of a fleet file the port can resume: its one LK path
# is the JAX package's "slices", which "onehot" equals bit for bit.
_LK_SAMPLES = ("slices", "onehot")


def save_checkpoint(path: str, monitor) -> None:
    """Serialize a ``RespiratoryMonitor`` mid-measurement."""
    blobs = {
        "fps": np.asarray(monitor.fps),
        "roi": np.asarray([monitor.x or 0, monitor.y or 0,
                           monitor.w or 0, monitor.h or 0]),
        "state_name": np.asarray(monitor.state),
        "data": np.asarray(monitor.data, dtype=np.float64),
        "t": np.asarray(monitor.t, dtype=np.float64),
        "freq": np.asarray(monitor.freq, dtype=np.float64),
        "peak_min_dist": np.asarray(monitor.peak_minimum_sample_distance),
    }
    if monitor._measure_state is not None:
        for name, value in interop.measure_state_to_numpy(
                monitor._measure_state).items():
            blobs[f"ms_{name}"] = value
    np.savez(path, **blobs)


def load_checkpoint(path: str, monitor) -> None:
    """Restore a monitor saved with ``save_checkpoint`` (by either
    package).

    The monitor must wrap a compatible capture (the same frame size); it
    resumes in the saved state with its buffers and measurement state
    intact, on its own device."""
    z = np.load(path, allow_pickle=False)
    monitor.fps = float(z["fps"])
    x, y, w, h = (int(v) for v in z["roi"])
    state_name = str(z["state_name"])

    monitor.data.clear()
    monitor.data.extend(z["data"].tolist())
    monitor.t.clear()
    monitor.t.extend(z["t"].tolist())
    monitor.freq.clear()
    monitor.freq.extend(z["freq"].tolist())
    monitor.peak_minimum_sample_distance = int(z["peak_min_dist"])

    if state_name == "measure" and w > 0 and h > 0:
        monitor.x, monitor.y, monitor.w, monitor.h = x, y, w, h
        monitor._setup_measurement()
        if "ms_data" in z:
            monitor._measure_state = interop.measure_state_from_numpy(
                {name: z[f"ms_{name}"] for name in _STATE_FIELDS},
                device=monitor.device)
        monitor.state = "measure"
    else:
        monitor.state = state_name if state_name in (
            "initialize", "calibration") else "initialize"


def checkpoint_roundtrip_equal(a: Optional[motion.MeasureState],
                               b: Optional[motion.MeasureState]) -> bool:
    """For tests: deep equality of two measure states (tensors or numpy
    arrays, on any device)."""
    if a is None or b is None:
        return a is b
    for name in _STATE_FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        va = va.detach().cpu().numpy() if hasattr(va, "detach") else va
        vb = vb.detach().cpu().numpy() if hasattr(vb, "detach") else vb
        if not np.array_equal(np.asarray(va), np.asarray(vb),
                              equal_nan=True):
            return False
    return True


def save_fleet_checkpoint(path: str, fleet) -> None:
    """Serialize a ``MultiStreamMonitor`` mid-monitoring: the batched
    measurement state and the geometry the step needs on restore (the
    fleet's ``save_checkpoint``; each stream's signal history rides in the
    batched rings).  With a mesh every rank calls it: the rows are
    gathered (one collective), the first rank writes the file, and every
    rank returns once it is written."""
    assert fleet.states is not None, "calibrate() before checkpointing"
    states = fleet.states
    if fleet.mesh is not None:
        states = motion.MeasureState(*gather_rows(fleet.mesh, states))
    if fleet.mesh is None or fleet.mesh.index("streams") == 0:
        blobs = {
            "fps": np.asarray(fleet.fps),
            "frame_hw": np.asarray(fleet.frame_hw),
            "crop_hw": np.asarray([fleet.spec.crop_h, fleet.spec.crop_w]),
            "method": np.asarray(fleet.spec.method),
            "lk_sample": np.asarray("slices"),
            "needs_init": np.asarray(fleet._needs_init),
        }
        for name, value in interop.measure_state_to_numpy(states).items():
            blobs[f"ms_{name}"] = value
        np.savez(path, **blobs)
    if fleet.mesh is not None:
        fleet.mesh.barrier("streams")


def load_fleet_checkpoint(path: str, fleet) -> None:
    """Restore a ``MultiStreamMonitor`` saved with
    ``save_fleet_checkpoint`` (by either package).  The fleet must be made
    with the same config and frame size (its mesh may differ); it resumes
    stepping with every stream's tracking points, motion rings and signal
    history intact.  The states go in through the ``states`` setter, so
    the carried LK cache is rebuilt on the first step."""
    z = np.load(path, allow_pickle=False)
    if tuple(int(v) for v in z["frame_hw"]) != tuple(fleet.frame_hw):
        raise ValueError("checkpoint frame size does not match this fleet")
    lk_sample = str(z["lk_sample"])
    if lk_sample not in _LK_SAMPLES:
        raise ValueError(f"LK sampling mode {lk_sample!r}: the port "
                         f"resumes {_LK_SAMPLES}")
    # fps and what derives from it (the lowpass design, the peak
    # min-distance) in one place: MultiStreamMonitor._set_fps.
    fleet._set_fps(float(z["fps"]))
    crop_h, crop_w = (int(v) for v in z["crop_hw"])
    base = motion.MeasureSpec.for_roi(
        fleet.cfg, fleet.frame_hw[0], fleet.frame_hw[1], 1, 1, fleet.fps)
    fleet.spec = dataclasses.replace(base, crop_h=crop_h, crop_w=crop_w,
                                     method=str(z["method"]))
    fields = {name: z[f"ms_{name}"] for name in _STATE_FIELDS}
    if fleet.mesh is None:
        fleet.states = interop.measure_state_from_numpy(fields,
                                                        device=fleet.device)
    else:
        fleet.states = shard_streams(motion.MeasureState(**fields),
                                     fleet.mesh)
    fleet._needs_init = bool(z["needs_init"])
