"""A run with the timed path broken underneath comes out not correct: the
harness without its look for a card, on the CPU at a small size, once for
each fault a cell can have.  (No cell spans chips, so none can leave out
an exchange between them.)"""

import pytest
import torch

from benchmark.tests.conftest import run_small
from respmon_tpu_torch.pipeline import bpm, evm, motion


def _wrong(out):
    assert out["correct"] is False
    return {k: v["value"] for k, v in out["checks"].items()
            if v["limit"] is None or v["value"] > v["limit"]}


def _fails(name) -> bool:
    """A run of ``name`` either raises (run.py then prints no result) or
    comes out not correct."""
    try:
        out, _ = run_small(name)
    except (RuntimeError, IndexError):
        return True
    return bool(_wrong(out))


def _ring_fault_shows(name) -> bool:
    """A run of ``name`` either raises (a count left at 0 makes the
    program's own estimate index out of its ring) or reads ring faults."""
    try:
        out, _ = run_small(name)
    except (RuntimeError, IndexError):
        return True
    return "ring_faults" in _wrong(out)


def test_unchanged_state_single(monkeypatch):
    step = motion.measure_step

    def broken(state, frame, spec, initialized_hint=False):
        new, sample = step(state, frame, spec, initialized_hint)
        if bool(state.initialized):
            return state, sample
        return new, sample
    monkeypatch.setattr(motion, "measure_step", broken)
    out, _ = run_small("cam640.flow")
    assert "sample_rel" in _wrong(out) or "start_sample_rel" in _wrong(out)


def test_unchanged_state_fleet(monkeypatch):
    step = motion.measure_step_cached

    def broken(state, cache, frame, spec, initialized_hint=False,
               cache_valid=True):
        new, new_cache, sample = step(state, cache, frame, spec,
                                      initialized_hint, cache_valid)
        return (state if initialized_hint else new), new_cache, sample
    monkeypatch.setattr(motion, "measure_step_cached", broken)
    out, _ = run_small("fleet64_1080p.flow")
    assert _wrong(out)


def test_unchanged_state_recovery(monkeypatch):
    step = motion.measure_step

    def broken(state, frame, spec, initialized_hint=False):
        _, sample = step(state, frame, spec, initialized_hint)
        return state, sample
    monkeypatch.setattr(motion, "measure_step", broken)
    assert _fails("cam640.recover")


@pytest.mark.parametrize("field", ["data", "t", "count"])
def test_ring_left_unchanged_single(monkeypatch, field):
    """Only the signal ring's push broken: the step keeps one of the ring's
    fields as it was; the LK state and the sample are the program's.  (A
    blackout cycle's one measured step pushes a 0 at time 0 onto an empty
    ring, which leaves its data and times as they were: there only the
    count shows the fault.)"""
    step = motion.measure_step

    def broken(state, frame, spec, initialized_hint=False):
        new, sample = step(state, frame, spec, initialized_hint)
        return new._replace(**{field: getattr(state, field)}), sample
    monkeypatch.setattr(motion, "measure_step", broken)
    names = ["cam640.flow"] + (["cam640.recover"] if field == "count"
                               else [])
    for name in names:
        assert _ring_fault_shows(name), name


@pytest.mark.parametrize("field", ["data", "t", "count"])
def test_ring_left_unchanged_fleet(monkeypatch, field):
    step = motion.measure_step_cached

    def broken(state, cache, frame, spec, initialized_hint=False,
               cache_valid=True):
        new, new_cache, sample = step(state, cache, frame, spec,
                                      initialized_hint, cache_valid)
        return new._replace(**{field: getattr(state, field)}), new_cache, \
            sample
    monkeypatch.setattr(motion, "measure_step_cached", broken)
    assert _ring_fault_shows("fleet64_1080p.flow")


def test_half_the_batch_left_out(monkeypatch):
    estimate = bpm.estimate_bpm

    def broken(data, t, count, coeffs, min_dist, cfg):
        half = data.shape[0] // 2
        res = estimate(data[:half], t[:half], count[:half], coeffs,
                       min_dist, cfg)
        full = estimate(data, t, count, coeffs, min_dist, cfg)
        mean = res.bpm.mean().expand(data.shape[0] - half)
        return full._replace(bpm=torch.cat([res.bpm, mean]),
                             has_bpm=torch.cat([res.has_bpm,
                                                res.has_bpm.any().expand(
                                                    data.shape[0] - half)]))
    monkeypatch.setattr(bpm, "estimate_bpm", broken)
    out, _ = run_small("fleet64_1080p.flow")
    assert "bpm_mismatch" in _wrong(out)


def test_answer_altered_bpm(monkeypatch):
    estimate = bpm.estimate_bpm

    def broken(*args, **kwargs):
        res = estimate(*args, **kwargs)
        return res._replace(bpm=res.bpm + 0.5)
    monkeypatch.setattr(bpm, "estimate_bpm", broken)
    out, _ = run_small("fleet64_1080p.flow")
    assert "bpm_mismatch" in _wrong(out)


def test_answer_altered_has_bpm(monkeypatch):
    estimate = bpm.estimate_bpm

    def broken(*args, **kwargs):
        res = estimate(*args, **kwargs)
        return res._replace(has_bpm=~res.has_bpm)
    monkeypatch.setattr(bpm, "estimate_bpm", broken)
    for name in ("cam640.flow", "fleet64_1080p.flow"):
        out, _ = run_small(name)
        assert "bpm_mismatch" in _wrong(out), name


def test_answer_altered_sample(monkeypatch):
    step = motion.measure_step

    def broken(state, frame, spec, initialized_hint=False):
        new, sample = step(state, frame, spec, initialized_hint)
        return new, sample * 1.001
    monkeypatch.setattr(motion, "measure_step", broken)
    out, _ = run_small("cam640.flow")
    assert {"sample_rel", "start_sample_rel"} & set(_wrong(out))


def test_answer_altered_box(monkeypatch):
    locate = evm.locate

    def broken(vid, fps, cfg):
        res = locate(vid, fps, cfg)
        return res._replace(x=res.x + 1)
    monkeypatch.setattr(evm, "locate", broken)
    for name in ("cam640.recover", "fleet64_1080p.flow"):
        out, _ = run_small(name)
        assert "box_px" in _wrong(out), name
