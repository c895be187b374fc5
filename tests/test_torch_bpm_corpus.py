"""Port parity on the BPM corpus: the port's ``bpm.estimate_bpm`` against
the JAX package's, window by window, over every sliding ring window of a
reduced ``corpus_traces`` set (the traces of ``python -m
respmon_tpu_torch.bench --bpm-corpus``, seeded, bit for bit ``bench.py``'s:
``tests/test_torch_bench_modes.py``), at ``tests/test_bpm_corpus.py``'s
size and stride.

Both estimators run float32 rings with the default ``MeasureConfig`` (the
float64 refit of wild fits on), as the JAX package's device chain does.
The bar is that file's: where both give a BPM, |dBPM| <= 0.5; here it holds
on every window, and the has-BPM decisions are equal on every window.  The
full 120-trace corpus on the card is not run here."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from respmon_tpu.config import MeasureConfig as JMeasureConfig
from respmon_tpu.ops import filters as jfilters
from respmon_tpu.pipeline import bpm as jbpm
from respmon_tpu_torch.bench import corpus_traces
from respmon_tpu_torch.config import MeasureConfig
from respmon_tpu_torch.ops import filters
from respmon_tpu_torch.pipeline import bpm

torch.set_num_threads(1)


def _windows(tr, cfg, stride):
    """Every ring window of a trace from initialization_length + 1 samples
    on: right-aligned float32 (data, t) rings and their counts."""
    y, t = tr["y"], tr["t"]
    n = cfg.buffer_length
    steps = range(cfg.initialization_length + 1, len(y) + 1, stride)
    D = np.zeros((len(steps), n), np.float32)
    T = np.zeros((len(steps), n), np.float32)
    C = np.zeros((len(steps),), np.int32)
    for j, c in enumerate(steps):
        m = min(c, n)
        D[j, n - m:] = y[c - m:c]
        T[j, n - m:] = t[c - m:c]
        C[j] = m
    return D, T, C


def test_bpm_corpus_port_matches_the_jax_estimator_window_by_window():
    traces = corpus_traces(120)[::7]
    cfg, jcfg = MeasureConfig(), JMeasureConfig()
    jax_fns = {}
    n_windows = n_bpm = 0
    worst = 0.0
    for k, tr in enumerate(traces):
        fps = tr["fps"]
        min_dist = max(int(np.floor(fps / 1.0)), 1)
        D, T, C = _windows(tr, cfg, stride=2)

        got = bpm.estimate_bpm(
            torch.from_numpy(D), torch.from_numpy(T), torch.from_numpy(C),
            filters.design_butter_lowpass(0.5, fps, cfg.filter_order),
            min_dist, cfg)
        if fps not in jax_fns:
            coeffs = jfilters.design_butter_lowpass(0.5, fps,
                                                    jcfg.filter_order)
            jax_fns[fps] = jax.jit(jax.vmap(
                lambda d, tt, c, coeffs=coeffs, md=min_dist:
                    jbpm.estimate_bpm(d, tt, c, coeffs, md, jcfg)))
        want = jax_fns[fps](jnp.asarray(D), jnp.asarray(T), jnp.asarray(C))

        has = got.has_bpm.numpy()
        assert np.array_equal(has, np.asarray(want.has_bpm)), \
            f"trace {k} ({tr['kind']}, {tr['bpm']} BPM, noise " \
            f"{tr['noise']}, {fps} fps): has-BPM decisions differ"
        delta = np.abs(got.bpm.numpy()[has] - np.asarray(want.bpm)[has])
        if delta.size:
            worst = max(worst, float(delta.max()))
        assert (delta <= 0.5).all(), (k, tr["kind"], delta.max())
        n_windows += len(has)
        n_bpm += int(has.sum())
    assert n_windows > 1000 and n_bpm > 400, (n_windows, n_bpm)
    print(f"{n_windows} windows, {n_bpm} with a BPM, max |dBPM| {worst}")
