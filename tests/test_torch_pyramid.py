"""Port parity: ops/pyramid and the pyramid kernels (ops/pyramid_cuda)
against respmon_tpu.ops.pyramid and the Pallas kernels in interpret mode;
the temporal bandpass against respmon_tpu.ops.fft_bandpass."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.ops import fft_bandpass as jfft
from respmon_tpu.ops import pyramid as jpyr
from respmon_tpu.ops.pyramid_pallas import (gauss_level_tiled,
                                            laplacian_band_levels)
from respmon_tpu_torch.ops import fft_bandpass as tfft
from respmon_tpu_torch.ops import pyramid as tpyr
from respmon_tpu_torch.ops import _build, pyramid_cuda

torch.set_num_threads(1)


def _video(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, atol=1e-6):
    got = [g.cpu().numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(3, 120, 160), (2, 7, 5), (1, 1, 3),
                                   (2, 2, 9)])
def test_pyr_down_and_up_match_jax(shape):
    v = _video(shape, 0)
    _close([tpyr.pyr_down(torch.from_numpy(v))],
           [jpyr.pyr_down(jnp.asarray(v))])
    h, w = shape[-2:]
    for dst in [(2 * h, 2 * w), (2 * h - 1, 2 * w - 1)]:
        _close([tpyr.pyr_up(torch.from_numpy(v), dst)],
               [jpyr.pyr_up(jnp.asarray(v), dst)])


@pytest.mark.parametrize("shape,levels", [((2, 60, 80), 4),
                                          ((2, 135, 192), 7)])
def test_pyramids_and_collapse_match_jax(shape, levels):
    v = _video(shape, 1)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    _close(tpyr.gaussian_pyramid(tv, levels),
           jpyr.gaussian_pyramid(jv, levels))
    lap_t = tpyr.laplacian_pyramid(tv, levels)
    lap_j = jpyr.laplacian_pyramid(jv, levels)
    _close(lap_t, lap_j)
    _close([tpyr.collapse_laplacian_pyramid(lap_t)],
           [jpyr.collapse_laplacian_pyramid(lap_j)])
    assert tpyr.pyramid_shapes(*shape[1:], levels) == \
        jpyr.pyramid_shapes(*shape[1:], levels)


@pytest.mark.parametrize("shape,levels,skip", [
    ((3, 120, 160), 6, 2),
    ((2, 480, 640), 9, 4),   # production geometry (odd tiny levels)
    ((2, 60, 80), 4, 1),
])
def test_band_levels_match_pallas_interpret(shape, levels, skip):
    v = _video(shape, 0)
    got = pyramid_cuda.laplacian_band_levels(torch.from_numpy(v), levels,
                                             skip)
    want = laplacian_band_levels(jnp.asarray(v), levels, skip,
                                 interpret=True)
    _close(got, want)


@pytest.mark.parametrize("shape,s1,nt", [
    ((2, 135, 192), 1, 2),
    ((2, 135, 192), 2, 2),
    ((2, 135, 192), 2, 4),
    ((3, 67, 256), 1, 4),
    ((2, 68, 240), 2, 3),
])
def test_gauss_level_matches_pallas_interpret(shape, s1, nt):
    v = _video(shape, 2)
    got = pyramid_cuda.gauss_level(torch.from_numpy(v), s1)
    want = gauss_level_tiled(jnp.asarray(v), s1, nt, interpret=True)
    _close([got], [want])


def test_two_stage_composition_matches_full_chain():
    # gauss_level then the band levels of the rest == the whole chain
    # (the TPU's 1080p composition, in miniature).
    v = torch.from_numpy(_video((2, 135, 192), 3))
    levels, skip, s1 = 7, 3, 2
    g = pyramid_cuda.gauss_level(v, s1)
    got = pyramid_cuda.laplacian_band_levels(g, levels - s1, skip - s1)
    want = tpyr.laplacian_pyramid(v, levels)[skip:levels - 1]
    _close(got, [w.numpy() for w in want], atol=0)


def test_cpu_wrappers_run_the_plain_version_without_launching():
    # The second geometry's plan takes all three kernels' routes.
    _build.reset_launches()
    for shape, levels, skip in [((2, 30, 40), 4, 1), ((1, 480, 640), 9, 1)]:
        v = torch.from_numpy(_video(shape, 4))
        got = pyramid_cuda.laplacian_band_levels(v, levels, skip)
        want = pyramid_cuda.laplacian_band_levels_ref(v, levels, skip)
        _close(got, [w.numpy() for w in want], atol=0)
    assert {k: _build.LAUNCHES[k] for k in pyramid_cuda.KERNELS.counted} \
        == {"pyr_down_levels_d1": 0, "pyr_down_levels_d2": 0,
            "pyr_tail": 0, "lap_level": 0}


def test_wrappers_reject_bad_input():
    v = torch.zeros((2, 8, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_down(v)


@pytest.mark.parametrize("t_len,shape", [(64, (15, 20)), (33, (4, 5))])
def test_temporal_bandpass_matches_jax(t_len, shape):
    v = _video((t_len,) + shape, 5)
    args = (10.0, 0.1, 1.0, 500.0)
    got = tfft.temporal_bandpass_fft(torch.from_numpy(v), *args).numpy()
    want = np.asarray(jfft.temporal_bandpass_fft(jnp.asarray(v), *args))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert np.array_equal(
        tfft.packed_bandpass_operator(t_len, *args),
        jfft.packed_bandpass_operator(t_len, *args))
