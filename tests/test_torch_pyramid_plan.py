"""The host side of the stencil pyramid kernels (ops/pyramid_cuda, K1/K2):
the plan of launches, the plan run with the kernels' plain versions
against the plain chain and the JAX package's Pallas kernel in interpret
mode, and a model of the fused pyrDown kernel's tiling and border rule
(``csrc/pyramid.cu``, kernel A) against the whole-frame plain pyrDown."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from respmon_tpu.ops.pyramid_pallas import laplacian_band_levels
from respmon_tpu_torch.ops import pyramid as tpyr
from respmon_tpu_torch.ops import pyramid_cuda as pc

torch.set_num_threads(1)

SOURCE = (Path(pc.__file__).resolve().parent.parent / "csrc"
          / "pyramid.cu").read_text()


def _video(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# --- (a) the plan ----------------------------------------------------------

@pytest.mark.parametrize("geometry,tail_from,downs,laps", [
    ((480, 640, 9, 4), 2, ((0, 2),), ()),
    ((1080, 1920, 9, 4), 3, ((0, 2), (2, 1)), ()),
    ((135, 192, 7, 3), 0, (), ()),
    ((5, 7, 3, 0), 0, (), ()),
    ((480, 640, 9, 1), 2, ((0, 1), (1, 1)), (1,)),
    ((480, 640, 9, 0), 2, ((0, 1), (1, 1)), (0, 1)),
    ((2160, 3840, 9, 4), 4, ((0, 2), (2, 2)), ()),
])
def test_plan_of_the_configs(geometry, tail_from, downs, laps):
    p = pc.plan(*geometry)
    assert (p.tail_from, p.downs, p.laps, p.tail) == (tail_from, downs,
                                                      laps, True)


@pytest.mark.parametrize("h,w,levels,s,size", [
    (480, 640, 9, 2, 102_424),   # levels 2..8: 25,606 floats
    (1080, 1920, 9, 3, 173_140),
    (135, 192, 7, 0, 138_540),
    (481, 643, 9, 2, 104_588),
])
def test_tail_bytes_against_the_budget(h, w, levels, s, size):
    p = pc.plan(h, w, levels, 4 if levels == 9 else 3)
    assert p.tail_from == s
    assert pc.tail_bytes(h, w, levels, s) == size <= pc.TAIL_BUDGET_BYTES
    if s > 0:   # s is the first level that fits
        assert pc.tail_bytes(h, w, levels, s - 1) > pc.TAIL_BUDGET_BYTES


def test_host_limits_are_the_kernels():
    assert pc.TAIL_BUDGET_BYTES <= 227 * 1024   # a block's shared memory
    for d in range(1, pc.MAX_FUSED + 1):
        assert f"case {d}:" in SOURCE
        assert f"pyr_down_levels_d{d}" in pc.LAUNCHES
    assert f"case {pc.MAX_FUSED + 1}:" not in SOURCE


@settings(max_examples=200, deadline=None)
@given(h=st.integers(1, 5000), w=st.integers(1, 5000),
       levels=st.integers(1, 14), skip=st.integers(0, 14))
def test_plan_computes_every_kept_level_once(h, w, levels, skip):
    p = pc.plan(h, w, levels, skip)
    have = {0}
    for lvl, d in p.downs:
        assert lvl in have and 1 <= d <= pc.MAX_FUSED
        have.add(lvl + d)
    assert all(lvl in have and lvl + 1 in have for lvl in p.laps)
    kept = list(p.laps)
    if p.tail:
        assert p.tail_from in have
        assert pc.tail_bytes(h, w, levels, p.tail_from) <= pc.TAIL_BUDGET_BYTES
        kept += range(max(skip, p.tail_from), levels - 1)
    assert kept == list(range(skip, levels - 1))


def test_gauss_level_fuses_at_most_two_levels():
    assert pc._fused(0, 0) == ()
    assert pc._fused(0, 5) == ((0, 2), (2, 2), (4, 1))
    assert pc._fused(2, 9) == ((2, 2), (4, 2), (6, 2), (8, 1))


# --- (b) the plan run with the plain pieces --------------------------------

@pytest.mark.parametrize("shape,levels,skip", [
    ((2, 480, 640), 9, 4),
    ((1, 480, 640), 9, 4),    # T = 1: one absorbed streaming frame
    ((2, 480, 640), 9, 1),    # skip_top < s: the lap_level route
    ((1, 480, 640), 9, 0),
    ((2, 481, 643), 9, 4),
    ((1, 1080, 1920), 9, 4),
    ((3, 135, 192), 7, 3),
    ((2, 5, 7), 3, 0),
    ((1, 1, 1), 2, 0),
    ((2, 30, 40), 4, 3),
])
def test_plan_with_plain_pieces_equals_plain_chain(shape, levels, skip):
    v = torch.from_numpy(_video(shape, 7))
    got = pc.laplacian_band_levels(v, levels, skip)
    want = pc.laplacian_band_levels_ref(v, levels, skip)
    assert len(got) == len(want) == levels - 1 - skip
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,levels,skip", [
    ((2, 480, 640), 9, 1),
    ((2, 481, 643), 9, 4),
])
def test_plan_with_plain_pieces_matches_pallas_interpret(shape, levels,
                                                         skip):
    v = _video(shape, 8)
    got = pc.laplacian_band_levels(torch.from_numpy(v), levels, skip)
    want = laplacian_band_levels(jnp.asarray(v), levels, skip,
                                 interpret=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("s1", [0, 1, 3, 4, 7])
def test_gauss_level_in_fused_steps_equals_plain(s1):
    v = torch.from_numpy(_video((2, 200, 301), 9))
    assert torch.equal(pc.gauss_level(v, s1), pc.gauss_level_ref(v, s1))


def test_pyr_down_takes_one_or_two_levels():
    v = torch.zeros((1, 8, 8))
    for d in (0, pc.MAX_FUSED + 1):
        with pytest.raises(ValueError):
            pc.pyr_down(v, d)


# --- (c) a model of kernel A's tiling and border rule -----------------------

_K5 = np.float32([1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16])


def _reflect101(i, n):
    i = np.asarray(i)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    m = np.mod(i, period)
    return np.where(m < n, m, period - m)


def _tap5(xs):
    acc = xs[0] * _K5[0]
    for x, k in zip(xs[1:], _K5[1:]):
        acc = acc + x * k
    return acc


def _window(n, k):
    return n if k == 0 else 2 * _window(n, k - 1) + 3


def _kernel_tile(d):
    body = re.search(rf"struct Tile<{d}> \{{\s*static constexpr int rows = "
                     rf"(\d+), cols = (\d+);", SOURCE)
    return int(body.group(1)), int(body.group(2))


def _take(window, idx, lo):
    """Read a window at level indices ``idx``; raise if one lies outside
    it (numpy would wrap a negative index)."""
    local = np.asarray(idx) - lo
    assert local.min() >= 0 and local.max() < window, "read outside window"
    return local


def _model_tile(frame, d, tile, rows, cols, wide):
    """Level d at tile (row, col) of size rows x cols, as kernel A computes
    it: the clamped level-0 window (widened to multiples of 4 columns for
    16-byte copies), then per level an H pass into scratch and a W pass,
    every read mapped through reflect-101 into the window."""
    h, w = [frame.shape[0]], [frame.shape[1]]
    for _ in range(d):
        h.append((h[-1] + 1) // 2)
        w.append((w[-1] + 1) // 2)
    r_lo, r_hi, c_lo, c_hi = ([0] * (d + 1) for _ in range(4))
    r_lo[d], c_lo[d] = tile[0] * rows, tile[1] * cols
    r_hi[d] = min(r_lo[d] + rows, h[d]) - 1
    c_hi[d] = min(c_lo[d] + cols, w[d]) - 1
    for lvl in range(d - 1, -1, -1):
        r_lo[lvl] = max(2 * r_lo[lvl + 1] - 2, 0)
        r_hi[lvl] = min(2 * r_hi[lvl + 1] + 2, h[lvl] - 1)
        c_lo[lvl] = max(2 * c_lo[lvl + 1] - 2, 0)
        c_hi[lvl] = min(2 * c_hi[lvl + 1] + 2, w[lvl] - 1)
    c0 = c_lo[0] & ~3 if wide else c_lo[0]
    c1 = min((c_hi[0] + 4) & ~3, w[0]) if wide else c_hi[0] + 1
    stage = frame[r_lo[0]:r_hi[0] + 1, c0:c1]
    # What the kernel's buffers hold for this tile size.
    stage_cols = (_window(cols, d) + 6 + 3) // 4 * 4
    assert stage.shape[0] <= _window(rows, d)
    assert stage.shape[1] <= stage_cols
    origin = c0
    for lvl in range(d):
        out_rows = np.arange(r_lo[lvl + 1], r_hi[lvl + 1] + 1)
        src_rows = [_take(stage.shape[0],
                          _reflect101(2 * out_rows - 2 + k, h[lvl]),
                          r_lo[lvl]) for k in range(5)]
        src_cols = _take(stage.shape[1], np.arange(c_lo[lvl], c_hi[lvl] + 1),
                         origin)
        scratch = _tap5([stage[r][:, src_cols] for r in src_rows])
        assert scratch.size <= _window(rows, d - 1) * _window(cols, d)
        out_cols = np.arange(c_lo[lvl + 1], c_hi[lvl + 1] + 1)
        taps = [_take(scratch.shape[1],
                      _reflect101(2 * out_cols - 2 + k, w[lvl]), c_lo[lvl])
                for k in range(5)]
        stage = _tap5([scratch[:, c] for c in taps])
        origin = c_lo[lvl + 1]
    return r_lo[d], c_lo[d], stage


def _model_pyr_down(frame, d, rows, cols, wide):
    h, w = frame.shape
    for _ in range(d):
        h, w = (h + 1) // 2, (w + 1) // 2
    out = np.full((h, w), np.nan, dtype=np.float32)
    for ti in range(-(-h // rows)):
        for tj in range(-(-w // cols)):
            r, c, tile = _model_tile(frame, d, (ti, tj), rows, cols, wide)
            assert np.isnan(out[r:r + tile.shape[0], c:c + tile.shape[1]]).all()
            out[r:r + tile.shape[0], c:c + tile.shape[1]] = tile
    return out


def _plain(frame, d):
    return pc.gauss_level_ref(torch.from_numpy(frame[None]), d)[0].numpy()


@settings(max_examples=150, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90),
       d=st.integers(1, pc.MAX_FUSED),
       rows=st.integers(1, 9), cols=st.integers(1, 9), wide=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_tiling_model_equals_plain_pyr_down(h, w, d, rows, cols, wide, seed):
    frame = _video((h, w), seed)
    wide = wide and w % 4 == 0
    got = _model_pyr_down(frame, d, rows, cols, wide)
    assert np.array_equal(got, _plain(frame, d))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (1, 2), (2, 9), (5, 7),
                                 (481, 643), (480, 640), (135, 240),
                                 (1080, 1920), (270, 480)])
@pytest.mark.parametrize("d", range(1, pc.MAX_FUSED + 1))
def test_kernel_tiles_equal_plain_pyr_down(h, w, d):
    # The kernel's own tile sizes: interior, edge and corner tiles of the
    # path's frames, tiny and odd frames; 16-byte windows where W allows.
    frame = _video((h, w), h * w + d)
    rows, cols = _kernel_tile(d)
    got = _model_pyr_down(frame, d, rows, cols, w % 4 == 0)
    assert np.array_equal(got, _plain(frame, d))


# --- (d) a model of how kernel A's blocks walk the frames --------------------

def _max_grid_z():
    return int(re.search(r"kMaxGridZ = (\d+);", SOURCE).group(1))


def _walk_frames(t_len, groups):
    """Kernel A's frame loop for every block z of a tile: frame t is
    computed from stage buffer k & 1 while frame t + groups is copied into
    the other; every step commits one copy group, empty or not, and waits
    for all but the newest.  Returns the frames each z computed, checking
    that the buffer it reads holds the frame it computes, landed."""
    computed = []
    for z in range(groups):
        slots, pending, done = {}, [], []
        t = z
        if t < t_len:
            slots[0] = t
        pending.append(t if t < t_len else None)      # group 0
        k = 0
        while t < t_len:
            nxt = t + groups
            if nxt < t_len:
                slots[(k + 1) & 1] = nxt
            pending.append(nxt if nxt < t_len else None)
            landed = pending[:-1]                     # wait_but<1>
            assert landed[k] == t and slots[k & 1] == t
            done.append(t)
            k += 1
            t += groups
        computed.append(done)
    return computed


@pytest.mark.parametrize("t_len", [1, 2, 3, 128])
@pytest.mark.parametrize("h,w,d", [(480, 640, 2), (1080, 1920, 2),
                                   (270, 480, 1)])
@pytest.mark.parametrize("resident", [132, 264, 1056])
def test_frame_walk_computes_every_frame_once(t_len, h, w, d, resident):
    # launch_down: as many frame groups (grid z) as keep every block
    # resident, at least 1 and at most T.  At T = 1 (a streaming absorb)
    # there is one group, and its one frame is computed with no prefetch.
    rows, cols = _kernel_tile(d)
    hd, wd = h, w
    for _ in range(d):
        hd, wd = (hd + 1) // 2, (wd + 1) // 2
    tiles = -(-hd // rows) * -(-wd // cols)
    groups = min(max(resident // tiles, 1), t_len, _max_grid_z())
    computed = _walk_frames(t_len, groups)
    frames = sorted(t for done in computed for t in done)
    assert frames == list(range(t_len))
    if t_len == 1:
        assert groups == 1 and computed == [[0]]
