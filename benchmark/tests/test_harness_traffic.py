"""The traffic generator is deterministic in the seed and differs across
seeds, and gives every seed the same mix."""

import numpy as np
import pytest
import torch

from benchmark.harness import cells, drive
from benchmark.harness import frames as gen
from benchmark.kinds import blackout, steady
from benchmark.tests.conftest import small

SEED_A, SEED_B = 4_294_967_311, 12


@pytest.mark.parametrize("traffic", ["steady_1875", "steady_3rates",
                                     "blackout_cycles"])
def test_pools_deterministic_and_seeded(traffic):
    t = cells.load_json(cells.BENCH / "traffic" / f"{traffic}.json")
    hw = (60, 80)

    def pools(seed):
        subj = gen.subjects(t, seed, hw, 10.0)
        return subj, gen.make_pools(subj, t, hw, seed, "cpu")

    sa, pa = pools(SEED_A)
    sa2, pa2 = pools(SEED_A)
    sb, pb = pools(SEED_B)
    assert sa == sa2
    assert all(torch.equal(x, y) for x, y in zip(pa, pa2))
    same = sa == sb and all(torch.equal(x, y) for x, y in zip(pa, pb))
    # A fixed content seed gives every run seed the same subjects.
    assert same == ("content_seed" in t)
    assert [s.period for s in sa] == [s.period for s in sb]
    assert all(p.dtype == torch.uint8 and int(p.max()) <= 250 for p in pa)


def test_periods_are_whole_breaths():
    assert gen.period_frames(18.75, 10.0) == 32
    assert gen.period_frames(15.0, 10.0) == 40
    assert gen.period_frames(24.0, 10.0) == 25
    with pytest.raises(ValueError):
        gen.period_frames(18.0, 10.0)


def test_dither_differs_by_cycle_and_seed():
    a = gen.dither(SEED_A, 3, (20, 30), 2)
    assert np.array_equal(a, gen.dither(SEED_A, 3, (20, 30), 2))
    assert not np.array_equal(a, gen.dither(SEED_A, 4, (20, 30), 2))
    assert not np.array_equal(a, gen.dither(SEED_B, 3, (20, 30), 2))
    assert a.max() < 2


def _blackout_source(seed):
    sizes, traffic = small("cam640.recover")
    c = cells.cell("cam640.recover")
    run = drive.make_run(c, seed, "cpu", sizes, traffic)
    t = run.traffic
    subj = gen.subjects(t, seed, run.frame_hw, run.fps)
    pools = [p.numpy() for p in gen.make_pools(subj, t, run.frame_hw, seed,
                                               "cpu")]
    return blackout.BlackoutSource(pools, seed, run.fps, t["dither_levels"],
                                   66)


def test_blackout_cycles_seeded_and_distinct():
    a, a2, b = (_blackout_source(s) for s in (SEED_A, SEED_A, SEED_B))
    for c in range(4):
        assert np.array_equal(a.frame(c, 5), a2.frame(c, 5))
    assert any(not np.array_equal(a.frame(c, 5), b.frame(c, 5))
               for c in range(4))
    bufs = [np.stack([a.frame(c, j) for j in range(1, 65)]) for c in range(6)]
    for i in range(len(bufs)):
        for j in range(i):
            assert not np.array_equal(bufs[i], bufs[j])
    a.prepare(2)
    assert all(np.array_equal(a._buf[j], a.frame(2, j)) for j in range(66))


def test_fleet_same_work_in_another_order():
    def frames(seed):
        sizes, traffic = small("fleet64_1080p.flow", streams=6)
        r = drive.make_run(cells.cell("fleet64_1080p.flow"), seed, "cpu",
                           sizes, traffic)
        return steady.source(r)
    a, a2, b = frames(SEED_A), frames(SEED_A), frames(SEED_B)
    assert torch.equal(a.frames(7), a2.frames(7))
    assert not np.array_equal(a.clip_of, b.clip_of) \
        or not np.array_equal(a.phase0, b.phase0)

    def lanes(src):
        return sorted(zip(src.clip_of.tolist(), src.phase0.tolist()))
    assert lanes(a) == lanes(b)
    fa = {tuple(x) for x in a.frames(7).reshape(6, -1)[:, :64].tolist()}
    fb = {tuple(x) for x in b.frames(7).reshape(6, -1)[:, :64].tolist()}
    assert fa == fb
    out = torch.empty_like(a.frames(7))
    a.fill(7, out)
    assert torch.equal(out, a.frames(7))
