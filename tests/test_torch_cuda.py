"""The port on an NVIDIA GPU: CUDA kernels against their plain versions,
and the card's results against the CPU's.  Every test here needs a card
and skips without one.  The file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_cuda.py -o addopts="" --noconftest -q
"""

import numpy as np
import pytest
import torch

from respmon_tpu.config import CalibrationConfig, MonitorConfig
from respmon_tpu.io.synthetic import breathing_clip
from respmon_tpu_torch.ops import pyramid_cuda
from respmon_tpu_torch.ops.dtype import uint8_to_float
from respmon_tpu_torch.pipeline import evm, scan

pytestmark = pytest.mark.cuda

CAL = CalibrationConfig(pyramid_levels=6, skip_levels_at_top=2,
                        buffer_length=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _video(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)


def test_uint8_to_float_all_bytes(dev):
    b = np.arange(256, dtype=np.uint8)
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got = uint8_to_float(torch.from_numpy(b).to(dev)).cpu().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape,levels,skip", [((3, 135, 192), 7, 3),
                                               ((2, 5, 7), 3, 0),
                                               ((1, 1, 1), 2, 0),
                                               ((2, 480, 640), 9, 4)])
def test_kernels_equal_plain_bit_for_bit(dev, shape, levels, skip):
    v = _video(shape, dev)
    pyramid_cuda.reset_launches()
    got = pyramid_cuda.laplacian_band_levels(v, levels, skip)
    assert pyramid_cuda.LAUNCHES == {"pyr_down": levels - 1,
                                     "lap_level": levels - 1 - skip}
    want = pyramid_cuda.laplacian_band_levels_ref(v, levels, skip)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for s1 in (1, 2):
        assert torch.equal(pyramid_cuda.gauss_level(v, s1),
                           pyramid_cuda.gauss_level_ref(v, s1))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    v = _video((2, 16, 16), dev)
    with pytest.raises(TypeError):
        pyramid_cuda.pyr_down(v.double())
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_down(v.transpose(1, 2))
    with pytest.raises(ValueError):
        pyramid_cuda.pyr_down(v[0])
    with pytest.raises(ValueError):
        pyramid_cuda.lap_level(v, v[:, :4, :4].contiguous())


def test_locate_constant_video_not_found(dev):
    vid = torch.full((32, 48, 64), 0.5, device=dev)
    cfg = CalibrationConfig(pyramid_levels=4, skip_levels_at_top=1,
                            buffer_length=32)
    assert not bool(evm.locate(vid, 10.0, cfg).found)


def test_process_clip_card_matches_cpu(dev):
    clip = breathing_clip(num_frames=64 + 1 + 80, height=120, width=160,
                          fps=10.0, bpm=18.0, patch_center=(60, 80),
                          patch_size=(30, 40), amplitude=0.12)
    cfg = MonitorConfig(calibration=CAL)
    got = scan.process_clip(torch.from_numpy(clip).to(dev), 10.0, cfg)
    want = scan.process_clip(clip, 10.0, cfg)
    assert got.found and got.roi == want.roi
    has = want.measure.has_bpm
    assert torch.equal(got.measure.has_bpm.cpu(), has)
    np.testing.assert_allclose(got.measure.bpm.cpu()[has].numpy(),
                               want.measure.bpm[has].numpy(), rtol=1e-5)
