"""The connected-component kernel (``csrc/ccl.cu``) against the plain
version (``ccl._largest_component_bbox``, one mask at a time) on the card,
bit for bit in x, y, w, h, found and area.  Every test here needs a card
and skips without one.  The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_ccl_cuda.py -o addopts="" \\
        --noconftest -q
"""

import numpy as np
import pytest
import torch

from respmon_tpu_torch.config import CalibrationConfig
from respmon_tpu_torch.io.synthetic import breathing_clip
from respmon_tpu_torch.ops import _build, ccl
from respmon_tpu_torch.pipeline import evm, streaming
from test_torch_ccl import EDGE_CASES

pytestmark = pytest.mark.cuda

# The main path's shapes: the 64-stream fleet's coarse localize, a 640x480
# calibration and 1080p calibrations.
SHAPES = [(64, 68, 120), (1, 480, 640), (2, 1080, 1920)]
DENSITIES = [0.02, 0.3, 0.5, 0.62, 0.9]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain(fg):
    """The plain version, mask by mask, on fg's device."""
    parts = [ccl._largest_component_bbox(img)[0] for img in fg]
    return ccl.BBoxResult(*(torch.stack(f) for f in zip(*parts)))


def _assert_same(got, want, what):
    for name, g, w in zip(ccl.BBoxResult._fields, got, want):
        assert g.device == w.device and g.dtype == w.dtype, (what, name)
        assert torch.equal(g, w), (what, name, g.tolist(), w.tolist())


def _blobs(gen, shape, dev):
    """Discs and rings of random sizes, some with holes, some crossing
    tile edges."""
    s, h, w = shape
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    fg = torch.zeros(shape, dtype=torch.bool, device=dev)
    for k in range(s):
        for _ in range(6):
            cy, cx, r = (int(torch.randint(0, n, (1,), generator=gen))
                         for n in (h, w, max(4, min(h, w) // 3)))
            d = (yy - cy) ** 2 + (xx - cx) ** 2
            hollow = r % 2          # odd radii make rings
            fg[k] |= (d < r * r) & (d >= hollow * (r // 2) ** 2)
    return fg


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("density", DENSITIES)
def test_random_masks_equal_the_plain_version(dev, shape, density):
    gen = torch.Generator(device="cpu").manual_seed(int(density * 100))
    fg = (torch.rand(shape, generator=gen) < density).to(dev)
    _assert_same(ccl.largest_component_bbox_batch(fg), _plain(fg),
                 (shape, density))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_blobs_equal_the_plain_version(dev, shape):
    gen = torch.Generator(device="cpu").manual_seed(3)
    fg = _blobs(gen, shape, dev)
    _assert_same(ccl.largest_component_bbox_batch(fg), _plain(fg), shape)


def test_edge_cases(dev):
    masks = np.stack([m for m, _ in EDGE_CASES.values()])
    fg = torch.from_numpy(masks).to(dev)
    got = ccl.largest_component_bbox_batch(fg)
    _assert_same(got, _plain(fg), "edge cases")
    for k, (name, (_, want)) in enumerate(EDGE_CASES.items()):
        box = [f[k].item() for f in got]
        assert tuple(box) == want, name


def _capture(monkeypatch, name):
    seen = []
    fn = getattr(ccl, name)

    def wrapped(fg):
        seen.append(fg.clone())
        return fn(fg)
    monkeypatch.setattr(ccl, name, wrapped)
    return seen


def test_the_masks_of_a_real_localize_and_locate(dev, monkeypatch):
    """The masks that a fleet's coarse localize (4 streams of 640x480 at
    level 4) and a 640x480 calibration hand the CCL."""
    cfg = CalibrationConfig(buffer_length=64)
    clips = np.stack([breathing_clip(
        num_frames=64, height=480, width=640, fps=10.0, bpm=bpm,
        patch_center=(200 + 20 * k, 240 + 60 * k), patch_size=(80, 100),
        amplitude=0.12, seed=k) for k, bpm in enumerate((15, 18, 21, 24))])
    u8 = np.clip(np.round(clips * 255.0), 0, 255).astype(np.uint8)
    buffers = torch.from_numpy(u8).to(dev)
    batches = _capture(monkeypatch, "largest_component_bbox_batch")
    state = streaming.init_streaming_from_buffers_batch(buffers, cfg)
    streaming.localize_batch(state, (480, 640), torch.float32, 10.0, cfg,
                             coarse=True)
    evm.locate(buffers[1], 10.0, cfg)
    monkeypatch.undo()
    assert [tuple(b.shape) for b in batches] == [(4, 30, 40), (1, 480, 640)]
    for fg in batches:
        assert bool(fg.any())
        _assert_same(ccl.largest_component_bbox_batch(fg), _plain(fg),
                     tuple(fg.shape))


def test_the_batched_call_makes_no_host_read(dev):
    fg = torch.rand((64, 68, 120), device=dev) < 0.6
    ccl.largest_component_bbox_batch(fg)      # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        box = ccl.largest_component_bbox_batch(fg)
        one = ccl.largest_component_bbox(fg[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same(box, _plain(fg), "no host read")
    assert torch.equal(one.x, box.x[3]) and torch.equal(one.area, box.area[3])


def test_the_launch_counter(dev):
    fg = torch.rand((64, 68, 120), device=dev) < 0.5
    _build.reset_launches()
    ccl.largest_component_bbox_batch(fg)
    assert _build.LAUNCHES["ccl"] == 1
    ccl.largest_component_bbox(fg[0])
    assert _build.LAUNCHES["ccl"] == 2
    ccl.largest_component_bbox_batch(fg.cpu())     # the plain version
    assert _build.LAUNCHES["ccl"] == 2
    with pytest.raises(ValueError):                # 2**23 pixels a mask
        ccl.largest_component_bbox_batch(
            torch.zeros((1, 2048, 4096), dtype=torch.bool, device=dev))
    assert _build.LAUNCHES == dict(dict.fromkeys(_build.LAUNCHES, 0), ccl=2)
    _build.reset_launches()
    assert _build.LAUNCHES["ccl"] == 0
