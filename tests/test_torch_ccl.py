"""ops/ccl's batched entry point on the CPU: the plain version batch against
one mask at a time, pinned edge cases, and the logic of ``csrc/ccl.cu``'s
kernels run on the host (``tests/ccl_host.cpp``) against the plain
version.  The kernels themselves run on the card only:
``tests/test_torch_ccl_cuda.py``.  Imports neither JAX nor the JAX
package, so ``tests/test_torch_ccl_cuda.py`` takes ``EDGE_CASES`` from
here."""

import ctypes
import math
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from respmon_tpu_torch.ops import _build, ccl

torch.set_num_threads(1)

H, W = 12, 16


def _mask(*rects, h=H, w=W):
    """An (h, w) mask with each (y0, y1, x0, x1) rectangle set."""
    m = np.zeros((h, w), bool)
    for y0, y1, x0, x1 in rects:
        m[y0:y1, x0:x1] = True
    return m


def _ring(y0, y1, x0, x1, h=H, w=W, base=None):
    """A 1-pixel rectangular ring with corners (y0, x0), (y1 - 1, x1 - 1)."""
    m = np.zeros((h, w), bool) if base is None else base.copy()
    m[y0, x0:x1] = m[y1 - 1, x0:x1] = True
    m[y0:y1, x0] = m[y0:y1, x1 - 1] = True
    return m


def _pinched():
    """A ring whose background opens to the outside only through a
    diagonal step: sealed under 4-connectivity, so it is filled."""
    m = _ring(2, 10, 3, 12)
    m[2, 7] = False          # a gap in the top edge ...
    m[1, 7] = True           # ... bridged diagonally from above
    m[1, 6] = m[1, 8] = False
    return m


def _diagonal():
    """Two 2x2 blocks meeting only at a corner (one 8-connected component
    of area 2), and a lone 2x2 block later in raster order (area 1)."""
    return _mask((2, 4, 2, 4), (4, 6, 4, 6), (8, 10, 12, 14))


def _borders(side):
    """One 3x4 block touching ``side`` and a 2x2 block inside."""
    block = {"top": (0, 3, 5, 9), "bottom": (H - 3, H, 5, 9),
             "left": (4, 7, 0, 4), "right": (4, 7, W - 4, W)}[side]
    return _mask(block, (8, 10, 7, 9) if side != "bottom" else (1, 3, 7, 9))


def _box(side):
    y0, y1, x0, x1 = {"top": (0, 3, 5, 9), "bottom": (H - 3, H, 5, 9),
                      "left": (4, 7, 0, 4), "right": (4, 7, W - 4, W)}[side]
    return (x0, y0, x1 - x0, y1 - y0, True, 6.0)


# name: (mask, (x, y, w, h, found, area)) as cv2's findContours(EXTERNAL),
# contourArea and boundingRect give them.
EDGE_CASES = {
    "empty": (np.zeros((H, W), bool), (W, H, -W, -H, False, -math.inf)),
    "full": (np.ones((H, W), bool), (0, 0, W, H, True, (H - 1) * (W - 1))),
    "single_pixel": (_mask((5, 6, 9, 10)), (9, 5, 1, 1, True, 0.0)),
    **{f"touches_{side}": (_borders(side), _box(side))
       for side in ("top", "bottom", "left", "right")},
    "hole": (_ring(2, 10, 3, 12), (3, 2, 9, 8, True, 56.0)),
    "ring_in_a_hole": (_ring(5, 8, 6, 10, base=_ring(2, 11, 3, 13)),
                       (3, 2, 10, 9, True, 72.0)),
    "diagonal_pinch": (_pinched(), (3, 1, 9, 9, True, 57.0)),
    "equal_areas_raster_first": (_mask((6, 10, 1, 5), (2, 6, 10, 14)),
                                 (10, 2, 4, 4, True, 9.0)),
    "diagonal_only": (_diagonal(), (2, 2, 4, 4, True, 2.0)),
}


def _fields(box):
    return (int(box.x), int(box.y), int(box.w), int(box.h),
            bool(box.found), float(box.area))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _random_batch(seed, shape, density):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape) < density)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_cases_are_pinned(name):
    mask, want = EDGE_CASES[name]
    fg = torch.from_numpy(mask)
    one = ccl.largest_component_bbox(fg)
    assert _fields(one) == want
    # The same mask in a batch, beside its complement, gives the same box.
    batch = ccl.largest_component_bbox_batch(torch.stack([~fg, fg]))
    assert _fields(ccl.BBoxResult(*(f[1] for f in batch))) == want
    assert one.x.dtype == torch.int32 and one.area.dtype == torch.float32
    assert one.found.dtype == torch.bool and one.x.shape == ()


@pytest.mark.parametrize("shape,density", [((5, 20, 30), 0.45),
                                           ((3, 34, 60), 0.6),
                                           ((4, 17, 23), 0.3)])
def test_batch_equals_the_per_image_loop(shape, density):
    fg = _random_batch(11, shape, density)
    fg[0] = False                      # an empty mask among full ones
    got = ccl.largest_component_bbox_batch(fg)
    parts = [ccl._largest_component_bbox(img)[0] for img in fg]
    for name, field in zip(ccl.BBoxResult._fields, got):
        want = torch.stack([getattr(p, name) for p in parts])
        assert field.shape == (shape[0],) and torch.equal(field, want), name


@pytest.mark.parametrize("fg", [torch.zeros((2, 4, 4), dtype=torch.uint8),
                                torch.zeros((4, 4), dtype=torch.bool),
                                torch.zeros((0, 4, 4), dtype=torch.bool),
                                torch.zeros((2, 0, 4), dtype=torch.bool)],
                         ids=["uint8", "2d", "no_masks", "no_rows"])
def test_batch_rejects_what_it_does_not_take(fg):
    with pytest.raises(ValueError):
        ccl.largest_component_bbox_batch(fg)


@pytest.fixture(scope="module")
def host_ccl(tmp_path_factory):
    """``csrc/ccl.cu``'s kernels built for the host (``tests/ccl_host.cpp``):
    (fg batch, grid, seed) -> ``BBoxResult``."""
    out = tmp_path_factory.mktemp("ccl_host")
    text = (_build.CSRC / "ccl.cu").read_text()
    text = text[:text.index('extern "C"')]
    (out / "ccl_kernels.inc").write_text(
        text.replace("#include <cuda_runtime.h>\n", ""))
    lib = out / "libccl_host.so"
    src = Path(__file__).with_name("ccl_host.cpp")
    subprocess.run([_build.find_cxx(), "-O2", "-std=c++17", "-shared",
                    "-fPIC", "-I", str(out), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).host_ccl
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_uint]
    fn.restype = None

    def run(fg, grid, seed):
        s, h, w = fg.shape
        fg = fg.contiguous()
        work = torch.full((9 * s * h * w + s,), -7, dtype=torch.int32)
        xywh = torch.empty((4, s), dtype=torch.int32)
        found = torch.empty(s, dtype=torch.bool)
        area = torch.empty(s, dtype=torch.float32)
        fn(fg.data_ptr(), s, h, w, work.data_ptr(), xywh.data_ptr(),
           found.data_ptr(), area.data_ptr(), grid, seed)
        return ccl.BBoxResult(*xywh, found, area)
    return run


def _snake(h, w, sealed):
    """Foreground everywhere but a 1-pixel background channel that winds
    across tile edges, open to the border unless ``sealed`` (then a hole)."""
    m = np.ones((h, w), bool)
    for k in range((w - 10) // 24):
        x = 5 + 24 * k
        m[1:h - 1, x] = False
        m[h - 2 if k % 2 == 0 else 1, x:x + 25] = False
    m[0, 5] = sealed
    return m


def _spanning_ring(h, w):
    """A 1-pixel ring around most of the mask: its hole spans tiles."""
    return _ring(10, h - 9, 10, w - 9, h=h, w=w)


@pytest.mark.parametrize("case", [
    "edge_cases", "random_68x120", "random_tiles_150x300",
    "random_ragged_73x129", "snake_open", "snake_sealed", "spanning_ring",
    "checkerboard", "thin_rows_and_columns"])
def test_kernel_logic_on_the_host_equals_the_plain_version(host_ccl, case):
    """The kernels' logic, tiles and tile-edge merges included (a mask wider
    than 128 or taller than 72 pixels spans tiles), run block by block in
    shuffled orders, against the plain version."""
    h, w = 150, 300
    if case == "edge_cases":
        fg = torch.from_numpy(np.stack([m for m, _ in EDGE_CASES.values()]))
    elif case.startswith("random"):
        shape = {"random_68x120": (4, 68, 120),
                 "random_tiles_150x300": (2, 150, 300),
                 "random_ragged_73x129": (3, 73, 129)}[case]
        fg = torch.stack([_random_batch(k, shape[1:], d) for k, d in
                          enumerate((0.3, 0.45, 0.55, 0.7)[:shape[0]])])
    elif case.startswith("snake"):
        fg = torch.from_numpy(_snake(h, w, case == "snake_sealed"))[None]
    elif case == "spanning_ring":
        fg = torch.from_numpy(_spanning_ring(h, w))[None]
    elif case == "checkerboard":
        fg = torch.from_numpy(np.add.outer(np.arange(h), np.arange(w))
                              % 2 == 0)[None]
    else:     # one pixel, single rows and single columns
        fg = [torch.tensor([[[True]], [[False]]]),
              _random_batch(3, (2, 1, 200), 0.5),
              _random_batch(4, (2, 150, 1), 0.5)]
    batches = fg if isinstance(fg, list) else [fg, ~fg]
    for batch in batches:
        want = ccl.largest_component_bbox_batch(batch)
        for seed, grid in ((0, 1), (1, 7), (2, 64)):
            assert _same(host_ccl(batch, grid, seed), want), (case, seed)
