"""Port parity: ops/dtype (u8 widen, trunc-and-wrap narrow, ingest)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from respmon_tpu.ops import dtype as jdtype
from respmon_tpu_torch.ops import dtype as tdtype

torch.set_num_threads(1)


def _all_bytes():
    return np.arange(256, dtype=np.uint8)


def test_uint8_to_float_all_bytes_bit_exact():
    b = _all_bytes()
    want = (b.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)
    got = tdtype.uint8_to_float(torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    jax_f32 = np.asarray(jdtype.uint8_to_float(jnp.asarray(b)))
    assert np.array_equal(got.view(np.uint32), jax_f32.view(np.uint32))


def test_uint8_to_float_f64_matches_jax():
    b = _all_bytes()
    got = tdtype.uint8_to_float(torch.from_numpy(b), torch.float64).numpy()
    want = np.asarray(jdtype.uint8_to_float(jnp.asarray(b), jnp.float64))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("values", [
    [0.0, 0.5, 1.0, 0.999999, 1.0 / 255.0],
    [1.5, 2.0, -0.1, -1.0, 3.7],          # out of range: wraps mod 256
    [1.0000001, 254.9 / 255.0, 255.5 / 255.0, -0.003],
])
def test_float_to_uint8_wrap_matches_jax(values):
    x = np.asarray(values, np.float32)
    got = tdtype.float_to_uint8(torch.from_numpy(x)).numpy()
    want = np.asarray(jdtype.float_to_uint8(jnp.asarray(x)))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_float_to_uint8_lattice_roundtrip():
    b = _all_bytes()
    f = tdtype.uint8_to_float(torch.from_numpy(b))
    assert np.array_equal(tdtype.float_to_uint8(f).numpy(), b)


def test_ingest_frames_contract():
    u8 = np.zeros((2, 4, 4), np.uint8)
    assert tdtype.ingest_frames(u8, torch.float32,
                                device="cpu").dtype == torch.uint8
    f = np.zeros((2, 4, 4), np.float64)
    assert tdtype.ingest_frames(f, torch.float32,
                                device="cpu").dtype == torch.float32
    with pytest.raises(ValueError):
        tdtype.ingest_frames(u8, torch.float64, device="cpu")
    t = torch.zeros((2, 4, 4), dtype=torch.float64)
    assert tdtype.ingest_frames(t, torch.float32,
                                device="cpu").dtype == torch.float32
