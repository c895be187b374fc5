"""dtype conversions matching the reference converters (transforms.py:16-35).

Port of ``respmon_tpu/ops/dtype.py``: ``float_to_uint8`` truncates and wraps
mod 256 like a store into a numpy uint8 array; ``uint8_to_float`` returns
the exact f32 image of the reference's f64 ``b * (1/255)`` chain.
"""

from __future__ import annotations

import numpy as np
import torch

from respmon_tpu_torch import device as device_mod


def uint8_to_float(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [0,1], bit-exact to the host reference chain.

    For f32 the exact image of the f64 chain is the correctly rounded
    quotient b/255.  Eager IEEE division gives it, but only when the
    divisor is a tensor on the input's device: PyTorch's CUDA ``div``
    rewrites division by a CPU scalar into a reciprocal multiply, which is
    one ULP off on 126 of the 256 bytes.  f64 output reproduces the
    reference multiply verbatim.
    """
    if dtype == torch.float64:
        return img.to(torch.float64) * (1.0 / 255.0)
    x = img.to(dtype)
    return x / torch.tensor(255.0, dtype=dtype, device=x.device)


def float_to_uint8(img: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8 with numpy-style trunc-and-wrap (mod 256).

    NaN casts to an unspecified int32 that differs by platform; callers
    (``evm._finish_locate``) only rely on the NaN heatmap failing the
    threshold, which holds for any byte below 255 * threshold — pinned by
    the constant-video found=False test on CPU and on the card."""
    scaled = torch.trunc(img.to(torch.float32) * 255.0)
    wrapped = torch.remainder(scaled.to(torch.int32), 256)
    return wrapped.to(torch.uint8)


def ingest_frames(frames, dtype=torch.float32, device=None) -> torch.Tensor:
    """Stage a frame batch for the device: uint8 ships as bytes (widened by
    the consuming stage), anything else casts to the compute ``dtype``.

    ``frames`` is a numpy array or a tensor; ``device=None`` means the
    card (``device.resolve``: a CUDA tensor stays where it is, numpy and
    CPU tensors go to ``cuda:0``, and without a card it raises), so a CPU
    run passes ``device="cpu"``.  uint8 ingest implies float32 compute, as
    in the JAX package."""
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    device = device_mod.resolve(device, frames)
    if frames.dtype == torch.uint8:
        if dtype != torch.float32:
            raise ValueError(
                "uint8 frame ingest implies float32 compute; convert "
                f"host-side for dtype={dtype} (ops/dtype.uint8_to_float)")
        return frames.to(device).contiguous()
    return frames.to(device=device, dtype=dtype).contiguous()
