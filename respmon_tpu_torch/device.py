"""Where an entry point of the port runs: the card, unless the caller asks
for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None,
            like: Optional[torch.Tensor] = None) -> torch.device:
    """The device an entry point computes on.

    A given ``device`` is taken as it is.  ``None`` means the card: the
    device of ``like`` when that is a CUDA tensor, else ``cuda:0`` (a numpy
    array or a CPU tensor goes to the card too).  Without a CUDA device
    ``None`` raises; a CPU run has to be asked for with ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if like is not None and like.device.type == "cuda":
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "respmon_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)
