"""Start ranks for the sharded paths: ``run_ranks(fn, n, backend, device)``.

The JAX package runs its sharded programs in one process over the devices
it sees; the port runs one process per rank.  ``run_ranks`` spawns ``n``
of them with ``torch.multiprocessing``, joins each to a process group of
``n`` ranks through a ``file://`` store in a temporary directory (no port
to collide with when several launches run at once), calls ``fn(device,
*args)`` on every rank and returns each rank's result, in rank order.

``fn`` must be importable (a module-level function): a spawned child
imports it anew and cannot reach a closure.  What it returns is saved
with ``torch.save`` and loaded onto the CPU.

``single_rank(backend)`` makes the calling process the one rank of a
process group instead: a one-card machine runs the sharded paths so,
with NCCL, and a test compares a one-rank mesh with no mesh so.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Any, Callable, Iterator, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 300   # a collective that waits longer than this fails the rank


def _init(backend: str, tmp: str, n: int, rank: int) -> None:
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


@contextlib.contextmanager
def single_rank(backend: str = "gloo") -> Iterator[None]:
    """This process as rank 0 of a one-rank process group for the
    duration of the block (``make_mesh`` then makes one-rank meshes)."""
    with tempfile.TemporaryDirectory(prefix="respmon_rank_") as tmp:
        _init(backend, tmp, 1, 0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, n: int, backend: str, device: str,
               tmp: str, args: Sequence[Any]) -> None:
    if device == "cpu":
        dev = torch.device("cpu")
        # n ranks share the host's cores.
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _init(backend, tmp, n, rank)
    try:
        out = fn(dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, backend: str = "gloo",
              device: str = "cpu", args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(device, *args)`` on ``n`` spawned ranks and return their
    results in rank order.  ``backend`` is ``"gloo"`` (CPU tensors) or
    ``"nccl"`` (one card a rank); ``device`` is ``"cpu"`` or ``"cuda"``.
    A rank that raises makes this raise, with its traceback."""
    with tempfile.TemporaryDirectory(prefix="respmon_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(fn, n, backend, device, tmp,
                                             tuple(args)),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
