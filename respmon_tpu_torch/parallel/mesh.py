"""Device meshes over ``torch.distributed``.

Port of ``respmon_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` over the devices one process sees and places arrays
on it; the port runs one process (a rank) per device, and a mesh is one
named axis over the whole default process group.  A ``Mesh`` knows its
axis's name and size, this rank's index along it, and the rank's device:
``cuda:<local rank>`` by default, the CPU when asked for.  Every sharded
path shards one axis, so meshes are 1-D.

Sharded code talks to the other ranks only through the mesh's collective
methods (``all_gather``, ``all_reduce``, ``reduce_scatter``, ``exchange``,
``barrier``), and each adds one to ``mesh.collectives[name]``, so a test
can count what a step sends.  ``make_mesh`` needs an initialised process
group (``parallel/launch.run_ranks`` starts ranks with one); without one it
raises.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class Mesh:
    """This rank's view of a 1-D mesh: one named axis over the ranks of
    the default process group, in rank order.  The collectives take the
    axis's name, as the JAX package's do, and raise ``KeyError`` for
    another."""

    def __init__(self, axis_name: str, size: int, rank: int,
                 device: torch.device) -> None:
        self.axis_names = (axis_name,)
        self.shape: Dict[str, int] = {axis_name: size}
        self._rank = rank
        self.device = device
        self.collectives: collections.Counter = collections.Counter()

    def _size(self, axis: str) -> int:
        if axis not in self.shape:
            raise KeyError(f"{axis!r} is not this mesh's axis "
                           f"{self.axis_names[0]!r}")
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (``lax.axis_index``)."""
        self._size(axis)
        return self._rank

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
        axis order (``lax.all_gather(..., tiled=True)``)."""
        self.collectives["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self._size(axis))]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, op: str, axis: str) \
            -> torch.Tensor:
        """``x`` reduced over ``axis`` with ``op`` ("sum", "min" or "max");
        ``x`` itself is left as it was."""
        self._size(axis)
        self.collectives["all_reduce"] += 1
        out = x.clone().contiguous()
        dist.all_reduce(out, op=_OPS[op])
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` of every rank's ``x``, of which this rank
        keeps its block of rows along dim 0 (``lax.psum_scatter(...,
        scatter_dimension=0, tiled=True)``)."""
        self.collectives["reduce_scatter"] += 1
        n = self._size(axis)
        parts = [p.contiguous() for p in x.chunk(n, dim=0)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts)
        return out

    def exchange(self, to_left: torch.Tensor, to_right: torch.Tensor,
                 axis: str) -> Tuple[Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
        """Neighbour exchange along ``axis``: send ``to_left`` to the rank
        before this one and ``to_right`` to the rank after it, and return
        (what the rank before sent right, what the rank after sent left).
        The first rank has no left neighbour and the last no right one:
        their sides are ``None`` and nothing is sent there (the JAX
        package's ``ppermute`` ring sends them too, and throws them away).
        """
        i, n = self.index(axis), self._size(axis)
        from_left = torch.empty_like(to_right) if i > 0 else None
        from_right = torch.empty_like(to_left) if i < n - 1 else None
        ops = []
        if i > 0:
            ops += [dist.P2POp(dist.isend, to_left.contiguous(), i - 1,
                               tag=1),
                    dist.P2POp(dist.irecv, from_left, i - 1, tag=0)]
        if i < n - 1:
            ops += [dist.P2POp(dist.isend, to_right.contiguous(), i + 1,
                               tag=0),
                    dist.P2POp(dist.irecv, from_right, i + 1, tag=1)]
        if ops:
            self.collectives["exchange"] += 1
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_left, from_right

    def barrier(self, axis: str) -> None:
        """Wait until every rank along ``axis`` has reached this call."""
        self.all_reduce(torch.zeros(1, device=self.device), "sum", axis)


def _rank_device(rank: int) -> torch.device:
    """``cuda:<local rank>``: ``LOCAL_RANK`` where a launcher set it, else
    the rank modulo the cards this host has."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh uses the rank's CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK",
                               rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("streams",),
              device=None) -> Mesh:
    """A 1-D mesh over every rank of the initialised default process
    group.  The signature is the JAX package's: ``axis_names`` holds one
    name and ``axis_sizes`` is ``None`` or ``(world size,)``; anything
    else raises ``ValueError``.  ``device=None`` means the rank's card;
    ``device="cpu"`` computes on the CPU (the gloo backend)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(parallel.launch.run_ranks starts ranks with one)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if len(axis_names) != 1 or (axis_sizes is not None
                                and tuple(axis_sizes) != (world,)):
        raise ValueError(f"a mesh is 1-D over all {world} ranks, not axes "
                         f"{tuple(axis_names)} of sizes {axis_sizes}")
    dev = _rank_device(rank) if device is None else torch.device(device)
    return Mesh(axis_names[0], world, rank, dev)


def stream_sharding(mesh: Mesh, n_streams: int,
                    axis: str = "streams") -> slice:
    """The rows of an (S, ...) stream axis that this rank owns along
    ``axis``: S / n consecutive rows, in rank order (the port's form of
    the JAX package's leading-axis ``NamedSharding``).  S must be
    divisible by the axis size."""
    n = mesh.shape[axis]
    if n_streams % n:
        raise ValueError(f"{n_streams} streams do not divide over the "
                         f"{n} ranks of mesh axis {axis!r}")
    per = n_streams // n
    i = mesh.index(axis)
    return slice(i * per, (i + 1) * per)


def replicated(mesh: Mesh) -> slice:
    """The rows of a replicated array that each rank holds: all of them."""
    del mesh
    return slice(None)
