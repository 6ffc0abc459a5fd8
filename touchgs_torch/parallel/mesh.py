"""The (data, model) mesh over the ranks of a ``torch.distributed`` world,
and the row sharding of the Gaussian state (port of
``touchgs_tpu/parallel/mesh.py``).

The JAX package names two mesh axes and lets XLA's partitioner place the
collectives:

- ``data``: pixel tiles.  The compositing's tile axis is split here.
- ``model``: Gaussians.  Parameters and their Adam moments are split over
  it, ZeRO-style.

PyTorch has no partitioner, so the port writes the collectives out.
Every leaf whose leading axis is the capacity is split by rows over all
``data·model`` ranks; rank r holds rows ``[r·c, (r + 1)·c)`` of the
capacity padded to a multiple of the world (``c`` the padded capacity over
the world).  The tile grid is split the same way, rank r compositing the
r-th contiguous slice.  Both use rank order, where the JAX package orders
the Gaussian axis model-major (``P(("model", "data"))``): the split is
the same, only which rank holds which slice differs.

Two gathers carry the sharded render, each an autograd function behind a
method of ``Mesh`` (so the renderers need not import this package):

- ``Mesh.gather_rows``: all ranks' rows, in order.  Its backward is a
  reduce-scatter (sum over ranks): every rank's tiles contribute to every
  Gaussian's gradient, as ``psum_scatter``, the transpose of the JAX
  package's tiled ``all_gather``.
- ``Mesh.gather_tiles``: all ranks' composited tiles, for a loss that every
  rank computes on the whole image (SSIM's window crosses slices).  Its
  backward hands each rank its own slice of the cotangent, unsummed: the
  cotangents are equal on every rank, and a sum would scale the gradients
  by the world.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from touchgs_torch.train.optim import PARAM_GROUPS

# the mesh axes that split the Gaussian axis (rows), as the JAX package's
# param_pspecs names them
ROW_AXES = ("model", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` × ``model`` mesh over ``size`` ranks.  ``group`` is the
    process group its collectives run on; None means no process group, so
    a mesh of one rank gathers by copying and a larger one only describes
    a split."""

    data: int
    model: int
    rank: int = 0
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> tuple:
        """This rank's (data, model) coordinates."""
        return divmod(self.rank, self.model)

    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the world."""
        return -(-n // self.size) * self.size

    def gather_rows(self, x: torch.Tensor, n: Optional[int] = None
                    ) -> torch.Tensor:
        """Every rank's rows of a row-sharded ``x``, in rank order, cut to
        the first ``n`` (the unpadded capacity).  Differentiable: the
        backward reduce-scatters the gradient, summed over ranks."""
        self._collective()
        full = _GatherRows.apply(x, self)
        return full if n is None else full[:n]

    def gather_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slice of a tile-sharded ``x``, in rank order.
        Differentiable: the backward keeps this rank's slice of the
        (replicated) cotangent."""
        self._collective()
        return _GatherTiles.apply(x, self)

    def _collective(self) -> None:
        if self.group is None and self.size > 1:
            raise RuntimeError(
                f"a mesh of {self.size} ranks with no process group cannot "
                f"gather: call init_distributed first")


def make_mesh(world: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None) -> Mesh:
    """A (data, model) mesh.  ``world`` defaults to the world size of an
    initialized ``torch.distributed`` (whose default group the mesh then
    uses), else 1.  The default split puts at most 2 ways on ``model``
    (the attribute table's all-gather is cheap but not free) and the rest
    on ``data``, where the compositing work lives."""
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    n = world
    if data is None and model is None:
        model = 2 if n % 2 == 0 and n > 2 else 1
        data = n // model
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if initialized and world == dist.get_world_size():
        return Mesh(data, model, dist.get_rank(), dist.group.WORLD)
    return Mesh(data, model)


def param_pspecs() -> dict:
    """The mesh axes that split each parameter group: the Gaussian axis
    over every rank."""
    return {g: ROW_AXES for g in PARAM_GROUPS}


def named_leaves(tree, prefix: str = ""):
    """(dotted name, leaf) of every leaf of a tree of dataclasses and
    dicts, such as a ``TrainState``."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from named_leaves(getattr(tree, f.name),
                                    f"{prefix}{f.name}.")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def state_shardings(state) -> dict:
    """Each leaf of a ``TrainState`` by its dotted name, with the mesh axes
    that split its leading axis: ``ROW_AXES`` where that axis is the
    capacity (parameters, Adam moments, densify statistics), ``()``
    (replicated) for everything else."""
    capacity = state.params.capacity
    return {name: ROW_AXES if (isinstance(x, torch.Tensor) and x.dim() >= 1
                               and x.shape[0] == capacity) else ()
            for name, x in named_leaves(state)}


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``x``, whose leading axis is padded with zeros
    (False for a mask) to a multiple of the world first."""
    n = x.shape[0]
    c = mesh.padded(n) // mesh.size
    if mesh.padded(n) != n:
        x = torch.cat([x, x.new_zeros((mesh.padded(n) - n,) + x.shape[1:])])
    return x[mesh.rank * c:(mesh.rank + 1) * c].clone()


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    if mesh.group is None:
        return x.clone()
    if x.numel() == 0:
        return x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    if x.dtype == torch.bool:  # NCCL and gloo gather bytes, not bools
        return _all_gather(x.to(torch.uint8), mesh).bool()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather whose backward is a reduce-scatter (sum over ranks)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if mesh.group is None:
            return g, None
        out = g.new_empty((g.shape[0] // mesh.size,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM,
                                   group=mesh.group)
        return out, None


class _GatherTiles(torch.autograd.Function):
    """All-gather whose backward takes this rank's slice of the cotangent,
    which every rank holds whole and equal."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.n = x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.rank, ctx.n
        return g[r * n:(r + 1) * n], None
