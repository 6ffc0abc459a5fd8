"""The (data, model) mesh over the ranks of a ``torch.distributed`` world,
and the row sharding of the Gaussian state (port of
``touchgs_tpu/parallel/mesh.py``).

The JAX package names two mesh axes and lets XLA's partitioner place the
collectives.  What ``data`` splits depends on the step, in both packages:

- the single-scene sharded step (``parallel/sharded.py``): ``data`` takes
  pixel tiles and ``model`` Gaussians, and the port splits the Gaussian
  rows and the tile grid over all ``data·model`` ranks alike;
- the multi-scene step (``parallel/multiscene.py``): ``data`` takes
  scenes, and ``model`` each scene's Gaussian rows and its tiles.

PyTorch has no partitioner, so the port writes the collectives out.  In
the sharded step every leaf whose leading axis is the capacity is split by
rows over all ranks; rank r holds rows ``[r·c, (r + 1)·c)`` of the
capacity padded to a multiple of the world (``c`` the padded capacity over
the world).  The tile grid is split the same way, rank r compositing the
r-th contiguous slice.  Both use rank order, where the JAX package orders
the Gaussian axis model-major (``P(("model", "data"))``): the split is
the same, only which rank holds which slice differs.

Rank r sits at mesh coordinates ``(r // model, r % model)``.
``Mesh.axis("model")`` is the mesh of the ``model`` ranks that share this
rank's ``data`` coordinate, and ``Mesh.axis("data")`` that of the ``data``
ranks that share its ``model`` coordinate, each with a process group of
its own that ``make_mesh`` creates.

Two gathers carry a sharded render, each an autograd function behind a
method of ``Mesh`` (so the renderers need not import this package):

- ``Mesh.gather_rows``: all ranks' rows, in order.  Its backward is a
  reduce-scatter (sum over ranks): every rank's tiles contribute to every
  Gaussian's gradient, as ``psum_scatter``, the transpose of the JAX
  package's tiled ``all_gather``.  ``Mesh.gather_scene_rows`` gathers an
  (S, c, ...) block of S scenes' rows into scene-major order.
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

# (data, model) → (the world's group, its model groups, its data groups):
# make_mesh creates a shape's axis groups once per world
_AXIS_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` × ``model`` mesh over ``size`` ranks.  ``group`` is the
    process group its collectives run on; None means no process group, so
    a mesh of one rank gathers by copying and a larger one only describes
    a split.  ``model_group`` and ``data_group`` are the groups of this
    rank's two axes (``axis``)."""

    data: int
    model: int
    rank: int = 0
    group: Optional[object] = None
    model_group: Optional[object] = None
    data_group: Optional[object] = None

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

    def axis(self, name: str) -> "Mesh":
        """The mesh of the ranks along axis ``name`` through this rank:
        ``"model"`` gives a 1 × ``model`` mesh (this rank's position its
        ``model`` coordinate), ``"data"`` a ``data`` × 1 mesh, each on its
        axis's process group."""
        d, m = self.coords
        if name == "model":
            sub = Mesh(1, self.model, m, self.model_group)
        elif name == "data":
            sub = Mesh(self.data, 1, d, self.data_group)
        else:
            raise ValueError(f"mesh axis {name!r}: want 'data' or 'model'")
        if self.group is not None and sub.group is None:
            raise RuntimeError(f"this mesh has no {name} group: build it "
                               f"with make_mesh")
        return sub

    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the world."""
        return -(-n // self.size) * self.size

    def gather_rows(self, x: torch.Tensor, n: Optional[int] = None
                    ) -> torch.Tensor:
        """Every rank's rows of a row-sharded ``x``, in rank order, cut to
        the first ``n`` (the unpadded capacity).  Differentiable: the
        backward reduce-scatters the gradient, summed over ranks."""
        self.check_group()
        full = _GatherRows.apply(x, self)
        return full if n is None else full[:n]

    def gather_scene_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of each scene of an (S, c, ...) ``x``, as
        (S, size·c, ...) in scene-major order (scene s's rows of rank 0,
        then of rank 1, ...), from one ``gather_rows``."""
        S, c = x.shape[:2]
        tail = tuple(x.shape[2:])
        full = self.gather_rows(x.reshape((S * c,) + tail))
        return full.reshape((self.size, S, c) + tail).transpose(0, 1) \
            .reshape((S, self.size * c) + tail)

    def gather_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slice of a tile-sharded ``x``, in rank order.
        Differentiable: the backward keeps this rank's slice of the
        (replicated) cotangent."""
        self.check_group()
        return _GatherTiles.apply(x, self)

    def check_group(self) -> None:
        """Raise unless this mesh can gather: a process group, or one
        rank."""
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
    on ``data``, where the compositing work lives.

    Over an initialized world every rank must call this, in the same
    order: the first call for a (data, model) shape in a world is a
    collective over the world.  It creates one ``model`` group for each
    ``data`` coordinate, then one ``data`` group for each ``model``
    coordinate, each with ``dist.new_group`` (which every rank of the world
    calls for every group), and keeps the two that hold this rank; later
    calls for the shape reuse them."""
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
    if not (initialized and world == dist.get_world_size()):
        return Mesh(data, model)
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    world_group = dist.group.WORLD
    cached = _AXIS_GROUPS.get((data, model))
    if cached is None or cached[0] is not world_group:
        cached = _AXIS_GROUPS[(data, model)] = (
            world_group,
            [dist.new_group([i * model + j for j in range(model)])
             for i in range(data)],
            [dist.new_group([i * model + j for i in range(data)])
             for j in range(model)])
    _, model_groups, data_groups = cached
    return Mesh(data, model, rank, world_group, model_groups[d],
                data_groups[m])


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
        mesh.check_group()
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
