"""Named device meshes, partition specs and explicit collectives on
``torch.distributed``: the port's counterpart of ``jax.sharding`` for the
LM's sharded paths.

* ``P`` is a ``PartitionSpec``: one entry per tensor dimension, each
  ``None``, a mesh axis name or a tuple of names (sharded over the product
  of those axes, the first one major), as in JAX.
* ``Mesh`` names the axes of the process group the caller started
  (``dist.init_process_group``; the mesh never starts one). Ranks are laid
  out row-major over the axes, as ``jax.make_mesh`` lays out devices. It
  holds one subgroup per axis and per tuple of axes, the rank's
  coordinates, and ``stats``: the calls and bytes of every collective this
  rank ran, by kind.
* ``shard`` cuts the rank's block of a whole tensor (``NamedSharding`` +
  ``device_put``); ``unshard`` all-gathers the blocks back into the whole.
* GSPMD's sharding constraints become explicit collectives, each an
  ``autograd.Function`` with its conjugate backward: ``gather`` (all-gather;
  its backward reduce-scatters, or keeps the rank's slice where the
  consumers over that axis were replicated), ``split`` (keep the rank's
  slice; backward all-gathers), Megatron's ``reduce_bwd`` (f: identity,
  backward all-reduce) and ``reduce_fwd`` (g: all-reduce, backward
  identity), ``mean_fwd`` (all-reduce mean, backward / n) and ``all_to_all``
  (backward all-to-all). Nothing is redistributed implicitly: what moves
  is what these functions move, and ``stats`` counts it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: Collective kinds, as ``CollectiveStats`` names them.
KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``. As
    in JAX, a tuple of one axis is that axis: ``P(("data",)) == P("data")``.
    """

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass
class CollectiveStats:
    """Calls and bytes of this rank's collectives since the last ``reset``.
    Bytes are what the rank hands to other ranks: an all-gather sends its
    block to each of the n - 1 others, a reduce-scatter and an all-to-all
    send (n - 1) / n of their input, a ring all-reduce twice that."""

    calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    sent_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] += 1
        self.sent_bytes[kind] += int(nbytes)

    def reset(self) -> None:
        for k in KINDS:
            self.calls[k] = 0
            self.sent_bytes[k] = 0


class AbstractMesh:
    """Named axes and their sizes, with no process group: what specs are
    computed from (``jax.sharding.AbstractMesh``)."""

    def __init__(self, axes: Sequence[Tuple[str, int]]):
        self.axis_names = tuple(n for n, _ in axes)
        self.shape = {n: int(s) for n, s in axes}
        self.size = math.prod(self.shape.values())

    def n(self, axes) -> int:
        """Ranks along ``axes`` (a name, a tuple of names or None)."""
        return math.prod(self.shape[a] for a in spec_axes(axes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class Mesh(AbstractMesh):
    """Named axes over the default process group.

    ``axes``: ((name, size), ...) in mesh order, their product the world
    size. ``device``: where this rank's tensors live.
    """

    def __init__(self, axes: Sequence[Tuple[str, int]], device=None):
        super().__init__(axes)
        names = self.axis_names
        sizes = tuple(self.shape[n] for n in names)
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {dict(axes)} needs {self.size} "
                             f"ranks, the world has {world}")
        self.rank = dist.get_rank()
        self.device = torch.device(device) if device is not None else None
        self.stats = CollectiveStats()
        self.coords = dict(zip(names, _unravel(self.rank, sizes)))
        # one group per (tuple of axes, coordinates of the other axes);
        # every rank creates every group, in the same order.
        self._groups: Dict[Tuple[str, ...], object] = {}
        for r in range(1, len(names) + 1):
            for sub in itertools.combinations(names, r):
                mine = None
                others = [n for n in names if n not in sub]
                for fixed in itertools.product(
                        *(range(self.shape[n]) for n in others)):
                    ranks = [self._rank_of({**dict(zip(others, fixed)),
                                            **dict(zip(sub, c))})
                             for c in itertools.product(
                                 *(range(self.shape[n]) for n in sub))]
                    if len(ranks) == world:
                        g = dist.group.WORLD
                    elif len(ranks) == 1:
                        g = None
                    else:
                        g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
                self._groups[sub] = mine

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for n in self.axis_names:
            r = r * self.shape[n] + coords[n]
        return r

    # -- axes ---------------------------------------------------------------

    def axes_of(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names or None) in mesh order, with
        size-1 axes kept: a spec entry's axes as ``group`` takes them."""
        return tuple(a for a in self.axis_names if a in spec_axes(axes))

    def index(self, axes) -> int:
        """This rank's block index along ``axes``, the first axis major."""
        i = 0
        for a in spec_axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The subgroup of the ranks that differ only along ``axes``."""
        key = self.axes_of(axes)
        if key != tuple(spec_axes(axes)):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _unravel(i: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Mesh
    spec: P


# ---------------------------------------------------------------------------
# raw collectives (no autograd), counted
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_gather_raw(mesh: Mesh, t: torch.Tensor, axes, dim: int
                   ) -> torch.Tensor:
    """Blocks of ``t`` from every rank along ``axes``, concatenated on
    ``dim`` in block order."""
    n = mesh.n(axes)
    if n == 1:
        return t
    mesh.stats.add("all_gather", t.numel() * t.element_size() * (n - 1))
    src = _wire(t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_reduce_raw(mesh: Mesh, t: torch.Tensor, axes,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``axes`` (a new tensor)."""
    n = mesh.n(axes)
    if n == 1:
        return t.clone()
    mesh.stats.add("all_reduce",
                   2 * t.numel() * t.element_size() * (n - 1) // n)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=mesh.group(axes))
    return out


def reduce_scatter_raw(mesh: Mesh, t: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, this rank's block of it on ``dim``."""
    n = mesh.n(axes)
    if n == 1:
        return t
    mesh.stats.add("reduce_scatter",
                   t.numel() * t.element_size() * (n - 1) // n)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    return out.movedim(0, dim).contiguous()


def all_to_all_raw(mesh: Mesh, t: torch.Tensor, axes) -> torch.Tensor:
    """``t``'s dim 0 (of the group's size) scattered: block j goes to the
    j-th rank along ``axes``; the received blocks stack in source order."""
    n = mesh.n(axes)
    if n == 1:
        return t
    mesh.stats.add("all_to_all", t.numel() * t.element_size() * (n - 1) // n)
    src = _wire(t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, reduce_grad):
        ctx.args = (mesh, axes, dim, reduce_grad)
        return all_gather_raw(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, reduce_grad = ctx.args
        if reduce_grad:
            return reduce_scatter_raw(mesh, g, axes, dim), None, None, None, \
                None
        return _block(g, dim, mesh.n(axes), mesh.index(axes)), None, None, \
            None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _block(x, dim, mesh.n(axes), mesh.index(axes)).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return all_gather_raw(mesh, g.contiguous(), axes, dim), None, None, \
            None


class _ReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_raw(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce_raw(mesh, g, axes), None, None


class _MeanFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.n(axes)
        return all_reduce_raw(mesh, x, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_to_all_raw(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_to_all_raw(mesh, g.contiguous(), axes), None, None


def _trivial(mesh: Mesh, axes) -> bool:
    return mesh is None or not spec_axes(axes) or mesh.n(axes) == 1


def gather(x, mesh: Mesh, axes, dim: int, reduce_grad: bool = True):
    """All-gather ``x``'s blocks along ``axes`` on ``dim``. The backward
    reduce-scatters (``reduce_grad``: the consumers differ over ``axes``,
    as different batch rows do) or keeps this rank's slice (they computed
    the same thing on every rank)."""
    if _trivial(mesh, axes):
        return x
    return _Gather.apply(x, mesh, axes, dim, reduce_grad)


def split(x, mesh: Mesh, axes, dim: int):
    """This rank's block of a tensor replicated over ``axes``; the backward
    all-gathers the blocks' gradients."""
    if _trivial(mesh, axes):
        return x
    return _Split.apply(x, mesh, axes, dim)


def reduce_fwd(x, mesh: Mesh, axes):
    """Megatron's g: the sum over ``axes``; the backward is the identity."""
    if _trivial(mesh, axes):
        return x
    return _ReduceFwd.apply(x, mesh, axes)


def reduce_bwd(x, mesh: Mesh, axes):
    """Megatron's f: the identity; the backward sums over ``axes``."""
    if _trivial(mesh, axes):
        return x
    return _ReduceBwd.apply(x, mesh, axes)


def mean_fwd(x, mesh: Mesh, axes):
    """The mean over ``axes``; the backward divides by their size."""
    if _trivial(mesh, axes):
        return x
    return _MeanFwd.apply(x, mesh, axes)


def all_to_all(x, mesh: Mesh, axes):
    """``all_to_all_raw`` with the all-to-all as its backward."""
    if _trivial(mesh, axes):
        return x
    return _AllToAll.apply(x, mesh, axes)


def all_reduce_max(x, mesh: Mesh, axes):
    """The elementwise max over ``axes``, carrying no gradient."""
    if _trivial(mesh, axes):
        return x.detach()
    return all_reduce_raw(mesh, x.detach(), axes, op=dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _check(spec: P, ndim: int) -> P:
    spec = P(*spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    return P(*spec, *(None,) * (ndim - len(spec)))


def shard(full: torch.Tensor, spec: P, mesh: Optional[Mesh]
          ) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``, a contiguous copy that
    shares no memory with ``full``."""
    if mesh is None:
        return full
    out = full
    for dim, entry in enumerate(_check(spec, full.dim())):
        n = mesh.n(entry)
        if n > 1:
            if out.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(full.shape)} "
                                 f"does not divide over {entry} ({n})")
            out = _block(out, dim, n, mesh.index(entry))
    # a copy: a block of dim 0 is a contiguous view of ``full``
    return out.clone(memory_format=torch.contiguous_format)


def unshard(block: torch.Tensor, spec: P, mesh: Optional[Mesh]
            ) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``."""
    if mesh is None:
        return block
    out = block
    for dim, entry in enumerate(_check(spec, block.dim())):
        if mesh.n(entry) > 1:
            out = all_gather_raw(mesh, out, entry, dim)
    return out


def global_shape(block_shape, spec: P, mesh: Optional[Mesh]):
    if mesh is None:
        return tuple(block_shape)
    return tuple(s * mesh.n(e) for s, e in
                 zip(block_shape, _check(spec, len(block_shape))))


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a dict tree and its congruent spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    return map_specs(lambda t, s: shard(t, s, mesh), tree, specs)


def unshard_tree(tree, specs, mesh):
    return map_specs(lambda t, s: unshard(t, s, mesh), tree, specs)


# ---------------------------------------------------------------------------
# what a sharded entry point knows about its rank's share of the work
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A sharded call's placement, passed down to the layers.

    ``batch``: the mesh axes this rank's batch rows are split over (the
    plan's batch axes when the global batch divides over them, else ()).
    ``model``: the model axis. ``fsdp``: the axis params are stored split
    over, or None. ``tp``: the blocks run Megatron tensor parallelism over
    ``model`` (the plan's ``tp`` is "tensor_parallel" and the model axis is
    not a batch axis). ``seq``: the axes a KV cache's sequence is split over
    (decode with a batch that does not divide), ``kv_model``: the cache's KV
    heads are split over ``model``."""

    mesh: Mesh
    batch: Tuple[str, ...]
    model: str
    fsdp: Optional[str]
    tp: bool
    seq: Tuple[str, ...] = ()
    kv_model: bool = False

    @property
    def m(self) -> int:
        return self.mesh.n(self.model)

    def vary(self, *extra: str) -> Tuple[str, ...]:
        """The axes over which this rank's consumers of a replicated weight
        differ from other ranks': the split batch axes (and ``extra``)."""
        return tuple(a for a in self.mesh.axis_names
                     if a in self.batch or a in extra)


def rows(x: torch.Tensor, ctx: Optional[ShardCtx], dim: int = 0
         ) -> torch.Tensor:
    """This rank's rows of a replicated input (no gradient to carry)."""
    if ctx is None or not ctx.batch:
        return x
    return _block(x, dim, ctx.mesh.n(ctx.batch),
                  ctx.mesh.index(ctx.batch)).contiguous()


def to_compute(w: torch.Tensor, stored: P, compute: P, ctx: ShardCtx,
               vary: Sequence[str], cast=None) -> torch.Tensor:
    """A weight block stored under ``stored`` as its compute-time block
    under ``compute`` (each dimension whole, or split as stored, or split
    where it was stored whole: ``split``'s backward then all-gathers):
    cast first (``cast``, the compute dtype, for floating weights), so the
    all-gather moves the narrow type and the backward reduces a gradient
    of it. Over each gathered axis in ``vary`` the backward reduce-scatters
    the gradient, over the others it keeps the rank's slice; over each axis
    in ``vary`` the weight is stored whole on, it all-reduces (data
    parallelism's gradient sum)."""
    mesh = ctx.mesh
    if cast is not None and w.is_floating_point():
        w = w.to(cast)
    stored, compute = _check(stored, w.dim()), _check(compute, w.dim())
    held = set()
    for dim, (es, ec) in enumerate(zip(stored, compute)):
        held.update(spec_axes(es))
        if es == ec:
            continue
        drop = tuple(a for a in spec_axes(es) if a not in spec_axes(ec))
        if len(drop) != len(spec_axes(es)) or (ec is not None and drop
                                                and drop != spec_axes(es)):
            raise ValueError(f"cannot re-place {es} as {ec} ({stored} -> "
                             f"{compute})")
        for a in reversed(drop):   # minor axis first: blocks concatenate
            w = gather(w, mesh, a, dim, reduce_grad=a in vary)
        if ec is not None:
            w = split(w, mesh, ec, dim)
    rest = tuple(a for a in mesh.axis_names if a in vary and a not in held)
    return reduce_bwd(w, mesh, rest) if rest else w
