"""Distributed execution of the join methods on ``torch.distributed``.

The global-view functions in ``methods.py`` are the semantic spec; here each
partition lives in its own rank process and the exchanges are actual
collectives:

    broadcast  ->  all_gather          (paper's broadcast, Eq. 1)
    shuffle    ->  all_to_all_single   (paper's shuffle,   Eq. 5)

The program is SPMD with one controller per rank: a rank holds only its own
partition, a ``Table`` of shape ``(1, cap)`` on its device (``place`` and
``place_cube`` cut it from a stacked table), and the ``dist_*`` functions
take and return such local tables. The per-partition compute is the same
code as the global view: slot packing (``slots.py``), the radix hash join
(``tiled_probe`` on the card), the sort join, ``bloom_build``,
``key_range`` and ``key_set``; only the exchange differs.

The caller initialises the process group, as is usual in PyTorch; the mesh
functions build on the default group and never start one. The collectives
are ``all_to_all_single`` and the list form of ``all_gather``, which NCCL
and gloo both run on CUDA tensors (gloo stages them through host memory).
Bool tensors travel as uint8. NCCL refuses two ranks on one card, so ranks
that share a card use gloo.

Launch counters (``kernels.ops.launch_counts``) and the per-stream
workspace of ``partition_hist``, ``bloom_build`` and ``key_range``
(``kernels.launch.workspace``) belong to a process: ranks that share a card
count their own launches and keep their own workspaces.

Every runtime-filter kind also gets its **distributed build** here, one
per reducer:

    dist_bloom_build      partial bloom arrays, OR-merged      (bloom)
    dist_zone_map_build   per-rank (min, max), min/max merge   (zone_map)
    dist_key_set_build    per-rank distinct keys, all_gather
                          + merge-dedupe                       (semi_join)

All three share one **distributed-equivalence contract**: the merged
payload is bit-/value-identical to the corresponding global-view build
(``kernels.bloom.bloom_build``, ``kernels.zone_map.key_range``,
``core.psts.key_set``) over the concatenated column, at any rank count,
because each merge (bitwise OR, elementwise min/max, sorted set-union) is
associative, commutative and neutral on empty partitions.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

from ..core.psts import key_set
from ..kernels.bloom import bloom_build
from ..kernels.zone_map import key_range, merge_ranges
from .local_join import hash_join, sort_join
from .methods import HypercubeSpec
from .slots import (SHUFFLE_SEED, gather_rows, hash32, pair_capacity,
                    slot_scatter)
from .table import Table, resolve_device

AXIS = "p"


#: The collectives the twins run, as ``WireStats.sent_bytes`` names them.
COLLECTIVES = ("all_to_all_single", "all_gather")


@dataclasses.dataclass
class WireStats:
    """What this rank's exchanges did since the last ``reset``: the bytes
    its collectives handed to other ranks, by collective (an all-to-all
    keeps its own slice, an all-gather sends its tensor to every other
    rank of the group), and the valid rows dropped because their (source,
    destination) slots were full, as a device tensor (no host sync). The
    twins drop such rows unchecked, as the reference's do; the global
    view reports them as ``ExchangeReport.overflow_rows``."""

    sent_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    dropped_rows: torch.Tensor | int = 0

    def reset(self) -> None:
        self.sent_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.dropped_rows = 0


@dataclasses.dataclass(frozen=True, eq=False)
class JoinMesh:
    """The ranks of the default process group as a cube of shape ``dims``
    (C-order: the flat rank is the cube cell), with one process group per
    axis: the ranks that share every other coordinate, ordered by their
    coordinate on the axis. A flat mesh has one axis, whose group is the
    default group."""

    axis_names: tuple
    dims: tuple
    device: torch.device
    groups: tuple
    stats: WireStats

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def all_to_all(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """``x`` (1, d, cap): slot row j goes to the rank at coordinate j
        on ``axis``; returns (1, d * cap), the slots from coordinate i at
        row i (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
        d = self.dims[axis]
        send = _to_wire(x).reshape(-1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.groups[axis])
        self.stats.sent_bytes["all_to_all_single"] += (
            send.numel() * send.element_size() * (d - 1) // d)
        return _from_wire(recv, x.dtype).reshape(1, -1)

    def all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, stacked in coordinate order:
        (d, *x.shape)."""
        d = self.dims[axis]
        send = _to_wire(x).contiguous()
        parts = [torch.empty_like(send) for _ in range(d)]
        dist.all_gather(parts, send, group=self.groups[axis])
        self.stats.sent_bytes["all_gather"] += (
            send.numel() * send.element_size() * (d - 1))
        return _from_wire(torch.stack(parts), x.dtype)


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


def _require_world(p: int) -> None:
    world = dist.get_world_size()  # raises if no process group is set up
    if world != p:
        raise ValueError(f"a mesh of {p} ranks needs a process group of "
                         f"{p} ranks, not {world}")


def make_join_mesh(p: int, device=None) -> JoinMesh:
    """1-D mesh over the join parallelism p: the default process group,
    which must hold p ranks. ``device`` is where this rank keeps its
    partition: the card unless the caller names another device; without a
    card and without a device this raises."""
    device = resolve_device(device)
    _require_world(p)
    return JoinMesh((AXIS,), (p,), device, (dist.group.WORLD,), WireStats())


def cube_axis_names(n_axes: int) -> tuple[str, ...]:
    """Axis names of the hypercube mesh (one axis per join variable)."""
    return tuple(f"hc{i}" for i in range(n_axes))


def make_cube_mesh(dims: tuple[int, ...], device=None) -> JoinMesh:
    """Multi-axis mesh for the hypercube multi-way shuffle: the ranks
    arranged as a cube of shape ``dims`` (C-order, matching the global-view
    ``hypercube_shuffle``'s flat cell index). Every rank creates every
    axis group, in one order, as ``dist.new_group`` requires; a flat cube
    ``(p, 1, ..., 1)`` has share-1 axes whose collectives are copies."""
    device = resolve_device(device)
    dims = tuple(int(d) for d in dims)
    _require_world(math.prod(dims))
    rank = dist.get_rank()
    cells = torch.arange(math.prod(dims)).reshape(dims)
    groups = []
    for ax, d in enumerate(dims):
        mine = None
        for line in cells.movedim(ax, -1).reshape(-1, d).tolist():
            group = dist.new_group(line)
            if rank in line:
                mine = group
        groups.append(mine)
    return JoinMesh(cube_axis_names(len(dims)), dims, device, tuple(groups),
                    WireStats())


def place(table: Table, mesh: JoinMesh) -> Table:
    """This rank's partition of a stacked table (partition i on rank i) as
    a ``(1, cap)`` table on the mesh's device."""
    if not table.stacked or table.num_partitions != mesh.size:
        raise ValueError(f"place expects a stacked table of {mesh.size} "
                         f"partitions, got shape {tuple(table.valid.shape)}")
    r = dist.get_rank()
    cols = {n: c[r:r + 1].to(mesh.device, copy=True)
            for n, c in table.columns.items()}
    return Table(cols, table.valid[r:r + 1].to(mesh.device, copy=True))


def place_cube(table: Table, mesh: JoinMesh) -> Table:
    """This rank's partition of a stacked table on a cube mesh: partition i
    on cube cell i in C-order, which is rank i."""
    return place(table, mesh)


# -- per-rank exchange primitives (local tables have a leading axis of 1) ----

def _exchange(cols: dict, valid: torch.Tensor, dest: torch.Tensor,
              mesh: JoinMesh, axis: int, pair_cap: int):
    """Pack rows into per-destination slots along ``axis`` and all-to-all
    them; rows past ``pair_cap`` are dropped (counted in ``mesh.stats``)."""
    scat = slot_scatter(dest, valid, mesh.dims[axis], pair_cap)
    mesh.stats.dropped_rows = mesh.stats.dropped_rows + scat.overflow.sum()
    send_cols, send_valid = gather_rows(cols, scat.idx)
    recv_cols = {n: mesh.all_to_all(c, axis) for n, c in send_cols.items()}
    return recv_cols, mesh.all_to_all(send_valid, axis)


def _dest(keys: torch.Tensor, d: int) -> torch.Tensor:
    return (hash32(keys, SHUFFLE_SEED) % d).to(torch.int32)


def _local_shuffle(cols: dict, valid: torch.Tensor, key: str, mesh: JoinMesh,
                   pair_cap: int):
    """Pack rows into per-destination slots and all_to_all them."""
    return _exchange(cols, valid, _dest(cols[key], mesh.shape[AXIS]), mesh, 0,
                     pair_cap)


def _local_broadcast(cols: dict, valid: torch.Tensor, mesh: JoinMesh):
    """all_gather a full replica of the table onto every rank."""
    full_cols = {n: mesh.all_gather(c, 0).reshape(1, -1)
                 for n, c in cols.items()}
    return full_cols, mesh.all_gather(valid, 0).reshape(1, -1)


def _use_kernel(use_kernel: bool | None, t: Table) -> bool:
    """The executor's rule: the kernel path on CUDA tensors."""
    return t.valid.device.type == "cuda" if use_kernel is None else use_kernel


# -- distributed join methods ------------------------------------------------

def _attach(a_cols, a_valid, b_cols, res):
    out = dict(a_cols)
    gathered, _ = gather_rows(b_cols, res.match_idx)
    for n, c in gathered.items():
        out[n if n not in out else f"{n}_r"] = c
    return out, a_valid & res.found


def _shuffle_both(a: Table, b: Table, a_key: str, b_key: str,
                  mesh: JoinMesh, capacity_factor: float):
    p = mesh.shape[AXIS]
    ra = _local_shuffle(a.columns, a.valid, a_key, mesh,
                        pair_capacity(a.capacity, p, capacity_factor))
    rb = _local_shuffle(b.columns, b.valid, b_key, mesh,
                        pair_capacity(b.capacity, p, capacity_factor))
    return ra, rb


def dist_shuffle_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                           mesh: JoinMesh, capacity_factor: float = 2.0,
                           use_kernel: bool | None = None) -> Table:
    (ra_cols, ra_valid), (rb_cols, rb_valid) = _shuffle_both(
        a, b, a_key, b_key, mesh, capacity_factor)
    res = hash_join(ra_cols[a_key], ra_valid, rb_cols[b_key], rb_valid,
                    use_kernel=_use_kernel(use_kernel, a))
    return Table(*_attach(ra_cols, ra_valid, rb_cols, res))


def dist_shuffle_sort_join(a: Table, b: Table, a_key: str, b_key: str,
                           mesh: JoinMesh, capacity_factor: float = 2.0,
                           use_kernel: bool | None = None) -> Table:
    (ra_cols, ra_valid), (rb_cols, rb_valid) = _shuffle_both(
        a, b, a_key, b_key, mesh, capacity_factor)
    res = sort_join(ra_cols[a_key], ra_valid, rb_cols[b_key], rb_valid,
                    use_kernel_sort=_use_kernel(use_kernel, a))
    return Table(*_attach(ra_cols, ra_valid, rb_cols, res))


def dist_hypercube_join(tables: tuple, spec: HypercubeSpec, mesh: JoinMesh,
                        capacity_factor: float = 2.0,
                        use_kernel: bool | None = None) -> Table:
    """Hypercube multi-way join over the multi-axis cube mesh — the
    distributed twin of ``methods.hypercube_multiway_join``.

    Per relation the cube exchange is compositional in the mesh axes: one
    all-to-all along each *owned* axis, in ``axis_keys`` order, routes rows
    to their hash coordinate (each sized by ``pair_capacity`` of the rows
    the rank holds by then), then one all-gather along each *free* axis
    replicates the shard across the slice the relation does not own. After
    the exchange every cube cell holds exactly the global view's cell
    content, so the reference's chain of binary probes (``hash_join`` per
    link) and the closing checks run unchanged. Tables must be placed with
    ``place_cube``.
    """
    uk = _use_kernel(use_kernel, tables[0])

    def cube_exchange(cols, valid, axis_keys):
        owned = {ax for ax, _ in axis_keys}
        for ax, col in axis_keys:
            d = mesh.dims[ax]
            cap = pair_capacity(valid.shape[-1], d, capacity_factor)
            cols, valid = _exchange(cols, valid, _dest(cols[col], d), mesh,
                                    ax, cap)
        for ax in range(len(mesh.dims)):
            if ax in owned:
                continue
            cols = {n: mesh.all_gather(c, ax).reshape(1, -1)
                    for n, c in cols.items()}
            valid = mesh.all_gather(valid, ax).reshape(1, -1)
        return cols, valid

    shards = [cube_exchange(t.columns, t.valid, tuple(ak))
              for t, ak in zip(tables, spec.axis_keys)]
    cols, valid = dict(shards[0][0]), shards[0][1]
    for lk in spec.links:
        b_cols, b_valid = shards[lk.build]
        res = hash_join(cols[lk.probe_col], valid, b_cols[lk.build_col],
                        b_valid, use_kernel=uk)
        gathered, _ = gather_rows(b_cols, res.match_idx)
        for n, c in gathered.items():
            if n in cols:
                raise ValueError(f"duplicate column {n!r} in multi-way join")
            cols[n] = c
        valid = valid & res.found
    for c1, c2 in spec.checks:
        valid = valid & (cols[c1] == cols[c2])
    return Table(cols, valid)


def dist_broadcast_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                             mesh: JoinMesh,
                             use_kernel: bool | None = None) -> Table:
    fb_cols, fb_valid = _local_broadcast(b.columns, b.valid, mesh)
    res = hash_join(a.column(a_key), a.valid, fb_cols[b_key], fb_valid,
                    use_kernel=_use_kernel(use_kernel, a))
    return Table(*_attach(a.columns, a.valid, fb_cols, res))


# -- distributed runtime-filter build ----------------------------------------

def _partial_bloom_words(keys: torch.Tensor, valid: torch.Tensor,
                         m_bits: int, k: int) -> torch.Tensor:
    """Partial bloom filter of one partition's live keys: ``bloom_build``
    (its kernel on the card), whose positions are the global build's, so
    the partials' OR is the global bit array."""
    return bloom_build(keys, valid, m_bits=m_bits, k=k)


def dist_bloom_build(table: Table, key: str, mesh: JoinMesh, *, m_bits: int,
                     k: int) -> torch.Tensor:
    """Distributed bloom build: per-rank partial filters OR-merged across
    the mesh; returns this rank's replica of the merged int32
    ``(m_bits/32,)`` words — bit-identical to the global-view
    ``bloom_build`` over the concatenated column. The words travel as
    int32 and are gathered, then ORed here: NCCL has no OR reduction, and
    the reference gathers too (its cost model prices the reduce tree a
    real all-reduce would run)."""
    part = _partial_bloom_words(table.column(key), table.valid, m_bits, k)
    parts = mesh.all_gather(part, 0)                  # (p, m_words)
    return functools.reduce(torch.bitwise_or, parts.unbind(0))


def dist_zone_map_build(table: Table, key: str, mesh: JoinMesh
                        ) -> torch.Tensor:
    """Distributed zone-map build: per-rank ``key_range`` partials merged
    with an elementwise min/max; returns this rank's replica of the merged
    int32 ``(2,)`` interval — value-identical to the global-view
    ``key_range``. An all-invalid partition contributes the empty-interval
    identity ``[INT32_MAX, INT32_MIN]``."""
    part = key_range(table.column(key), table.valid)
    return merge_ranges(mesh.all_gather(part, 0))     # (p, 2) -> (2,)


def dist_key_set_build(table: Table, key: str, mesh: JoinMesh
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed semi-join build: each rank folds its partition into a
    local ``key_set`` (local dedupe before the exchange), the padded lists
    and their counts are all-gathered, and a second ``key_set`` over the
    gathered lists, each masked to its live prefix, merge-dedupes them.

    Returns this rank's replica of ``(sorted_keys, n_distinct)``, of the
    same length as — and value-identical to — the global-view ``key_set``
    over the concatenated column."""
    local, n_local = key_set(table.column(key), table.valid)
    gathered = mesh.all_gather(local, 0)                  # (p, cap)
    counts = mesh.all_gather(n_local.reshape(1), 0)[:, 0]  # (p,)
    live = (torch.arange(gathered.shape[1], device=gathered.device)[None, :]
            < counts[:, None])
    return key_set(gathered.reshape(-1), live.reshape(-1))
