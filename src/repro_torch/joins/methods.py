"""The distributed equi-join methods (paper §2.1, §3) — global-view
executables on stacked tables.

Each method = exchange phase + local join phase, mirroring the cost model's
decomposition. All methods produce the same logical result for FK->PK
equi-joins: the probe table's rows (original partition layout) extended with
the matched build-side payload columns, and a per-method JoinReport with
*measured* phase workloads for cost-model validation.

Join types: inner, left_outer, left_semi, left_anti (probe side preserved;
the engine puts the larger table on the probe side as §3.1.4 prescribes).

The salted shuffle hash join spreads hot probe keys over several
partitions and replicates their build rows. The hypercube multi-way join
evaluates a cyclic join core in one replication exchange per relation and
one local probe chain per partition. The nested-loop and cartesian methods
evaluate the join as a row predicate against a broadcast replica.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import obs
from ..core.cost_model import JoinMethod
from ..kernels import ops as kops
from .exchange import (ExchangeReport, broadcast, hypercube_shuffle,
                       salted_shuffle, shuffle)
from .local_join import (A_SENTINEL, B_SENTINEL, LocalJoinResult, hash_join,
                         nested_loop_join, sort_join)
from .slots import gather_rows
from .table import Table


@dataclasses.dataclass
class JoinReport:
    method: JoinMethod
    exchanges: list          # ExchangeReport per exchanged input
    local_bytes: float       # measured local-join phase workload (bytes)
    output_rows: int


def _merge_payload(a: Table, b_cols: dict, idx: torch.Tensor,
                   found: torch.Tensor, join_type: str, b_key: str) -> Table:
    """Attach matched B payload to the probe table A, all partitions at
    once. ``b_cols`` are ``(P, nb)`` per partition or ``(nb,)`` replicas."""
    cols = dict(a.columns)
    if join_type == "left_semi":
        return Table(cols, a.valid & found)
    if join_type == "left_anti":
        return Table(cols, a.valid & ~found)
    gathered, _ = gather_rows(b_cols, idx)
    for name, col in gathered.items():
        out_name = name if name not in cols else f"{name}_r"
        if join_type == "left_outer":
            col = torch.where(found, col, torch.zeros_like(col))
        cols[out_name] = col
    if join_type == "inner":
        valid = a.valid & found
    elif join_type == "left_outer":
        valid = a.valid
        cols[f"{b_key}_matched"] = found
    else:
        raise ValueError(f"unsupported join type {join_type}")
    return Table(cols, valid)


def _finish(a: Table, b_cols: dict, res: LocalJoinResult, join_type: str,
            b_key: str) -> Table:
    return _merge_payload(a, b_cols, res.match_idx, res.found, join_type,
                          b_key)


def _local_bytes(a: Table, b_rows: int, b_row_bytes: int, p: int,
                 build_replicated: bool) -> float:
    """Measured compute workload: build (p|B| or |B|) + probe (|A| + |B|)."""
    a_bytes = a.count() * a.row_bytes
    b_bytes = b_rows * b_row_bytes
    build = (p if build_replicated else 1) * b_bytes
    return float(build + a_bytes + b_bytes)


# ---------------------------------------------------------------------------


def broadcast_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                        join_type: str = "inner",
                        use_kernel: bool = False) -> tuple[Table, JoinReport]:
    """Broadcast B to every partition; radix-hash probe A's partitions."""
    p = a.num_partitions
    b_full, ex = broadcast(b)
    with obs.span(obs.LOCAL_JOIN, "broadcast_hash"):
        res = hash_join(a.column(a_key), a.valid, b_full.column(b_key),
                        b_full.valid, use_kernel=use_kernel)
        out = _finish(a, b_full.columns, res, join_type, b_key)
        out.partitioned_by = a.partitioned_by
        rep = JoinReport(JoinMethod.BROADCAST_HASH, [ex],
                         _local_bytes(a, b_full.count(), b_full.row_bytes, p,
                                      build_replicated=True),
                         out.count())
    return out, rep


def shuffle_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                      join_type: str = "inner",
                      capacity_factor: float = 2.0,
                      use_kernel: bool = False) -> tuple[Table, JoinReport]:
    """Shuffle both sides by key; radix-hash join each co-partition."""
    p = a.num_partitions
    a_sh, ex_a = shuffle(a, a_key, capacity_factor)
    b_sh, ex_b = shuffle(b, b_key, capacity_factor)
    with obs.span(obs.LOCAL_JOIN, "shuffle_hash"):
        res = hash_join(a_sh.column(a_key), a_sh.valid, b_sh.column(b_key),
                        b_sh.valid, use_kernel=use_kernel)
        out = _finish(a_sh, b_sh.columns, res, join_type, b_key)
        out.partitioned_by = a_key
        rep = JoinReport(JoinMethod.SHUFFLE_HASH, [ex_a, ex_b],
                         _local_bytes(a_sh, b_sh.count(), b_sh.row_bytes, p,
                                      build_replicated=False),
                         out.count())
    return out, rep


def salted_shuffle_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                             join_type: str = "inner",
                             salt_r: int = 2,
                             capacity_factor: float = 2.0,
                             use_kernel: bool = False
                             ) -> tuple[Table, JoinReport]:
    """Skew-mitigating shuffle hash join: salt hot probe keys over ``salt_r``
    destinations and replicate the matching build rows once per salt, then
    radix-hash join each co-partition like the plain shuffle hash join.

    The output is NOT hash-partitioned by the join key (it is partitioned by
    (key, salt)), so downstream shuffles on the key are not elided — the
    price of flattening the straggler, and exactly what the salted cost
    model's replication surcharge pays for.
    """
    p = a.num_partitions
    a_sh, b_sh, ex_a, ex_b = salted_shuffle(a, a_key, b, b_key, salt_r,
                                            capacity_factor)
    with obs.span(obs.LOCAL_JOIN, "salted_shuffle_hash"):
        res = hash_join(a_sh.column(a_key), a_sh.valid, b_sh.column(b_key),
                        b_sh.valid, use_kernel=use_kernel)
        out = _finish(a_sh, b_sh.columns, res, join_type, b_key)
        out.partitioned_by = None
        rep = JoinReport(JoinMethod.SALTED_SHUFFLE_HASH, [ex_a, ex_b],
                         _local_bytes(a_sh, b_sh.count(), b_sh.row_bytes, p,
                                      build_replicated=False),
                         out.count())
    return out, rep


def shuffle_sort_join(a: Table, b: Table, a_key: str, b_key: str,
                      join_type: str = "inner",
                      capacity_factor: float = 2.0,
                      use_kernel: bool = False) -> tuple[Table, JoinReport]:
    """Shuffle both sides by key; sort-merge join each co-partition."""
    a_sh, ex_a = shuffle(a, a_key, capacity_factor)
    b_sh, ex_b = shuffle(b, b_key, capacity_factor)
    with obs.span(obs.LOCAL_JOIN, "shuffle_sort"):
        res = sort_join(a_sh.column(a_key), a_sh.valid, b_sh.column(b_key),
                        b_sh.valid, use_kernel_sort=use_kernel)
        out = _finish(a_sh, b_sh.columns, res, join_type, b_key)
        out.partitioned_by = a_key
        # Sort join's measured compute adds the n log n sort passes; we
        # report the touched bytes (sort reads+writes both sides ~log
        # passes).
        a_rows, b_rows = a_sh.count(), b_sh.count()
        pa = max(a_rows / a_sh.num_partitions, 1.0)
        pb = max(b_rows / b_sh.num_partitions, 1.0)
        sort_bytes = (a_rows * a_sh.row_bytes * math.log2(max(pa, 1.0) + 1)
                      + b_rows * b_sh.row_bytes * math.log2(max(pb, 1.0) + 1))
        merge_bytes = a_rows * a_sh.row_bytes + b_rows * b_sh.row_bytes
        rep = JoinReport(JoinMethod.SHUFFLE_SORT, [ex_a, ex_b],
                         float(sort_bytes + merge_bytes), out.count())
    return out, rep


def broadcast_nl_join(a: Table, b: Table,
                      predicate: Callable[[dict, dict], torch.Tensor],
                      join_type: str = "inner",
                      b_key: str = "") -> tuple[Table, JoinReport]:
    """Broadcast B; nested-loop each A partition against the replica."""
    b_full, ex = broadcast(b)
    with obs.span(obs.LOCAL_JOIN, "broadcast_nl"):
        res = nested_loop_join(a.columns, a.valid, b_full.columns,
                               b_full.valid, predicate)
        out = _finish(a, b_full.columns, res, join_type, b_key)
        nl_bytes = float(a.count() * a.row_bytes
                         + a.count() * b_full.count() * b_full.row_bytes
                         / 1.0)
        rep = JoinReport(JoinMethod.BROADCAST_NL, [ex], nl_bytes,
                         out.count())
    return out, rep


def cartesian_join(a: Table, b: Table,
                   predicate: Callable[[dict, dict], torch.Tensor],
                   join_type: str = "inner",
                   b_key: str = "") -> tuple[Table, JoinReport]:
    """Shuffle-NL: co-shuffle by a synthetic round-robin key so every
    (A-partition, B-partition) pair meets once; NL within pairs.

    Implementation mirrors Spark's CartesianProduct for *selective*
    predicates with first-match semantics (the engine's NL joins resolve at
    most one build match per probe row — sufficient for the non-equi
    predicates in the query suite). The rows are the broadcast NL join's;
    the report measures the exchange as a shuffle of both sides (Eq. 5).
    """
    p = a.num_partitions
    b_full, _ = broadcast(b)
    with obs.span(obs.LOCAL_JOIN, "cartesian"):
        res = nested_loop_join(a.columns, a.valid, b_full.columns,
                               b_full.valid, predicate)
        out = _finish(a, b_full.columns, res, join_type, b_key)
        rows_b = b_full.count()
        shuffle_like = ExchangeReport(
            "shuffle",
            network_bytes=(p - 1) / p * (a.count() * a.row_bytes
                                         + rows_b * b_full.row_bytes),
            local_bytes=(a.count() * a.row_bytes
                         + rows_b * b_full.row_bytes) / p)
        nl_bytes = float(a.count() * a.row_bytes
                         + a.count() / p * rows_b * b_full.row_bytes)
        rep = JoinReport(JoinMethod.CARTESIAN, [shuffle_like], nl_bytes,
                         out.count())
    return out, rep


# ---------------------------------------------------------------------------
# Hypercube multi-way shuffle join (cyclic join graphs).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HypercubeLink:
    """One equi-edge of the local multi-way probe: look up ``probe_col`` of
    the accumulated probe row (a relation-0 column, or a column gathered
    from an earlier link's build) in ``build_col`` of relation ``build``."""

    build: int       # index into the relation list (>= 1)
    probe_col: str   # key column available on the accumulated probe row
    build_col: str   # unique key column of the build relation


@dataclasses.dataclass(frozen=True)
class HypercubeSpec:
    """Physical plan of one hypercube multi-way join.

    ``dims`` is the cube shape (prod = p, one axis per join variable);
    ``axis_keys[i]`` lists relation i's owned (axis, key column) pairs —
    it is hash-partitioned on those and replicated along the rest.
    ``links`` are resolved in order; ``checks`` are the closing column
    equalities evaluated on the fully joined row (the cyclic edges the
    binary engine would have to re-shuffle for).
    """

    dims: tuple
    axis_keys: tuple
    links: tuple
    checks: tuple


def _sanitized(t: Table, col: str, sentinel: int) -> torch.Tensor:
    return torch.where(t.valid, t.column(col), sentinel).to(torch.int32)


def _add_columns(cols: dict, gathered: dict) -> None:
    for name, col in gathered.items():
        if name in cols:
            raise ValueError(f"duplicate column {name!r} in multi-way join")
        cols[name] = col


def hypercube_multiway_join(tables: list, spec: HypercubeSpec,
                            capacity_factor: float = 2.0,
                            use_kernel: bool = False
                            ) -> tuple[Table, JoinReport]:
    """Hypercube multi-way shuffle join: one replication exchange per
    relation, then a single local probe chain per partition — no binary
    intermediates ever cross the network.

    Every relation is cube-partitioned by ``hypercube_shuffle``; because
    each output tuple's variable assignment lands on exactly one cube cell
    and the build key columns are globally unique, a chain of first-match
    local probes plus the closing ``checks`` produces each result row
    exactly once (no cross-partition dedup needed). The probe relation is
    index 0; its rows (with gathered build payloads) form the output.

    With ``use_kernel``, two links and both probe columns on the probe
    shard, both links are resolved by one fused ``tiled_probe3`` call over
    every partition (a dense in-partition match); otherwise each link is a
    radix ``hash_join`` of every partition.
    """
    shards: list[Table] = []
    exs: list[ExchangeReport] = []
    for t, ak in zip(tables, spec.axis_keys):
        sh, ex = hypercube_shuffle(t, spec.dims, tuple(ak), capacity_factor)
        shards.append(sh)
        exs.append(ex)

    with obs.span(obs.LOCAL_JOIN, "hypercube_shuffle"):
        probe = shards[0]
        cols = dict(probe.columns)
        valid = probe.valid

        fused = (use_kernel and len(spec.links) == 2
                 and all(lk.probe_col in probe.columns for lk in spec.links))
        if fused:
            l1, l2 = spec.links
            b1, b2 = shards[l1.build], shards[l2.build]
            idx1, idx2 = kops.probe3(
                _sanitized(probe, l1.probe_col, A_SENTINEL),
                _sanitized(probe, l2.probe_col, A_SENTINEL),
                _sanitized(b1, l1.build_col, B_SENTINEL),
                _sanitized(b2, l2.build_col, B_SENTINEL))
            for b, idx in ((b1, idx1), (b2, idx2)):
                _add_columns(cols,
                             gather_rows(b.columns, idx.clamp(min=0))[0])
                valid = valid & (idx >= 0)
        else:
            for lk in spec.links:
                b = shards[lk.build]
                res = hash_join(cols[lk.probe_col], valid,
                                b.column(lk.build_col), b.valid,
                                use_kernel=use_kernel)
                _add_columns(cols, gather_rows(b.columns,
                                               res.match_idx.clamp(min=0))[0])
                valid = valid & res.found

        for c1, c2 in spec.checks:
            valid = valid & (cols[c1] == cols[c2])

        out = Table(cols, valid)
        # Measured local workload mirrors the binary methods' convention: one
        # probe pass over the (replicated) probe side, build + probe touch of
        # each (replicated) build side.
        local = float(probe.count() * probe.row_bytes
                      + sum(2.0 * s.count() * s.row_bytes for s in shards[1:]))
        rep = JoinReport(JoinMethod.HYPERCUBE_SHUFFLE, exs, local, out.count())
    return out, rep


# ---------------------------------------------------------------------------

EQUI_METHODS = {
    JoinMethod.BROADCAST_HASH: broadcast_hash_join,
    JoinMethod.SHUFFLE_HASH: shuffle_hash_join,
    JoinMethod.SALTED_SHUFFLE_HASH: salted_shuffle_hash_join,
    JoinMethod.SHUFFLE_SORT: shuffle_sort_join,
}


def run_equi_join(method: JoinMethod, a: Table, b: Table, a_key: str,
                  b_key: str, join_type: str = "inner",
                  use_kernel: bool = False,
                  capacity_factor: float = 2.0,
                  salt_r: int = 2) -> tuple[Table, JoinReport]:
    """Dispatch an equi-join to the selected physical method."""
    if method in (JoinMethod.BROADCAST_NL, JoinMethod.CARTESIAN):
        pred = lambda ac, bc: ac[a_key] == bc[b_key]  # noqa: E731
        fn = (broadcast_nl_join if method is JoinMethod.BROADCAST_NL
              else cartesian_join)
        return fn(a, b, pred, join_type, b_key)
    if method is JoinMethod.BROADCAST_HASH:
        return broadcast_hash_join(a, b, a_key, b_key, join_type, use_kernel)
    if method is JoinMethod.SHUFFLE_HASH:
        return shuffle_hash_join(a, b, a_key, b_key, join_type,
                                 capacity_factor, use_kernel)
    if method is JoinMethod.SALTED_SHUFFLE_HASH:
        # salt_r < 2 (e.g. a bare hint) is clamped inside salted_shuffle.
        return salted_shuffle_hash_join(a, b, a_key, b_key, join_type,
                                        salt_r, capacity_factor, use_kernel)
    if method is JoinMethod.SHUFFLE_SORT:
        return shuffle_sort_join(a, b, a_key, b_key, join_type,
                                 capacity_factor, use_kernel)
    raise ValueError(f"unknown method {method}")
