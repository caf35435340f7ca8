"""Distributed join method selection — paper Algorithm 1 (§4.3) plus the
validity fallback of §4.4.

Selection is per-logical-join and independent of other joins (paper §4.2), so
repeated calls over a plan's joins yield the model-globally-optimal physical
plan in O(l*h).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

from .cost_model import (CostParams, JoinMethod, broadcast_hash_cost,
                         broadcast_nl_cost, cartesian_cost, cube_replication,
                         cube_shares, default_salt_factor,
                         hypercube_shuffle_cost, salted_shuffle_hash_cost,
                         shuffle_hash_cost, shuffle_sort_cost)
from .stats import DEFAULT_WATERMARK_BYTES, TableStats


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    CROSS = "cross"


#: Join types for which the Cartesian product join is feasible ("inner-like").
INNER_LIKE = frozenset({JoinType.INNER, JoinType.CROSS, JoinType.LEFT_SEMI,
                        JoinType.LEFT_ANTI})


@dataclasses.dataclass(frozen=True)
class JoinProperties:
    """Feasibility flags of a logical join (Algorithm 1 inputs)."""

    join_type: JoinType = JoinType.INNER
    equi: bool = True                  # has equality predicates
    sortable_keys: bool = True         # sort join feasible
    hashable: bool = True              # memory allows building a hash map
    hint: Optional[JoinMethod] = None  # user-defined join hint (§4.3 line 1)
    #: Side already hash-partitioned on its join key (upstream shuffle join
    #: or group-by on the same key). The engine elides that side's exchange,
    #: so shuffle-family quotes drop its network term (paper §3.7).
    left_partitioned: bool = False
    right_partitioned: bool = False


@dataclasses.dataclass(frozen=True)
class Selection:
    """Outcome of one selection with audit info."""

    method: JoinMethod
    reason: str
    cost: float
    costs: dict
    used_fallback: bool = False
    swapped_sides: bool = False  # True when |B| > |A| and sides were flipped
    salt_r: int = 1              # salt buckets when SALTED_SHUFFLE_HASH


def _ordered(left: TableStats, right: TableStats,
             ) -> Tuple[TableStats, TableStats, bool]:
    """Paper §3.1.4: A is the larger side. Returns (A, B, swapped)."""
    if right.size_bytes > left.size_bytes:
        return right, left, True
    return left, right, False


def select_join_method(left: TableStats, right: TableStats,
                       props: JoinProperties, params: CostParams,
                       watermark_bytes: float = DEFAULT_WATERMARK_BYTES,
                       ) -> Selection:
    """Algorithm 1: cost-based distributed join method selection.

    ``left``/``right`` are the plan-order children; the model's A/B roles are
    assigned by size (A = larger). Returns the selected physical method.
    """
    a, b, swapped = _ordered(left, right)

    # Line 1-3: user hints short-circuit everything (but the audit record
    # must still report which side plays the A role).
    if props.hint is not None:
        return Selection(props.hint, "user hint", float("nan"), {},
                         swapped_sides=swapped)

    # §4.4: invalid statistics (e.g. huge lazy-init sizes) -> fall back to the
    # platform's original absolute-size strategy, handled by the caller.
    if not (a.is_valid(watermark_bytes) and b.is_valid(watermark_bytes)):
        sel = select_absolute_size(left, right, props)
        return dataclasses.replace(sel, used_fallback=True,
                                   reason="invalid stats: " + sel.reason)

    sa, sb = a.size_bytes, b.size_bytes
    ca, cb = max(a.cardinality, 1.0), max(b.cardinality, 1.0)
    # Straggler factors of the A (probe) and B (build) join keys. Statistics
    # without a measured skew carry the uniform default 1.0, reproducing the
    # paper's costs bit-for-bit.
    ka, kb = max(a.skew, 1.0), max(b.skew, 1.0)
    salt_r = default_salt_factor(ka, params)
    # Map the plan-order pre-partitioned flags onto the model's A/B roles.
    # Only the plain shuffle methods see them: a salted exchange re-keys the
    # data, so salting always re-pays the shuffle it would otherwise elide.
    pre_a = props.right_partitioned if swapped else props.left_partitioned
    pre_b = props.left_partitioned if swapped else props.right_partitioned

    costs = {
        JoinMethod.BROADCAST_HASH: broadcast_hash_cost(sa, sb, params),
        JoinMethod.SHUFFLE_HASH: shuffle_hash_cost(sa, sb, params, ka, kb,
                                                   pre_a, pre_b),
        JoinMethod.SALTED_SHUFFLE_HASH: salted_shuffle_hash_cost(
            sa, sb, params, ka, salt_r),
        JoinMethod.SHUFFLE_SORT: shuffle_sort_cost(sa, sb, ca, cb, params,
                                                   ka, kb, pre_a, pre_b),
        JoinMethod.BROADCAST_NL: broadcast_nl_cost(sa, sb, ca, params),
        JoinMethod.CARTESIAN: cartesian_cost(sa, sb, ca, params),
    }

    if props.equi:
        # Lines 4-9: hash joins when hashing is allowed.
        if props.hashable:
            if costs[JoinMethod.BROADCAST_HASH] < costs[JoinMethod.SHUFFLE_HASH]:
                m = JoinMethod.BROADCAST_HASH
                why = "equi, hashable, C_bh < C_sh (k > k0)"
            else:
                m = JoinMethod.SHUFFLE_HASH
                why = "equi, hashable, C_sh <= C_bh (k <= k0)"
            # Skew extension: the salted variant replaces the hash-family
            # pick only when *strictly* cheaper — at skew 1 its replication
            # surcharge makes that impossible, so uniform-key selections are
            # identical to the paper's Algorithm 1. It is also only eligible
            # when the A role sits on the plan's probe (left) side: the
            # engine salts the left side and replicates the right, so on
            # swapped sides the method the model priced is not executable
            # (the executor would have to degrade it anyway).
            if (not swapped
                    and costs[JoinMethod.SALTED_SHUFFLE_HASH] < costs[m]):
                m = JoinMethod.SALTED_SHUFFLE_HASH
                why = (f"equi, hashable, skewed (s={ka:.2f}): "
                       f"C_salted(r={salt_r}) beats plain hash joins")
                return Selection(m, why, costs[m], costs,
                                 swapped_sides=swapped, salt_r=salt_r)
            return Selection(m, why, costs[m], costs, swapped_sides=swapped)
        # Lines 10-11: sort join.
        if props.sortable_keys:
            m = JoinMethod.SHUFFLE_SORT
            return Selection(m, "equi, not hashable, sortable keys",
                             costs[m], costs, swapped_sides=swapped)

    # Lines 12-17: NL-family fallbacks (non-equi, unsortable, unhashable).
    if (costs[JoinMethod.CARTESIAN] <= costs[JoinMethod.BROADCAST_NL]
            and props.join_type in INNER_LIKE):
        m = JoinMethod.CARTESIAN
        why = "NL family, inner-like, C_cartesian <= C_broadcastNL"
    else:
        m = JoinMethod.BROADCAST_NL
        why = "NL family"
    return Selection(m, why, costs[m], costs, swapped_sides=swapped)


def select_hypercube(stats: Sequence[TableStats],
                     memberships: Sequence[Sequence[int]], n_axes: int,
                     binary_cost: float, params: CostParams,
                     watermark_bytes: float = DEFAULT_WATERMARK_BYTES,
                     ) -> Optional[Selection]:
    """Quote the hypercube multi-way shuffle for a cyclic join-graph core.

    ``stats[i]`` are the relations' statistics (index 0 = probe);
    ``memberships[i]`` the cube axes relation i owns (one axis per join
    variable, ``n_axes`` total); ``binary_cost`` the best binary plan's
    modeled cost for the same core (the DP's quote). In the spirit of
    Algorithm 1 the multi-way plan is selected *only when strictly
    cheaper* than the best binary tree — on anything else (including
    invalid statistics, where no trustworthy quote exists) the binary
    plan stands and ``None`` is returned.
    """
    if not all(s.is_valid(watermark_bytes) for s in stats):
        return None
    sizes = [s.size_bytes for s in stats]
    dims = cube_shares(params.p, n_axes, memberships, sizes, params)
    factors = [float(cube_replication(dims, m)) for m in memberships]
    cost = hypercube_shuffle_cost(sizes, factors, params)
    if not cost < binary_cost * (1 - 1e-9):
        return None
    why = (f"cyclic core of {len(stats)} relations: cube {dims} "
           f"replication volume {cost:.0f} < best binary plan "
           f"{binary_cost:.0f}")
    return Selection(JoinMethod.HYPERCUBE_SHUFFLE, why, cost,
                     {JoinMethod.HYPERCUBE_SHUFFLE: cost})


# ---------------------------------------------------------------------------
# Baseline strategies reproduced for evaluation (paper Table 3).
# ---------------------------------------------------------------------------

#: Spark AQE's default autoBroadcastJoinThreshold.
AQE_BROADCAST_THRESHOLD_BYTES: float = 10 * 1024 ** 2


def select_absolute_size(left: TableStats, right: TableStats,
                         props: JoinProperties,
                         threshold_bytes: float = AQE_BROADCAST_THRESHOLD_BYTES,
                         prefer_sort: bool = True) -> Selection:
    """The AQE strategy: broadcast iff min-side size <= absolute threshold;
    otherwise shuffle sort (Spark's default) or shuffle hash."""
    a, b, swapped = _ordered(left, right)
    if props.hint is not None:
        return Selection(props.hint, "user hint", float("nan"), {},
                         swapped_sides=swapped)
    if props.equi and props.hashable and b.size_bytes <= threshold_bytes:
        return Selection(JoinMethod.BROADCAST_HASH,
                         f"abs size {b.size_bytes:.0f} <= {threshold_bytes:.0f}",
                         float("nan"), {}, swapped_sides=swapped)
    if props.equi and props.sortable_keys and prefer_sort:
        return Selection(JoinMethod.SHUFFLE_SORT, "abs size: default sort",
                         float("nan"), {}, swapped_sides=swapped)
    if props.equi and props.hashable:
        return Selection(JoinMethod.SHUFFLE_HASH, "abs size: hash",
                         float("nan"), {}, swapped_sides=swapped)
    if props.join_type in INNER_LIKE:
        return Selection(JoinMethod.CARTESIAN, "abs size: NL family",
                         float("nan"), {}, swapped_sides=swapped)
    return Selection(JoinMethod.BROADCAST_NL, "abs size: NL family",
                     float("nan"), {}, swapped_sides=swapped)


def select_forced(method: JoinMethod, left: TableStats, right: TableStats,
                  props: JoinProperties) -> Selection:
    """ShuffleSort / ShuffleHash forced strategies (paper Table 3): hint the
    shuffle method when feasible, otherwise degrade like Algorithm 1 would."""
    a, b, swapped = _ordered(left, right)
    if method is JoinMethod.SHUFFLE_SORT and props.equi and props.sortable_keys:
        return Selection(method, "forced", float("nan"), {},
                         swapped_sides=swapped)
    if method is JoinMethod.SHUFFLE_HASH and props.equi and props.hashable:
        return Selection(method, "forced", float("nan"), {},
                         swapped_sides=swapped)
    if props.equi and props.sortable_keys:
        return Selection(JoinMethod.SHUFFLE_SORT, "forced-fallback",
                         float("nan"), {}, swapped_sides=swapped)
    if props.join_type in INNER_LIKE:
        return Selection(JoinMethod.CARTESIAN, "forced-fallback", float("nan"),
                         {}, swapped_sides=swapped)
    return Selection(JoinMethod.BROADCAST_NL, "forced-fallback", float("nan"),
                     {}, swapped_sides=swapped)
