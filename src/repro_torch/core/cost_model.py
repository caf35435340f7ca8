"""RelJoin cost model — faithful implementation of paper §3 (Eqs. 1-13, Table 2).

Cluster-workload costs of distributed join methods. Workload units are bytes of
data touched (sizes |A|, |B|); the single hyperparameter ``w`` weights the
network workload of the exchange phase against the local compute workload
(paper §3.2.4). All formulas are linear in |A|, |B| except the sort terms.

Notation (paper Table 1):
    size_a, size_b   : |A|, |B|  (bytes; |A| >= |B| by convention, A = probe side)
    card_a, card_b   : a, b      (row counts)
    p                : distributed join parallelism (number of shuffle partitions)
    w                : relative weight of network cost vs computing cost
    l_fan            : average matches in B per row of A (uniform default b/a)
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Iterator, Sequence, Tuple

#: The module's public surface. docs/cost_model.md documents every name
#: listed here (pinned by tests/test_docs.py — extend both together).
__all__ = [
    "JoinMethod", "RANK", "CostParams",
    # phase workloads (Eqs. 1-12)
    "broadcast_workload", "build_workload_broadcast", "probe_workload",
    "shuffle_workload", "sort_workload", "merge_workload",
    "build_workload_shuffle", "nl_workload_broadcast",
    "nl_workload_cartesian",
    # overall method costs (Eqs. 4, 8, 10, §3.5) + skew extension
    "broadcast_hash_cost", "shuffle_hash_cost", "shuffle_sort_cost",
    "default_salt_factor", "salted_shuffle_hash_cost", "broadcast_nl_cost",
    "cartesian_cost", "method_cost", "all_costs",
    # hypercube multi-way shuffle (cyclic join graphs)
    "cube_shares", "cube_replication", "hypercube_shuffle_cost",
    # runtime-filter costs (bloom / zone-map / semi-join / cache)
    "BLOOM_DEFAULT_BITS_PER_KEY", "BLOOM_MIN_BITS", "BLOOM_MAX_HASHES",
    "ZONE_MAP_BITS", "SEMI_JOIN_BITS_PER_KEY",
    "bloom_params", "bloom_fpr", "runtime_filter_cost",
    "filter_reduce_cost", "cached_filter_cost", "filtered_probe_fraction",
    "zone_map_cost", "semi_join_cost", "bloom_total_cost",
    # the relative-size criterion (Eq. 13)
    "k0_threshold", "relative_size", "broadcast_preferred",
    # checkpoint re-optimization trigger (PR 10, not in the paper)
    "DEFAULT_REOPT_QERROR",
]


class JoinMethod(enum.Enum):
    """Physical distributed join methods modeled by the paper, plus the
    skew-aware salted shuffle extension (not in the paper's Table 2)."""

    BROADCAST_HASH = "broadcast_hash"
    SHUFFLE_HASH = "shuffle_hash"
    SHUFFLE_SORT = "shuffle_sort"
    BROADCAST_NL = "broadcast_nl"
    CARTESIAN = "cartesian"
    SALTED_SHUFFLE_HASH = "salted_shuffle_hash"
    #: Multi-way extension (not in the paper's Table 2): partition the p
    #: tasks as a hypercube with one axis per join variable, hash every
    #: relation on the axes of the variables it contains and replicate it
    #: along the axes it does not, then run one local multi-way probe. Only
    #: quoted for cyclic join-graph cores, never by the binary Algorithm 1.
    HYPERCUBE_SHUFFLE = "hypercube_shuffle"


#: Paper Table 2 — higher-rank methods are preferred when feasible.
RANK: Dict[JoinMethod, int] = {
    JoinMethod.BROADCAST_HASH: 3,
    JoinMethod.SHUFFLE_HASH: 3,
    JoinMethod.SALTED_SHUFFLE_HASH: 3,
    JoinMethod.HYPERCUBE_SHUFFLE: 3,
    JoinMethod.SHUFFLE_SORT: 2,
    JoinMethod.BROADCAST_NL: 1,
    JoinMethod.CARTESIAN: 1,
}


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Environment parameters of the cost model.

    ``w`` is the paper's only hyperparameter (§1, §3.2.4); ``p`` is the join
    parallelism. The paper's testbed uses w=1, p=20 (=> k0=39).
    """

    p: int = 20
    w: float = 1.0

    def __post_init__(self) -> None:
        if self.p < 1:
            raise ValueError(f"parallelism p must be >= 1, got {self.p}")
        if self.w < 0:
            raise ValueError(f"network weight w must be >= 0, got {self.w}")


# ---------------------------------------------------------------------------
# Phase workloads (Eqs. 1-12). Each returns cluster workload in |.| units.
# ---------------------------------------------------------------------------

def broadcast_workload(size_b: float, params: CostParams) -> float:
    """Eq. 1: C_broadcast = (p-1)|B| — network workload of broadcasting B."""
    return (params.p - 1) * size_b


def build_workload_broadcast(size_b: float, params: CostParams) -> float:
    """Eq. 2: C_build = p|B| — every task builds a hash map of all of B."""
    return params.p * size_b


def probe_workload(size_a: float, size_b: float, card_a: float, card_b: float,
                   l_fan: float | None = None) -> float:
    """Eq. 3 (general form in §3.2.3): C_probe = |A| + (a*l_fan/b)|B|.

    With the paper's uniform-matching assumption l_fan = b/a this reduces to
    |A| + |B| (Eq. 3). Passing an explicit fanout reproduces the general form.
    """
    if l_fan is None:
        return size_a + size_b
    if card_b <= 0:
        return size_a
    return size_a + (card_a * l_fan / card_b) * size_b


def shuffle_workload(size_a: float, size_b: float, params: CostParams,
                     skew_a: float = 1.0, skew_b: float = 1.0) -> float:
    """Eq. 5: C_shuffle = ((p-1)/p)(|A| + |B|) — network workload of shuffle.

    The paper charges total exchanged bytes, implicitly assuming uniform key
    distributions. Under key skew the hottest partition — not the mean —
    bounds the stage, so each side is charged at its straggler load:
    ``skew = max_partition_load / mean_partition_load`` (1.0 reproduces the
    paper exactly).
    """
    p = params.p
    return (p - 1) / p * (skew_a * size_a + skew_b * size_b)


def sort_workload(size_a: float, size_b: float, card_a: float, card_b: float,
                  params: CostParams,
                  skew_a: float = 1.0, skew_b: float = 1.0) -> float:
    """Eq. 6: C_sort = |A| log2(a/p) + |B| log2(b/p).

    Skew-adjusted: the straggler partition holds ``skew * card / p`` rows, so
    both the touched bytes and the sort depth scale with the skew factor.
    """
    p = params.p
    wa = skew_a * size_a * math.log2(max(skew_a * card_a / p, 1.0))
    wb = skew_b * size_b * math.log2(max(skew_b * card_b / p, 1.0))
    return wa + wb


def merge_workload(size_a: float, size_b: float) -> float:
    """Eq. 7: C_merge = |A| + |B|."""
    return size_a + size_b


def build_workload_shuffle(size_b: float) -> float:
    """Eq. 9: C'_build = |B| — each task hashes only its partition of B."""
    return size_b


def nl_workload_broadcast(size_a: float, size_b: float, card_a: float) -> float:
    """Eq. 11: C_NL = |A| + a|B|."""
    return size_a + card_a * size_b


def nl_workload_cartesian(size_a: float, size_b: float, card_a: float,
                          params: CostParams) -> float:
    """Eq. 12: C'_NL = |A| + (a/p)|B|."""
    return size_a + card_a / params.p * size_b


# ---------------------------------------------------------------------------
# Overall method costs (Eqs. 4, 8, 10 and §3.5). w weights network terms.
# ---------------------------------------------------------------------------

def broadcast_hash_cost(size_a: float, size_b: float, params: CostParams) -> float:
    """Eq. 4: C_broadcastHash = |A| + (wp - w + p + 1)|B|."""
    p, w = params.p, params.w
    return size_a + (w * p - w + p + 1) * size_b


def shuffle_hash_cost(size_a: float, size_b: float, params: CostParams,
                      skew_a: float = 1.0, skew_b: float = 1.0,
                      pre_a: bool = False, pre_b: bool = False) -> float:
    """Eq. 10: C_shuffleHash = ((wp-w+p)/p)|A| + ((wp-w+2p)/p)|B|.

    Under key skew every shuffle-phase term (exchange, build, probe) is
    bounded by the straggler partition, so each side's coefficient scales
    with its skew factor: |A| -> skew_a|A|, |B| -> skew_b|B|. Defaults
    reproduce the paper's uniform-distribution formula.

    ``pre_a`` / ``pre_b`` mark a side as already hash-partitioned on the
    join key (e.g. the output of an upstream shuffle join or group-by on
    the same key). The engine elides that side's exchange (ships 0 bytes),
    so the quote drops the w(p-1)/p network term for the side — its
    coefficient (wp-w+p)/p collapses to the probe read 1 (A side) and
    (wp-w+2p)/p to build + probe 2 (B side). Paper §3.7's C_shuffle = 0
    case, which the selection would otherwise re-pay.
    """
    p, w = params.p, params.w
    coef_a = 1.0 if pre_a else (w * p - w + p) / p
    coef_b = 2.0 if pre_b else (w * p - w + 2 * p) / p
    return coef_a * skew_a * size_a + coef_b * skew_b * size_b


def shuffle_sort_cost(size_a: float, size_b: float, card_a: float, card_b: float,
                      params: CostParams,
                      skew_a: float = 1.0, skew_b: float = 1.0,
                      pre_a: bool = False, pre_b: bool = False) -> float:
    """Eq. 8: ((wp-w+p)/p + log2(a/p))|A| + ((wp-w+p)/p + log2(b/p))|B|.

    Skew-adjusted like :func:`shuffle_hash_cost`; the sort-depth log terms
    additionally grow with the straggler partition's cardinality.
    ``pre_a`` / ``pre_b`` drop the elided exchange's w(p-1)/p network term
    for a side already partitioned on the join key (see
    :func:`shuffle_hash_cost`); the sort + merge terms remain.
    """
    p, w = params.p, params.w
    base = (w * p - w + p) / p
    ta = (1.0 if pre_a else base) + math.log2(max(skew_a * card_a / p, 1.0))
    tb = (1.0 if pre_b else base) + math.log2(max(skew_b * card_b / p, 1.0))
    return ta * skew_a * size_a + tb * skew_b * size_b


def default_salt_factor(skew: float, params: CostParams) -> int:
    """Salt-bucket count r for the salted shuffle: enough buckets to flatten
    a straggler of factor ``skew`` (r ~ ceil(s)), at least 2 so the method is
    a real salting, at most p (more salts than partitions cannot spread
    further)."""
    return int(min(params.p, max(2, math.ceil(skew - 1e-9))))


def salted_shuffle_hash_cost(size_a: float, size_b: float, params: CostParams,
                             skew_a: float = 1.0,
                             r: int | None = None) -> float:
    """Skew-mitigated shuffle hash: salt hot probe keys across ``r`` salt
    buckets and replicate the matching build rows r-fold.

    Modeled as shuffle hash with two adjustments:

      * the probe side's straggler is flattened to the residual
        ``max(1, skew_a / r)`` — each hot key's rows now spread over r
        partitions;
      * the build side pays a replication surcharge ``1 + (r-1)/p``: only
        the hot-bucket slice of B (at most ~a partition's fair share, 1/p of
        |B|) is replicated r-fold, and the replicas ride the same shuffle +
        build + probe phases.

    At skew 1 this is strictly worse than plain shuffle hash (the surcharge
    buys nothing), so Algorithm 1 only deviates from the paper's five-method
    choice when measured skew makes plain shuffle lose.
    """
    r = r if r is not None else default_salt_factor(skew_a, params)
    residual = max(1.0, skew_a / max(r, 1))
    replication = 1.0 + (r - 1) / params.p
    return shuffle_hash_cost(size_a, size_b, params,
                             skew_a=residual, skew_b=replication)


def broadcast_nl_cost(size_a: float, size_b: float, card_a: float,
                      params: CostParams) -> float:
    """§3.5: C_broadcastNL = |A| + (wp - w + a)|B|."""
    p, w = params.p, params.w
    return size_a + (w * p - w + card_a) * size_b


def cartesian_cost(size_a: float, size_b: float, card_a: float,
                   params: CostParams) -> float:
    """§3.5: C_cartesian = ((wp-w+p)/p)|A| + ((wp-w+a)/p)|B|."""
    p, w = params.p, params.w
    return (w * p - w + p) / p * size_a + (w * p - w + card_a) / p * size_b


def method_cost(method: JoinMethod, size_a: float, size_b: float,
                card_a: float, card_b: float, params: CostParams,
                skew_a: float = 1.0, skew_b: float = 1.0,
                pre_a: bool = False, pre_b: bool = False) -> float:
    """Dispatch to the per-method overall cost. Broadcast-family methods are
    skew-invariant (B is fully replicated regardless of key distribution and
    A never moves); shuffle-family methods are charged at the straggler.
    ``pre_a``/``pre_b`` mark pre-partitioned sides whose shuffle is elided —
    they only discount the plain shuffle methods (salting re-keys the data,
    so a salted exchange can never be elided)."""
    if method is JoinMethod.BROADCAST_HASH:
        return broadcast_hash_cost(size_a, size_b, params)
    if method is JoinMethod.SHUFFLE_HASH:
        return shuffle_hash_cost(size_a, size_b, params, skew_a, skew_b,
                                 pre_a, pre_b)
    if method is JoinMethod.SALTED_SHUFFLE_HASH:
        return salted_shuffle_hash_cost(size_a, size_b, params, skew_a)
    if method is JoinMethod.SHUFFLE_SORT:
        return shuffle_sort_cost(size_a, size_b, card_a, card_b, params,
                                 skew_a, skew_b, pre_a, pre_b)
    if method is JoinMethod.BROADCAST_NL:
        return broadcast_nl_cost(size_a, size_b, card_a, params)
    if method is JoinMethod.CARTESIAN:
        # Round-robin co-shuffle: destinations are key-independent, so the
        # exchange is skew-free by construction.
        return cartesian_cost(size_a, size_b, card_a, params)
    if method is JoinMethod.HYPERCUBE_SHUFFLE:
        # A multi-way method cannot price a binary join: it needs every
        # relation of a cyclic core at once (hypercube_shuffle_cost). As a
        # binary alternative it is never applicable, so Algorithm 1's
        # two-sided comparisons can never pick it.
        return math.inf
    raise ValueError(f"unknown method {method}")


def all_costs(size_a: float, size_b: float, card_a: float, card_b: float,
              params: CostParams,
              skew_a: float = 1.0, skew_b: float = 1.0,
              pre_a: bool = False, pre_b: bool = False
              ) -> Dict[JoinMethod, float]:
    """Costs of every modeled method for one logical join."""
    return {m: method_cost(m, size_a, size_b, card_a, card_b, params,
                           skew_a, skew_b, pre_a, pre_b)
            for m in JoinMethod}


# ---------------------------------------------------------------------------
# Hypercube multi-way shuffle (cyclic join graphs; Shares/HyperCube scheme).
#
# The p tasks are arranged as a hypercube with one axis per join variable
# (equivalence class of join keys), of share d_v per axis with prod(d_v) = p.
# Relation R_i is hash-partitioned on the coordinates of the variables it
# contains (p_i = prod of its axes' shares) and replicated along the axes it
# does not own, a factor f_i = p / p_i. One local multi-way probe per task
# then evaluates the whole cyclic core without materializing any binary
# intermediate — the replication volume sum_i |R_i| * (p / p_i) replaces the
# binary plan's intermediate shuffles.
# ---------------------------------------------------------------------------

def cube_replication(dims: Sequence[int],
                     membership: Sequence[int]) -> int:
    """Replication factor f = p / p_i of a relation owning the axes in
    ``membership`` of a cube with per-axis shares ``dims``."""
    p = 1
    for d in dims:
        p *= d
    owned = 1
    for ax in membership:
        owned *= dims[ax]
    return p // owned


def hypercube_shuffle_cost(sizes: Sequence[float],
                           factors: Sequence[float],
                           params: CostParams) -> float:
    """Overall cost of the hypercube multi-way shuffle join.

    ``sizes[i]`` is |R_i| with R_0 the probe relation; ``factors[i]`` the
    replication factor f_i = p / p_i. Each relation ships f_i copies of
    itself through the exchange (w-weighted network workload
    f_i * ((p-1)/p) |R_i| — the replication volume sum_i |R_i| (p / p_i),
    with the same stays-local discount as Eq. 5), the probe copies are read
    once and every build copy is hashed and probed (the same 1 / 2 local
    coefficients as Eq. 10). At f = 1 for two relations this reproduces
    ``shuffle_hash_cost`` exactly.
    """
    p, w = params.p, params.w
    net = sum(w * (p - 1) / p * f * s for s, f in zip(sizes, factors))
    local = factors[0] * sizes[0]
    local += sum(2.0 * f * s for s, f in zip(sizes[1:], factors[1:]))
    return net + local


def _factorizations(p: int, k: int) -> Iterator[Tuple[int, ...]]:
    """All ordered factorizations of p into k positive factors."""
    if k == 1:
        yield (p,)
        return
    d = 1
    while d <= p:
        if p % d == 0:
            for rest in _factorizations(p // d, k - 1):
                yield (d,) + rest
        d += 1


def cube_shares(p: int, n_axes: int,
                memberships: Sequence[Sequence[int]],
                sizes: Sequence[float],
                params: CostParams) -> Tuple[int, ...]:
    """Optimal per-axis shares (d_0, ..., d_{n_axes-1}) with prod = p.

    Exhaustively enumerates the ordered factorizations of p (p and n_axes
    are tiny) and returns the one minimizing
    :func:`hypercube_shuffle_cost` over the relations' sizes, where
    ``memberships[i]`` lists the axes relation i owns. Ties break toward
    the first enumerated (most-balanced-first is not guaranteed; the cost
    is what matters)."""
    best: Tuple[int, ...] | None = None
    best_cost = math.inf
    for dims in _factorizations(p, n_axes):
        factors = [float(cube_replication(dims, m)) for m in memberships]
        cost = hypercube_shuffle_cost(sizes, factors, params)
        if cost < best_cost:
            best, best_cost = dims, cost
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# Runtime bloom-filter pushdown (sideways information passing).
#
# A bloom filter built over the build side's join keys and broadcast to the
# probe side's tasks shrinks the probe dataset *before* its exchange: the
# filtered exchange ships B'_probe = B_probe * keep bytes, where the kept
# fraction is max(sigma_est, fpr) — sigma_est the true key-match fraction
# (estimated from build-side distinct counts over the key domain) and fpr
# the filter's false-positive floor. The filter itself costs its broadcast,
# w * (p-1) * m/8 bytes of network workload (Eq. 1 applied to the m-bit
# array), so Algorithm 1 only plans a filter when the filtered join plus
# that surcharge is strictly cheaper than the unfiltered join.
# ---------------------------------------------------------------------------

#: Default filter budget: bits per distinct build-side key. 10 bits/key at
#: the optimal hash count k = ln2 * m/n gives ~0.8% false positives.
BLOOM_DEFAULT_BITS_PER_KEY = 10

BLOOM_MIN_BITS = 256
BLOOM_MAX_HASHES = 8


def bloom_params(n_keys: float,
                 bits_per_key: int = BLOOM_DEFAULT_BITS_PER_KEY
                 ) -> tuple[int, int]:
    """(m_bits, k) for an expected ``n_keys`` distinct build keys.

    ``m_bits`` is rounded up to a power of two (mask-reduction in the
    kernel, and pow2-quantized sizes reuse XLA compilations across build
    cardinalities, like ``compact_partitions``); ``k`` is the textbook
    optimum ln2 * m/n clamped to [1, BLOOM_MAX_HASHES].
    """
    n = max(int(n_keys), 1)
    m = max(BLOOM_MIN_BITS, 1 << (n * bits_per_key - 1).bit_length())
    k = int(round(math.log(2) * m / n))
    return m, max(1, min(BLOOM_MAX_HASHES, k))


def bloom_fpr(n_keys: float, m_bits: int, k: int) -> float:
    """Predicted false-positive rate (1 - e^{-kn/m})^k of a filter holding
    ``n_keys`` keys in ``m_bits`` bits with ``k`` hashes."""
    if n_keys <= 0:
        return 0.0
    return (1.0 - math.exp(-k * float(n_keys) / float(m_bits))) ** k


def runtime_filter_cost(m_bits: int, params: CostParams) -> float:
    """Workload of shipping the filter: broadcasting the m-bit array to the
    probe side's p tasks (Eq. 1 on m/8 bytes), network-weighted by w."""
    return params.w * (params.p - 1) * m_bits / 8.0


def filter_reduce_cost(m_bits: int, params: CostParams,
                       kind: str = "bloom") -> float:
    """Workload of the distributed filter *build*: the build side's p
    partitions hold disjoint key subsets, so each builds a partial filter
    and the partials are merged across the mesh. The merge's wire shape —
    and therefore its charge — depends on the kind:

      * ``"bloom"`` / ``"zone_map"``: the partial payload has the *same*
        serialized size as the merged one (an m-bit array under OR, a
        64-bit interval under min/max), so the merge is a binary reduce
        tree — ceil(log2 p) rounds of m/8 bytes.
      * ``"semi_join"``: the partial key lists are disjoint subsets whose
        union *is* the payload, so no mid-tree merge can compress them;
        the distributed build is an all_gather whose volume is (p-1)·m/8
        bytes (Eq. 1's convention applied to the gathered list), the same
        shape ``dist_key_set_build`` executes.

    Network-weighted by w; zero at p = 1 (a global build needs no merge).
    """
    if params.p <= 1:
        return 0.0
    if kind == "semi_join":
        return params.w * (params.p - 1) * m_bits / 8.0
    return params.w * math.ceil(math.log2(params.p)) * m_bits / 8.0


def cached_filter_cost(m_bits: int, params: CostParams) -> float:
    """Quote for a cross-query cache *hit*: the payload already exists
    (built and merged by an earlier query), so the build + reduce terms
    drop and only the per-query broadcast to the probe side's tasks
    remains. This is what makes the planner select cached filters more
    aggressively than cold ones — a borderline edge whose reduce tree
    priced it out on a cold cache clears the strictly-cheaper gate once
    the filter is free to re-ship."""
    return runtime_filter_cost(m_bits, params)


def filtered_probe_fraction(sigma_est: float, fpr: float) -> float:
    """Kept fraction of the probe side after a bloom filter: the match
    fraction floored by the filter's false-positive rate."""
    return min(max(max(sigma_est, fpr), 0.0), 1.0)


# ---------------------------------------------------------------------------
# Non-bloom runtime-filter kinds: the same plan-vs-price framing (ship the
# filter iff the filtered join plus the filter's wire cost is strictly
# cheaper) applied to a min/max zone map and an exact semi-join reducer.
# ---------------------------------------------------------------------------

#: Wire size of a zone map: one (min, max) int32 pair.
ZONE_MAP_BITS = 64

#: Wire size per distinct key of the exact semi-join reducer (int32 keys).
SEMI_JOIN_BITS_PER_KEY = 32


def zone_map_cost(params: CostParams) -> float:
    """Total workload of a zone-map filter: reduce the per-partition
    (min, max) pairs up the tree, then broadcast the 8-byte interval
    (Eq. 1). The cheapest reducer the model knows — but only *applicable*
    when the build side's surviving keys are band-shaped, else its keep
    fraction degenerates toward 1."""
    return (runtime_filter_cost(ZONE_MAP_BITS, params)
            + filter_reduce_cost(ZONE_MAP_BITS, params, kind="zone_map"))


def semi_join_cost(n_keys: float, params: CostParams) -> float:
    """Total workload of an exact semi-join reducer over ``n_keys``
    distinct build keys: all_gather the disjoint per-partition key lists
    ((p-1)·n·32/8 bytes — see :func:`filter_reduce_cost`), then broadcast
    the merged n*32-bit list. No false-positive floor — the kept fraction
    is exactly sigma — so it beats bloom when the key list is small
    enough that exactness outprices the denser encoding."""
    bits = max(n_keys, 0.0) * SEMI_JOIN_BITS_PER_KEY
    return (runtime_filter_cost(bits, params)
            + filter_reduce_cost(bits, params, kind="semi_join"))


def bloom_total_cost(m_bits: int, params: CostParams) -> float:
    """Total workload of a bloom filter: OR-reduce the per-partition
    partial bit arrays up the tree, then broadcast the merged m bits."""
    return (runtime_filter_cost(m_bits, params)
            + filter_reduce_cost(m_bits, params, kind="bloom"))


# ---------------------------------------------------------------------------
# The relative-size criterion (Eq. 13).
# ---------------------------------------------------------------------------

def k0_threshold(params: CostParams, skew: float = 1.0) -> float:
    """Eq. 13: k0 = (pw + p - w)/w — broadcast wins iff |A| > k0 |B|.

    For w -> 0 the threshold diverges (broadcast's extra build work p|B| can
    never be amortized by saving network), matching §5.5's observation that
    small w makes RelJoin behave like the forced-shuffle strategies.

    With probe-side key skew ``s`` (both sides charged at the straggler) the
    shuffle side of Eq. 13's comparison inflates and the threshold drops:

        k0(s) = (g*p + 1 - s*(g+1)) / (s*g - 1),   g = (wp - w + p)/p,

    which reduces to the paper's k0 at s=1 and can reach 0 for extreme skew
    (broadcast always wins — it is skew-invariant).
    """
    p, w = params.p, params.w
    if skew <= 1.0:
        if w == 0:
            return math.inf
        return (p * w + p - w) / w
    # g = 1 + w(p-1)/p >= 1, so skew*g > 1 on this (skew > 1) path and the
    # denominator is always positive.
    g = (w * p - w + p) / p
    return max((g * p + 1 - skew * (g + 1)) / (skew * g - 1), 0.0)


def relative_size(size_a: float, size_b: float) -> float:
    """k such that |A| = k|B| (inf when B is empty)."""
    if size_b <= 0:
        return math.inf
    return size_a / size_b


def broadcast_preferred(size_a: float, size_b: float, params: CostParams,
                        skew: float = 1.0) -> bool:
    """True iff C_broadcastHash < C_shuffleHash, i.e. k > k0 (paper §3.6.2).
    ``skew`` is the probe-side straggler factor (1.0 = paper's rule)."""
    return relative_size(size_a, size_b) > k0_threshold(params, skew)


#: Checkpoint re-optimization trigger: re-plan the remaining join order
#: when a measured intermediate's cardinality diverges from its estimate
#: by more than this q-error (max(est/meas, meas/est), one-row-floored).
#: 3x is loose enough that histogram-backed estimates on uniform data
#: never trip it and tight enough that compounding-predicate or skew
#: misestimates (the cases where re-planning flips a method) always do.
DEFAULT_REOPT_QERROR: float = 3.0
