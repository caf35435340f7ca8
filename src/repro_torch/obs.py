"""The program's spans, for ``torch.profiler``'s trace.

Spans mark the layer boundaries of the query path (service, executor,
run-time decisions, runtime filters, exchange, local joins and
aggregation) and every blocking device-to-host read on it. They are
emitted only while a ``torch.profiler`` is recording: otherwise ``span``
and ``sync`` return one shared no-op context manager, at the cost of one
call and one C check. Kineto keeps the recorded spans in memory and hands
them out when the profiler stops; on the card its CPU events share the
device activities' clock, so each idle gap on the device falls inside the
spans the host was in.

Every name starts with ``rj.``; the spans of one query nest inside its
``rj.query``. ``args`` is handed to ``record_function`` as given (an
exchange's kind, a local join's method); kineto's events and its chrome
export do not carry it on torch 2.11 and 2.13, so what a reader of the
trace needs lies in the names.
"""

from __future__ import annotations

import contextlib

import torch

# -- the table of names ------------------------------------------------------

# service (sql/service.py)
SUBMIT = "rj.submit"            # QueryService.submit: optimize, quote, enqueue
OPTIMIZE = "rj.optimize"        # QueryService._optimize
QUOTE = "rj.quote"              # modeled_plan_cost: the admission quote
BATCH = "rj.batch"              # QueryService._execute_batch
CSE = "rj.cse"                  # the batch's shared-subtree candidate loop
# executor (sql/executor.py)
QUERY = "rj.query"              # Executor.execute: _eval and its synchronize
OP_SCAN = "rj.op.scan"          # the branches of Executor._eval
OP_FILTER = "rj.op.filter"
OP_PROJECT = "rj.op.project"
OP_JOIN = "rj.op.join"          # a join outside a region of 3+ leaves
OP_AGGREGATE = "rj.op.aggregate"
OP_REGION = "rj.op.region"      # Executor._eval_region
# front end and planner: the decisions made at run time
SELECT = "rj.select"            # strategy.select + _engine_feasible
FILTERS_PLAN = "rj.filters.plan"  # sigmas + plan_runtime_filters; cache key
REPLAN = "rj.replan"            # a region's join order: DP, re-plan steps
VERIFY = "rj.verify"            # one plan-analysis gate
# runtime filters
FILTERS_BUILD = "rj.filters.build"  # build_filter_payload
FILTERS_PROBE = "rj.filters.probe"  # probe_filter_mask
# exchange (joins/exchange.py)
EXCHANGE = "rj.exchange"        # broadcast, _exchange_by_dest (args: kind)
MOVE = "rj.move"                # kernels.move_rows: the exchange's all-to-all,
                                # compaction and the joins' payload merge
# local joins and aggregation
LOCAL_JOIN = "rj.local_join"    # a method's local phase (args: method)
AGGREGATE = "rj.aggregate"      # group_aggregate
COMPACT = "rj.compact"          # compact_partitions

#: ``sync(site)``: exactly one blocking device-to-host read each.
SYNCS = {
    "count": "rj.sync.count",        # Table.count(), under every measure()
    "compact": "rj.sync.compact",    # compact_partitions: fullest partition
    "exchange": "rj.sync.exchange",  # moved, stayed, overflow, hottest load
    "tiles": "rj.sync.tiles",        # _probe_tiles: the number of probe tiles
    "tile_buckets": "rj.sync.tile_buckets",  # its repeat_interleave's size
    "skew": "rj.sync.skew",          # key_skew: total and hottest load
    "query": "rj.sync.query",        # Executor.execute's synchronize
    "batch": "rj.sync.batch",        # QueryService._execute_batch's
}

# ----------------------------------------------------------------------------

_OFF = contextlib.nullcontext()
recording = torch.autograd._profiler_enabled


def span(name: str, args: str | None = None):
    """``record_function(name, args)`` while a profiler records, else the
    shared no-op."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(name, args)


def sync(site: str):
    """The span ``rj.sync.<site>``, around one blocking read."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(SYNCS[site])


__all__ = ["SYNCS", "recording", "span", "sync"]
