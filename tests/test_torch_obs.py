"""The port's spans (``repro_torch.obs``) on the CPU.

One round of four of the service suite's queries (q19, q22 and the q33,
q34 that share their subtrees: a region, runtime filters, shared
subtrees, aggregates) on a small catalog, once with no
profiler and once under ``torch.profiler`` with a ``TorchFunctionMode``
that counts the host reads of tensors. With no profiler every span is one
shared no-op and the answers are the traced round's; under it every
``rj.*`` span is a name of the table, operators nest inside their query,
selections inside a join, and each blocking read sits in one
``rj.sync.*`` span.
"""

import time

import pytest
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.sql import QueryService, generate, service_queries

QUERIES = ("q19_filtered_customer", "q22_zone_map_window",
           "q33_shared_customer_join", "q34_shared_window_join")
#: Tensor methods that read a value back to the host.
READS = frozenset(("__int__", "__float__", "item", "tolist", "__bool__",
                   "cpu", "numpy"))


class _CountReads(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in READS:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def _names():
    return {v for k, v in vars(obs).items()
            if k.isupper() and isinstance(v, str)} | set(obs.SYNCS.values())


def _round(catalog):
    service = QueryService(catalog)
    plans = service_queries()
    for name in QUERIES:
        service.submit(plans[name], name=name)
    return service


def _answers(reports):
    return {q: {c: v.tolist() for c, v in r.table.to_numpy().items()}
            for rep in reports for q, r in rep.results.items()}


@pytest.fixture(scope="module")
def rounds():
    """(plain answers, traced answers, rj.* events, host reads, window)."""
    catalog = generate(0.02, 4, 3, device="cpu")
    plain = _answers(_round(catalog).run())
    service = _round(catalog)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _CountReads() as counter:
            reports = service.run()
    t1 = time.time_ns()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("rj.")]
    return plain, _answers(reports), events, counter.reads, (t0, t1)


def _inside(event, outers):
    _, s, e = event
    return any(os <= s and e <= oe for _, os, oe in outers)


def test_no_profiler_gives_the_shared_noop(rounds):
    assert not obs.recording()
    off = obs.span(obs.EXCHANGE, "shuffle")
    assert off is obs.span(obs.OP_JOIN) is obs.sync("count")
    with off:
        pass
    plain, traced, *_ = rounds
    assert plain == traced


def test_spans_are_named_in_the_table(rounds):
    _, _, events, _, _ = rounds
    seen = {n for n, _, _ in events}
    assert seen <= _names()
    for name in (obs.SUBMIT, obs.OPTIMIZE, obs.QUOTE):
        assert name not in seen  # submitted before the window
    for name in (obs.BATCH, obs.CSE, obs.QUERY, obs.OP_SCAN, obs.OP_REGION,
                 obs.OP_AGGREGATE, obs.SELECT, obs.FILTERS_PLAN,
                 obs.FILTERS_BUILD, obs.FILTERS_PROBE, obs.EXCHANGE,
                 obs.LOCAL_JOIN, obs.AGGREGATE, obs.COMPACT,
                 obs.SYNCS["count"], obs.SYNCS["exchange"]):
        assert name in seen, name


def test_operators_nest_in_their_query(rounds):
    _, _, events, _, (t0, t1) = rounds
    queries = [e for e in events if e[0] == obs.QUERY]
    joins = [e for e in events if e[0] in (obs.OP_JOIN, obs.OP_REGION)]
    assert len(queries) > len(QUERIES)  # the shared producers too
    for ev in events:
        assert t0 <= ev[1] <= t1, ev
        if ev[0].startswith("rj.op."):
            assert _inside(ev, queries), ev
        if ev[0] == obs.SELECT:
            assert _inside(ev, joins), ev


def test_each_host_read_is_one_sync_span(rounds):
    _, _, events, reads, _ = rounds
    syncs = sum(n.startswith("rj.sync.") for n, _, _ in events)
    assert reads > 0
    assert syncs == reads


def test_submit_spans():
    catalog = generate(0.02, 4, 3, device="cpu")
    service = QueryService(catalog)
    plan = service_queries()["q19_filtered_customer"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = service.submit(plan)
        second = service.submit(plan)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rj.")]
    assert names.count(obs.SUBMIT) == names.count(obs.OPTIMIZE) == 2
    assert names.count(obs.QUOTE) == 2
    assert not first.plan_cached and second.plan_cached
    assert service.stats()["plan_cache_hits"] == 1


def test_an_unknown_sync_site_fails_while_recording():
    assert obs.sync("nowhere") is obs.sync("count")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(KeyError):
            obs.sync("nowhere")
