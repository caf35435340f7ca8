"""selection_idle_ms: device-idle milliseconds a query inside RelJoin's
run-time decisions: the union of the program's ``rj.select`` (method
selection), ``rj.filters.plan`` (runtime-filter planning and cache
lookup) and ``rj.replan`` (a region's join order) spans, less the
device-busy time inside it, over the queries answered. Nothing to read
where the program records no ``rj.query`` span."""

from perfbench import program_spans as ps


def read(ctx):
    done = sum(r.ok for r in ctx.records)
    if ctx.tracer is None or not done or not ps.count(ctx.tracer, ps.QUERY):
        return None
    spans = ps.union(ctx.tracer, ps.SELECTION)
    busy = ps.busy_inside_ns(ctx.tracer.busy_intervals(), spans)
    return (ps.length_ns(spans) - busy) / 1e6 / done
