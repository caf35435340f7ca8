"""row_move_idle_ms: device-idle milliseconds a query inside the program's
row mover: the union of its ``rj.move`` spans (``repro_torch.kernels.
move_rows``: the exchange's all-to-all, compaction and the joins' payload
merge), less the device-busy time inside it, over the queries answered.
Nothing to read where the program records no ``rj.move`` span."""

from perfbench import program_spans as ps

MOVE = "rj.move"


def read(ctx):
    done = sum(r.ok for r in ctx.records)
    if ctx.tracer is None or not done:
        return None
    spans = ps.union(ctx.tracer, (MOVE,))
    if not len(spans[0]):
        return None
    busy = ps.busy_inside_ns(ctx.tracer.busy_intervals(), spans)
    return (ps.length_ns(spans) - busy) / 1e6 / done
