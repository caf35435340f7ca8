"""host_syncs_per_query: blocking device-to-host reads a query, from the
program's own spans: the traced window's ``rj.sync.*`` events (one
around each read, ``repro_torch.obs``) over the queries it answered.
Nothing to read where the program records no ``rj.query`` span."""

from perfbench import program_spans as ps


def read(ctx):
    done = sum(r.ok for r in ctx.records)
    if ctx.tracer is None or not done or not ps.count(ctx.tracer, ps.QUERY):
        return None
    return ps.count(ctx.tracer, ps.SYNC) / done
