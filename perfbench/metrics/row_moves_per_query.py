"""row_moves_per_query: calls of the program's row mover a query: the
traced window's ``rj.move`` events (one around each
``repro_torch.kernels.move_rows`` call: the exchange's all-to-all,
compaction and the joins' payload merge) over the queries it answered.
Nothing to read where the program records no ``rj.move`` span."""

from perfbench import program_spans as ps

MOVE = "rj.move"


def read(ctx):
    done = sum(r.ok for r in ctx.records)
    if ctx.tracer is None or not done:
        return None
    moves = ps.count(ctx.tracer, MOVE)
    return moves / done if moves else None
