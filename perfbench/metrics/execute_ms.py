"""execute_ms: mean ``ExecutionResult.wall_time_s`` a query, in
milliseconds: the executor's host clock around its evaluation, which ends
in a synchronize. A shared subtree's producer run counts toward no
query."""


def read(ctx):
    done = [r.wall_time_s for r in ctx.records if r.ok]
    return 1e3 * sum(done) / len(done) if done else None
