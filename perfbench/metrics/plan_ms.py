"""plan_ms: mean host milliseconds of a query's submission (parse and
bind with ``repro_torch.sql.binder.parse_sql``, then
``QueryService.submit``: optimize or plan-cache fetch, admission quote),
timed by the harness around each."""


def read(ctx):
    done = [r.plan_s for r in ctx.records if r.ok]
    return 1e3 * sum(done) / len(done) if done else None
