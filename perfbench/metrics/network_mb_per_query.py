"""network_mb_per_query: mean ``ExecutionResult.network_bytes`` a query,
in MB (1e6 bytes): the paper's measured network workload, rows that
crossed partitions in exchanges plus runtime-filter traffic."""


def read(ctx):
    done = [r.network_bytes for r in ctx.records if r.ok]
    return sum(done) / len(done) / 1e6 if done else None
