"""filter_cache_hit_share: runtime-filter payloads served by the
service's ``FilterCache`` over all lookups in the window, in percent, from
``QueryService.stats()`` before and after it."""


def read(ctx):
    hits = ctx.stats_after["filter_cache_hits"] - \
        ctx.stats_before["filter_cache_hits"]
    misses = ctx.stats_after["filter_cache_misses"] - \
        ctx.stats_before["filter_cache_misses"]
    return 100.0 * hits / (hits + misses) if hits + misses else None
