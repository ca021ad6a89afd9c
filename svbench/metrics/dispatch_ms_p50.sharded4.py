"""Median host time of one fanned-out dispatch in the window: the
entries ``SVFusionEngine._search_exec`` added to
``engine.latencies["search"]``, one a dispatch over every card, merge
included (host clock)."""
import statistics


def read(ctx):
    lat = ctx["dispatch_s"]
    return statistics.median(lat) * 1e3 if lat else None
