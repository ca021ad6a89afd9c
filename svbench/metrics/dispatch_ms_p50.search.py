"""Median host time of one executor dispatch in the window: the entries
``SVFusionEngine._search_exec`` added to ``engine.latencies["search"]``
(one a dispatch, host clock)."""
import statistics


def read(ctx):
    lat = ctx["dispatch_s"]
    return statistics.median(lat) * 1e3 if lat else None
