"""Median host time of one ``engine.insert`` call in the window (the
benchmark's own span around each call)."""
import statistics


def read(ctx):
    s = ctx["insert_s"]
    return statistics.median(s) * 1e3 if s else None
