"""The 95th percentile of the four-card cell's request latencies in the
window, submit to answer, as ``harness.end_to_end`` takes it."""


def read(ctx):
    return ctx["window"].get("search_p95_ms")
