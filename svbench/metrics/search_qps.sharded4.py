"""The four-card cell's search throughput, as ``harness.end_to_end``
takes it: the queries of the requests submitted in the window over the
time from its start to the last answer."""


def read(ctx):
    return ctx["window"].get("search_qps")
