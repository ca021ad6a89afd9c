"""Queries per executor dispatch over the window: the coalescer's
``queries`` / ``dispatches`` counters (``core/engine.py``
``CoalescingScheduler``), change from the window's start to its end."""


def read(ctx):
    a, b = ctx["before"], ctx["after"]
    if not a or "coalesce_dispatches" not in a:
        return None
    d = b["coalesce_dispatches"] - a["coalesce_dispatches"]
    if d <= 0:
        return None
    return (b["coalesce_queries"] - a["coalesce_queries"]) / d
