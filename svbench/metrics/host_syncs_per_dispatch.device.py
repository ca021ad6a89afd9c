"""Device-to-host reads of the device-mode executor a dispatch: change
in ``engine.host_syncs`` over change in the coalescer's dispatches."""


def read(ctx):
    a, b = ctx["before"], ctx["after"]
    if not a or "coalesce_dispatches" not in a:
        return None
    d = b["coalesce_dispatches"] - a["coalesce_dispatches"]
    s = b["host_syncs"] - a["host_syncs"]
    return s / d if d > 0 and s > 0 else None
