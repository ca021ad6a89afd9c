"""Background consolidations finished in the window (the engine's
``consolidations`` counter, change over the window)."""


def read(ctx):
    a, b = ctx["before"], ctx["after"]
    if not a:
        return None
    return b["consolidations"] - a["consolidations"]
