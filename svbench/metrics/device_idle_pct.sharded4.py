"""Share of the traced slice in which the cell's cards ran nothing, in
percent: 100 x (1 - the cards' mean busy time / the slice), from
``torch.profiler``'s device events of each card."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
