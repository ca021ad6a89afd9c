"""How evenly the fan-out keeps the cards busy in the traced slice, in
percent: 100 x the least busy card's device time over the busiest
card's (``busy_s_per_card``). A card left waiting on the others, or one
that does more of the work, pulls it down."""


def read(ctx):
    busy = (ctx["trace"] or {}).get("busy_s_per_card")
    if not busy or max(busy) <= 0:
        return None
    return 100.0 * min(busy) / max(busy)
