"""``gather_l2``'s share of its roofline in the traced slice: the least
time of its calls (frozen arithmetic, ``svbench/bounds.py``) over the
device time of every kernel launched inside the ``svbench.l2_score``
ranges, in percent."""


def read(ctx):
    t = ctx["trace"]
    dev_s = (t or {}).get("range_device_s", {}).get("l2_score", 0.0)
    least = ctx["least_s"].get("l2_score", 0.0)
    if dev_s <= 0 or least <= 0:
        return None
    return 100.0 * least / dev_s
