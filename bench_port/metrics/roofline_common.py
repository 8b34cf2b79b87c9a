"""A step kind's share of its roofline: the frozen least time of every
step of that kind in the traced window (``yardstick/bounds.py``), over the
device's busy time in the window, in %."""


def roofline_pct(ctx, kind):
    bound = sum(c["bound_s"] for c in ctx["calls"]
                if c["kind"] == kind and not c["failed"])
    if bound <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * bound / ctx["busy_s"]
