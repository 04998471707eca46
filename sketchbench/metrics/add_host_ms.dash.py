"""Facade (``batched.py``): host milliseconds for a dashboard step's
``add`` to return, mean over the window's untraced steps (host clock)."""


def read(ctx):
    adds = ctx.host.get("add") or []
    if ctx.loop != "dashboard" or not adds:
        return None
    return sum(adds) / len(adds) * 1e3
