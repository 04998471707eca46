"""Device: share of the window in which no operation runs on the card, in
percent: one minus the device-busy seconds of a dashboard step, from the
profiler's trace of the traced calls, over the wall seconds of a dashboard step
in the untraced rest of the same window (host clock).  The traced calls'
own idle share (``busy_s`` / ``window_s``) is larger: the profiler's
record of every host operation slows the host that feeds the card."""


def read(ctx):
    calls = ctx.calls.get("add", 0)
    wall = ctx.host.get("call") or []
    if ctx.loop != "dashboard" or not ctx.busy_s or not calls or not wall:
        return None
    busy_per_call = ctx.busy_s / calls
    return 100.0 * (1.0 - busy_per_call / (sum(wall) / len(wall)))
