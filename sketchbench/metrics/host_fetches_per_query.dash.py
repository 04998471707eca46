"""Query plans and operands (``plan_state_window``, ``plan_tile_query``, K5's
list check): host fetches per dashboard step, each a device-to-host read
that waits for the card, from the program's ``fetch.*`` counters
(``kernels.launch_counts``, read before and after the window) over the
window's steps, one query each.  Nothing to read where the program counts
no fetch."""


def read(ctx):
    steps = ctx.facts.get("window_adds")
    fetches = [v for k, v in ctx.facts.get("window_launches", {}).items()
               if k.startswith("fetch.")]
    if ctx.loop != "dashboard" or not steps or not fetches:
        return None
    return sum(fetches) / steps
