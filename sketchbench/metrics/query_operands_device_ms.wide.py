"""Query plans and operands on the wide cell's route (``plan_state_window``,
``plan_tile_query``, ``_tile_query_operands``): device milliseconds a
traced query spends in operations other than the route's kernel."""

ROUTE_KERNELS = ("overlap_kernel", "windowed_kernel", "tiles_kernel", "ring_kernel",
                 "wide_kernel")


def read(ctx):
    n = ctx.calls.get("query", 0)
    if ctx.loop != "dashboard" or not n:
        return None
    route = sum(ctx.device_s("query", only=k) for k in ROUTE_KERNELS)
    if not route:
        return None
    return (ctx.device_s("query") - route) / n * 1e3
