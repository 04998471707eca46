"""Fold (``kernels.add``, with ``_stream_op``'s copies into the state):
device milliseconds a traced ``add`` spends in operations other than K1,
from the profiler's trace."""

K1 = "ingest_kernel"


def read(ctx):
    n = ctx.calls.get("add", 0)
    if ctx.loop != "ingest" or not n or not ctx.device_s("add", only=K1):
        return None
    return ctx.device_s("add", skip=K1) / n * 1e3
