"""Chunk loop (``BatchedDDSketch._stream_op`` and ``kernels.add``): device-idle
milliseconds per traced dashboard ``add`` whose gap opened while the
innermost host event was one of the program's four per-chunk spans
(``ingest.slice_s``, ``ingest.k1_s``, ``ingest.fold_s``,
``ingest.copy_back_s``): the card waiting on the host's Python in the chunk
loop, from the profiler's trace.  Nothing to read where the program names
no span in the trace."""

PREFIX = "add:sketches_tpu_torch."
CHUNK_SPANS = ("ingest.slice_s", "ingest.k1_s", "ingest.fold_s", "ingest.copy_back_s")


def read(ctx):
    n = ctx.calls.get("add", 0)
    if ctx.loop != "dashboard" or not n or not any(k.startswith(PREFIX) for k in ctx.idle):
        return None
    return sum(ctx.idle.get(PREFIX + s, 0.0) for s in CHUNK_SPANS) / n * 1e3
