"""Chunking (``BatchedDDSketch._stream_op``): K1 launches per ``add`` of
the window, from the program's launch counter (``kernels.launch_counts``,
read before and after the window)."""


def read(ctx):
    adds = ctx.facts.get("window_adds")
    k1 = ctx.facts.get("window_launches", {}).get("ingest_histogram")
    if ctx.loop != "ingest" or not adds or not k1:
        return None
    return k1 / adds
