"""K1 (``csrc/ingest.cu``): its byte-bound time over its device time, in
percent, over the traced adds.  Bytes (``yardstick/kernel_bytes.py``):
the values, the weights when weighted and the window offsets read once;
two ``[n, n_bins]`` histograms and the column block written once; over
the card's published bandwidth (``yardstick/peaks.py``)."""

K1 = "ingest_kernel"


def read(ctx):
    t = ctx.device_s("add", only=K1)
    n = ctx.calls.get("add", 0)
    per_add = ctx.facts.get("k1_bytes_per_add")
    if ctx.loop != "ingest" or not t or not n or not per_add:
        return None
    return 100.0 * n * per_add / ctx.mem_rate / t
