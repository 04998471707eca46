"""K3 (``csrc/windowed.cu``): its byte-bound time over its device time, in
percent, over the traced queries.  Bytes: the occupied window of each
store read, the per-stream operand and the answers, counted on the input
of the last traced query (``yardstick/kernel_bytes.py``)."""

KERNEL = "windowed_kernel"


def read(ctx):
    t = ctx.device_s("query", only=KERNEL)
    n = ctx.calls.get("query", 0)
    per_query = ctx.facts.get("k3_bytes")
    if not t or not n or not per_query:
        return None
    return 100.0 * n * per_query / ctx.mem_rate / t
