"""Facade (``batched.py``: ``BatchedDDSketch.add``, ``_stream_op``): host
milliseconds for ``add`` to return, mean over the untraced adds of the
ingest loop's window (host clock around each call)."""


def read(ctx):
    adds = ctx.host.get("add") or []
    if ctx.loop != "ingest" or not adds:
        return None
    return sum(adds) / len(adds) * 1e3
