"""Ingest: a closed loop with one client that issues ``add`` back to back
with no synchronisation in between (an aggregator flushing as fast as the
card takes batches) and synchronises once when the window ends.

``ingest_values_per_s``: live values passed to ``add`` in the window over
the window's seconds, which end after that synchronisation.
"""

from sketchbench.loops import clock, sync

WARM_ADDS = 3


def warm(sut, inputs, traffic) -> int:
    for i in range(WARM_ADDS):
        sut.add(inputs.batch(i), inputs.weights)
    sync(inputs.levels.device)
    return WARM_ADDS


def window(sut, inputs, traffic, seconds, tracer, rows, start) -> dict:
    dev = inputs.levels.device
    i, n, host = start, 0, []
    tracer.start()
    t0 = clock()
    t_plain, n_plain = t0, 0  # the untraced stretch: from the tracer's stop
    while True:
        if tracer.active and n == tracer.steps:
            tracer.stop()
            t_plain, n_plain = clock(), n
        traced = tracer.active
        a = clock()
        with tracer.range("add"):
            sut.add(inputs.batch(i), inputs.weights)
        b = clock()
        if not traced:
            host.append(b - a)
        i, n = i + 1, n + 1
        if b - t0 >= seconds:
            break
    if tracer.active:
        tracer.stop()
        t_plain, n_plain = clock(), n
    sync(dev)
    t1 = clock()
    plain = n - n_plain
    return {
        "adds": i,
        "ops": n,
        "metrics": {"ingest_values_per_s": n * inputs.live_values / (t1 - t0)},
        "host": {"add": host, "call": [(t1 - t_plain) / plain] if plain else []},
        "kept": [],
        "info": {"window_s": t1 - t0, "adds": n, "live_values_per_add": inputs.live_values},
    }
