"""Dashboard: a closed loop with one client that repeats a step: one
``add`` of a batch, acknowledged once the card has applied it, then one
multi-quantile query over every stream, synchronised (a dashboard backend
that writes, waits for the write to land, and refreshes the next panel
once the last one is answered).

``query_p50_ms`` / ``query_p95_ms``: percentiles over every query of the
window, from the call to its synchronised answer; ``fresh_p95_ms``: the
95th percentile over every step of the time from handing the batch to
``add`` to the synchronised answer that includes it.  Without the
acknowledgement the query's first plan fetch waits out whatever of the
``add`` the card has not yet run, so the query's time would measure a race
between the host's enqueue and the card, which ``fresh_p95_ms`` measures.
"""

from sketchbench.loops import clock, percentile, sync

WARM_STEPS = 3


def warm(sut, inputs, traffic) -> int:
    qs = tuple(traffic["quantiles"])
    for i in range(WARM_STEPS):
        sut.add(inputs.batch(i), inputs.weights)
        sut.query(qs)
    sync(inputs.levels.device)
    return WARM_STEPS


def window(sut, inputs, traffic, seconds, tracer, rows, start) -> dict:
    dev = inputs.levels.device
    qs = tuple(traffic["quantiles"])
    i, n = start, 0
    lat, fresh, host_add, steps, kept, tiers = [], [], [], [], [], set()
    tracer.start()
    t0 = clock()
    while True:
        traced = tracer.active
        a = clock()
        with tracer.range("add"):
            sut.add(inputs.batch(i), inputs.weights)
        host = clock() - a
        with tracer.range("ack"):
            sync(dev)
        b = clock()
        with tracer.range("query"):
            tier, answers = sut.query(qs)
            sync(dev)
        c = clock()
        kept.append((i, answers.index_select(0, rows)))
        tiers.add(tier)
        lat.append(c - b)
        fresh.append(c - a)
        if not traced:
            host_add.append(host)
            steps.append(c - a)
        i, n = i + 1, n + 1
        if traced and n == tracer.steps:
            tracer.stop()
        if c - t0 >= seconds:
            break
    if tracer.active:
        tracer.stop()
    return {
        "adds": i,
        "ops": n,
        "metrics": {
            "query_p50_ms": percentile(lat, 50) * 1e3,
            "query_p95_ms": percentile(lat, 95) * 1e3,
            "fresh_p95_ms": percentile(fresh, 95) * 1e3,
        },
        "host": {"add": host_add, "call": steps},
        "kept": kept,
        "info": {"window_s": clock() - t0, "queries": n, "tiers": sorted(tiers)},
    }
