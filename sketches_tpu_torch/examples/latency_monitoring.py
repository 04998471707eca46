"""End-to-end example: fleet-wide latency percentiles with sketches_tpu_torch.

Scenario: a service fleet emits request latencies for many endpoints.  We
maintain one DDSketch per endpoint on-device (thousands of concurrent
sketches in a single [n_endpoints, n_bins] array), ingest batches as they
arrive, and read p50/p90/p99/p999 for every endpoint in one fused query.
A second "region" maintains its own sketch batch; cross-region aggregation
is a single elementwise merge (a multi-device deployment folds the same
way through sketches_tpu_torch.parallel).

This example also demonstrates the telemetry layer *watching itself*:
with ``sketches_tpu_torch.telemetry`` armed, every facade dispatch above
feeds the library's own DDSketch-backed latency histograms (the paper's
production-monitoring use case, applied to the library), user phases are
timed with trace spans, and the whole run exports as a Prometheus text
exposition + a Chrome-trace JSON (written under the temporary directory).

Runs on the card (``--device cpu`` for the CPU):
    python -m sketches_tpu_torch.examples.latency_monitoring
"""

import json
import os
import sys
import tempfile

import numpy as np

from sketches_tpu_torch import BatchedDDSketch, DDSketch, telemetry
from sketches_tpu_torch.batched import resolve_device
from sketches_tpu_torch.examples import host, parser, protobuf_available

N_ENDPOINTS = 1024
BATCH = 4096  # latency samples per endpoint per flush
QS = [0.5, 0.9, 0.99, 0.999]


def _declare() -> None:
    # User-space metrics ride the same inventory discipline as the
    # library's: declare once, then every span/counter name is checked (an
    # undeclared name raises instead of silently forking the inventory).
    telemetry.declare(
        "example.ingest_s", "histogram", "one region's ingest cycle", owner=__name__
    )
    telemetry.declare(
        "example.query_s", "histogram", "fleet-wide fused quantile query",
        owner=__name__,
    )
    telemetry.declare(
        "example.flushes", "counter", "ingest cycles completed", owner=__name__
    )


def simulate_latencies(rng, n_endpoints, batch):
    """Lognormal base latency per endpoint + a slow tail (cache misses)."""
    base = rng.lognormal(mean=3.0, sigma=0.4, size=(n_endpoints, batch))
    tail = rng.lognormal(mean=5.5, sigma=0.6, size=(n_endpoints, batch))
    is_tail = rng.random((n_endpoints, batch)) < 0.02
    return np.where(is_tail, tail, base).astype(np.float32)  # milliseconds


def main(argv=None) -> int:
    device = resolve_device(parser(__doc__).parse_args(argv).device)
    _declare()
    rng = np.random.default_rng(42)
    telemetry.enable()  # arm the self-sketching layer for this run

    # One sketch per endpoint, 1% relative accuracy, on-device.
    region_a = BatchedDDSketch(N_ENDPOINTS, relative_accuracy=0.01, n_bins=2048, device=device)
    region_b = BatchedDDSketch(N_ENDPOINTS, relative_accuracy=0.01, n_bins=2048, device=device)

    for _flush in range(4):  # four ingest cycles per region
        with telemetry.span("example.ingest_s", region="a"):
            region_a.add(simulate_latencies(rng, N_ENDPOINTS, BATCH))
        with telemetry.span("example.ingest_s", region="b"):
            region_b.add(simulate_latencies(rng, N_ENDPOINTS, BATCH))
        telemetry.counter_inc("example.flushes")

    # Fleet-wide view: merge is elementwise on the bin arrays -- the same
    # operation the distributed fold performs across a device mesh.
    fleet = region_a.merge(region_b)

    with telemetry.span("example.query_s"):
        q = host(fleet.get_quantile_values(QS))  # [N_ENDPOINTS, 4]
    counts = host(fleet.count)

    print(f"endpoints: {N_ENDPOINTS}, samples/endpoint: {counts[0]:.0f}")
    print(f"{'endpoint':>8} {'p50':>8} {'p90':>8} {'p99':>8} {'p999':>8}")
    for i in (0, 1, 2, N_ENDPOINTS - 1):
        print(
            f"{i:>8} " + " ".join(f"{q[i, j]:>8.1f}" for j in range(len(QS)))
        )

    # Worst p99 across the fleet -- the panel a dashboard would page on.
    worst = int(np.argmax(q[:, 2]))
    print(f"worst p99: endpoint {worst} at {q[worst, 2]:.1f} ms")

    # Observability counters the device tier maintains for free:
    # collapsed mass (values that fell off the window edges) and overflow
    # risk (largest accumulator vs the f32 exactness ceiling).
    collapsed = float(host(fleet.collapsed_fraction()).max())
    _, risk = fleet.overflow_risk()
    print(
        f"max collapsed fraction: {collapsed:.2e};"
        f" max overflow-risk fraction: {float(host(risk).max()):.2e}"
    )

    # The library watching itself: every facade dispatch above landed in a
    # self-sketch histogram, so the runtime's own p50/p99 carry the same
    # relative-error guarantee as the endpoint latencies.
    snap = telemetry.snapshot()
    ingest_keys = [
        k for k in snap["histograms"] if k.startswith("ingest_s")
    ]
    for k in ingest_keys:
        h = snap["histograms"][k]
        print(
            f"self-sketch {k}: n={h['count']:.0f}"
            f" p50={h['p50'] * 1e3:.2f} ms p99={h['p99'] * 1e3:.2f} ms"
            f" (alpha={h['relative_accuracy']})"
        )
    print(
        "telemetry: "
        f"{len(snap['counters'])} counters, "
        f"{len(snap['histograms'])} histograms, "
        f"{snap['spans']['n_events']} trace events"
    )

    # Prometheus text exposition -- what a scrape endpoint would serve.
    prom = telemetry.prometheus_text()
    example_lines = [
        ln for ln in prom.splitlines()
        if "example_" in ln and not ln.startswith("#")
    ]
    print("prometheus exposition (example.* series):")
    for ln in example_lines[:6]:
        print(f"  {ln}")

    # Chrome-trace export: load this file in chrome://tracing / perfetto
    # to see the spans on per-thread tracks.
    trace = telemetry.chrome_trace()
    out_path = os.path.join(tempfile.gettempdir(), "latency_monitoring_trace.json")
    try:
        with open(out_path, "w") as f:
            json.dump(trace, f)
        print(f"chrome trace: {len(trace['traceEvents'])} events -> {out_path}")
    except OSError:
        print("chrome trace: skipped (unwritable temporary directory)")

    # Interop: any single endpoint's sketch can round-trip through the
    # reference-compatible protobuf wire format for other-language readers.
    if protobuf_available():
        from sketches_tpu_torch.pb.proto import DDSketchProto

        single = DDSketch(0.01)
        for v in simulate_latencies(rng, 1, 1000)[0]:
            single.add(float(v))
        wire = DDSketchProto.to_proto(single).SerializeToString()
        back = DDSketchProto.from_proto(
            type(DDSketchProto.to_proto(single))().FromString(wire)
        )
        print(
            f"proto round-trip: {len(wire)} bytes, "
            f"p99 {back.get_quantile_value(0.99):.1f} ms"
        )
    else:
        print("proto round-trip skipped (protobuf not installed)")
    telemetry.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
