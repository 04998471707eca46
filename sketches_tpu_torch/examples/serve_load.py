"""Millions-of-users serving simulation: Zipf tenants, mixed read/write.

Production dashboard traffic is repetitive and skewed: most p50/p99
queries hit a handful of hot tenants whose sketches have not changed
since the last tick.  This driver simulates that shape against the
serving tier (``sketches_tpu_torch/serve.py``):

* **Tenants** follow a Zipf popularity law (a seeded generator -- the
  run replays exactly): a few hot tenants absorb most requests, a long
  tail stays cold.
* **Mixed read/write**: most operations are quantile reads (batched
  through the admission queue and flushed as fused device dispatches);
  a fraction are writes (ingest batches), which move the tenant's
  content fingerprint and naturally invalidate its cached results.
* **The robustness envelope is live**: bounded admission queue,
  per-tenant quotas, deadline budgets, hedged retries, and the
  fingerprint-keyed result cache.

The report at the end is the serving story's scoreboard: sustained QPS
(requests answered per second of driver wall time), cache hit rate,
shed fraction, and deadline-miss rate.  With ``--snapshot OUT.json``
(and ``SKETCHES_TPU_TELEMETRY=1``) the process telemetry snapshot is
written for the SLO gate (``python -m sketches_tpu_torch.telemetry
--check-slo OUT.json``).

Runs on the card (``--device cpu`` for the CPU):
    python -m sketches_tpu_torch.examples.serve_load

Exit code: 0 when the drive completes with a shed fraction and
deadline-miss rate inside the declared SLO budgets (5% each), 1
otherwise -- the driver doubles as an overload-soak gate.
"""

import json
import sys

N_TENANTS = 24
N_STREAMS = 16
BATCH = 256
ZIPF_A = 1.3  # popularity skew: tenant rank r gets ~ r**-a of the traffic
WRITE_FRACTION = 0.2
FLUSH_EVERY = 8  # reads admitted between fused flushes
QS_MENU = ((0.5,), (0.9,), (0.99,), (0.5, 0.9, 0.99), (0.25, 0.5, 0.75))


def main(argv=None) -> int:
    from sketches_tpu_torch.examples import parser as _parser

    parser = _parser(__doc__)
    parser.add_argument("--ops", type=int, default=3000,
                        help="total operations (reads + writes) to drive")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snapshot", default=None, metavar="OUT",
                        help="write the telemetry snapshot JSON here"
                        " (arm with SKETCHES_TPU_TELEMETRY=1)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="arm telemetry+tracing, write the end-of-run"
                        " chrome trace to PATH and a flight-recorder"
                        " forensic bundle to PATH.forensics.json, and"
                        " print the exemplar trace ids behind the"
                        " reported p99")
    args = parser.parse_args(argv)

    import numpy as np

    from sketches_tpu_torch import serve, telemetry, tracing
    from sketches_tpu_torch.batched import SketchSpec, resolve_device

    device = resolve_device(args.device)

    if args.trace:
        # --trace implies the observability stack: telemetry arms the
        # flight recorder with it (kill switch permitting), and the
        # seeded id stream makes re-runs print the same trace ids.
        telemetry.enable()
        tracing.seed_ids(args.seed)

    rng = np.random.default_rng(args.seed)
    spec = SketchSpec(relative_accuracy=0.01, n_bins=128)
    # hedge_after_s is sized for this driver's host-dispatch reality:
    # a warm dispatch is ~ms, so 500 ms means a genuine straggler (a
    # mid-drive kernel build), not noise.  The deterministic straggler/
    # breaker walks live in the serve tests under a virtual clock.
    server = serve.SketchServer(
        serve.ServeConfig(max_queue_depth=512, tenant_quota=128,
                          default_deadline_s=1.0, hedge_after_s=0.5)
    )
    names = [f"tenant{i:02d}" for i in range(N_TENANTS)]
    for name in names:
        server.add_tenant(name, N_STREAMS, spec=spec, device=device)

    # Zipf popularity: rank r served with probability ~ (r+1)**-a.
    pop = (np.arange(N_TENANTS) + 1.0) ** -ZIPF_A
    pop /= pop.sum()

    # Seed every tenant with one batch, then warm the query paths
    # DISARMED: kernel builds are a process-lifetime one-off, not a
    # serving latency -- the armed drive (and the SLO gate) measures
    # the warm path, exactly like fleet_dashboard.
    telemetry_armed = telemetry.enabled()
    telemetry.disable()
    for name in names:
        server.ingest(
            name, rng.lognormal(0.0, 0.5, (N_STREAMS, BATCH)).astype(np.float32)
        )
    for qs in QS_MENU:
        for name in names:
            server.query(name, qs)
    t1 = server.submit(names[0], (0.5,))
    t2 = server.submit(names[1], (0.5,))
    server.flush()
    del t1, t2
    if telemetry_armed:
        telemetry.enable()
        telemetry.reset()

    t_start = telemetry.clock()
    answered = 0
    errors = {"shed": 0, "deadline": 0}
    pending = 0
    for op in range(args.ops):
        if rng.random() < WRITE_FRACTION:
            name = names[int(rng.choice(N_TENANTS, p=pop))]
            vals = rng.lognormal(0.0, 0.5, (N_STREAMS, BATCH))
            server.ingest(name, vals.astype(np.float32))
            continue
        name = names[int(rng.choice(N_TENANTS, p=pop))]
        qs = QS_MENU[int(rng.integers(len(QS_MENU)))]
        try:
            ticket = server.submit(name, qs)
        except serve.ServeOverload:
            errors["shed"] += 1
            continue
        except serve.DeadlineExceeded:
            errors["deadline"] += 1
            continue
        if ticket.result is not None:
            answered += 1  # cache hit at admission
            continue
        pending += 1
        if pending >= FLUSH_EVERY:
            answered += len(server.flush())
            pending = 0
    if pending:
        answered += len(server.flush())
    elapsed = telemetry.clock() - t_start

    stats = server.stats()
    requests = max(stats["requests"], 1)
    shed_fraction = stats["shed"] / requests
    miss_rate = stats["deadline_misses"] / requests
    cache_lookups = max(stats["cache_hits"] + stats["cache_misses"], 1)
    hit_rate = stats["cache_hits"] / cache_lookups
    qps = answered / max(elapsed, 1e-9)

    print(f"serve_load: {args.ops} ops over {N_TENANTS} Zipf(a={ZIPF_A})"
          f" tenants, seed {args.seed}")
    print(f"  answered          {answered} requests in {elapsed:.2f}s"
          f" -> {qps:,.0f} QPS sustained")
    print(f"  cache hit rate    {hit_rate:.1%}"
          f" ({stats['cache_hits']:.0f}/{cache_lookups:.0f} lookups,"
          f" {stats['cache_poisoned']:.0f} poisoned)")
    print(f"  shed fraction     {shed_fraction:.2%}"
          f" ({stats['shed']:.0f}/{requests:.0f} requests)")
    print(f"  deadline misses   {miss_rate:.2%}"
          f" ({stats['deadline_misses']:.0f}/{requests:.0f})")
    print(f"  dispatches        {stats['dispatches']:.0f}"
          f" ({stats['fused_dispatches']:.0f} cross-tenant fused,"
          f" {stats['hedges']:.0f} hedged,"
          f" {stats['breaker_trips']:.0f} breaker trips)")

    if args.snapshot:
        snap = telemetry.snapshot()
        with open(args.snapshot, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"  telemetry snapshot ({'armed' if telemetry_armed else 'idle'})"
              f" -> {args.snapshot}")

    if args.trace:
        with open(args.trace, "w", encoding="utf-8") as f:
            json.dump(telemetry.chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")
        bundle_path = args.trace + ".forensics.json"
        tracing.dump_forensics(
            "serve_load.end_of_run",
            detail={"ops": args.ops, "seed": args.seed},
            path=bundle_path,
        )
        print(f"  chrome trace      -> {args.trace}")
        print(f"  forensic bundle   -> {bundle_path}"
              f"  (explain: python -m sketches_tpu_torch.tracing --explain"
              f" {bundle_path} TRACE_ID)")
        # The exemplar drill: which requests sit behind the p99 we just
        # reported?  (Reservoirs hold traced observations only, so an
        # empty answer means no request landed near that bin.)
        found = telemetry.exemplars_for(
            telemetry.snapshot(), "serve.request_s", 0.99
        )
        print(f"  p99 exemplars     serve.request_s bin {found['bin_key']}"
              f" (~{0.0 if found['bin_value'] is None else found['bin_value']:g}s)")
        for ex in found["exemplars"]:
            print(f"    trace {ex['trace_id']}  value {ex['value']:g}s")
        if not found["exemplars"]:
            print("    (no traced observation reached the p99 neighborhood)")

    # The driver doubles as a gate: the declared serving SLO budgets
    # (telemetry.SLOS serve-shed / serve-deadline) are 5% each.
    ok = shed_fraction <= 0.05 and miss_rate <= 0.05
    print(f"  verdict           {'ok' if ok else 'OVER BUDGET'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
