"""Fleet observability end to end: N shard processes, one merged story.

Scenario: a sketch-serving fleet runs many processes (hosts, shards,
jobs).  Each process self-sketches its own runtime with the telemetry
layer (PR 4) -- but a fleet dashboard needs ONE p99, not N of them.
This example exercises the whole r11 observability stack:

1. **Shards**: N worker processes each run a production-shaped workload
   (batched ingest, fused quantile queries, a merge, a wire round trip)
   with telemetry + device-time profiling + the accuracy shadow audit
   armed, then write their snapshot JSON -- the per-process artifact.
2. **Merge**: the parent folds the shard snapshots with
   ``telemetry.merge_snapshots``: counters sum, histograms merge as
   DDSketches, so the fleet-wide p50/p99 printed below carry the same
   alpha=0.01 guarantee as any single process's (the paper's
   mergeability property, applied to the library's own telemetry).
3. **Attribution**: the merged device-time table says where the
   device's time went, per engine tier and phase, against the declared
   roofline estimate.
4. **SLO gate**: the telemetry CLI, ``python -m sketches_tpu_torch.telemetry
   --check-slo``, evaluates the declared SLO inventory against the merged
   snapshot.

Runs on the card; ``--device`` passes through to every shard:
    python -m sketches_tpu_torch.examples.fleet_dashboard [--shards 3] [--outdir DIR] [--device cpu]

Exit code: 0 when every evaluable SLO is within budget, 1 on a burning
SLO or a failed shard (the dashboard doubles as a gate).
"""

import json
import os
import subprocess
import sys
import tempfile

#: The directory that holds the ``sketches_tpu_torch`` package: the shard
#: processes import it from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_STREAMS = 256
BATCH = 1024
N_BATCHES = 8
QS = [0.5, 0.9, 0.99]


def run_shard(shard: int, outdir: str, device, trace_path=None) -> None:
    """One fleet shard: warm up, arm the observability layers, run the
    workload, write the snapshot artifact."""
    import numpy as np

    from sketches_tpu_torch import accuracy, profiling, telemetry, tracing
    from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec
    from sketches_tpu_torch.pb import wire

    rng = np.random.RandomState(1000 + shard)
    spec = SketchSpec(relative_accuracy=0.01, n_bins=512)
    sk = BatchedDDSketch(N_STREAMS, spec=spec, device=device)

    # Warm up DISARMED: kernel builds and first launches are a
    # process-lifetime one-off, not a serving latency -- the SLO gate
    # measures the warm path.  Two adds: the first takes the recentering
    # first-batch path, the second the steady-state ingest the armed loop
    # below takes.  ``other`` (the armed phase's merge operand) warms
    # here too, so the armed region bills no first-use cost to the
    # ingest SLO.
    sk.add(rng.lognormal(3.0, 0.4, (N_STREAMS, BATCH)).astype(np.float32))
    sk.add(rng.lognormal(3.0, 0.4, (N_STREAMS, BATCH)).astype(np.float32))
    sk.get_quantile_values(QS)
    other = BatchedDDSketch(N_STREAMS, spec=spec, device=device)
    other.add(rng.lognormal(3.0, 0.4, (N_STREAMS, BATCH)).astype(np.float32))
    other.add(rng.lognormal(3.0, 0.4, (N_STREAMS, BATCH)).astype(np.float32))
    sk.merge(other)
    wire.bytes_to_state(spec, wire.state_to_bytes(spec, sk.state), device=device)

    telemetry.enable()
    telemetry.reset()
    profiling.enable()
    profiling.reset()
    accuracy.enable()
    accuracy.reset()
    accuracy.watch(sk, f"shard{shard}", streams=(0, 1, 2, 3), interval=4)
    # Deterministic per-shard trace ids: the merged exemplars below name
    # the same traces every run (no-op when the recorder is disarmed).
    tracing.seed_ids(1000 + shard)

    for _ in range(N_BATCHES):
        vals = rng.lognormal(3.0, 0.4, (N_STREAMS, BATCH)).astype(np.float32)
        # One trace per tick: the ingest+query spans (and their histogram
        # exemplars) link to it, so the merged p99 answers with trace ids.
        ctx = tracing.new_trace() if tracing.enabled() else None
        with tracing.use(ctx):
            sk.add(vals)
            sk.get_quantile_values(QS)
    other.add(rng.lognormal(3.0, 0.4, (N_STREAMS, BATCH)).astype(np.float32))
    sk.merge(other)
    blobs = wire.state_to_bytes(spec, sk.state)
    wire.bytes_to_state(spec, blobs, device=device)

    snap = telemetry.snapshot()
    path = os.path.join(outdir, f"snap{shard}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
        f.write("\n")
    if trace_path:
        with open(trace_path, "w", encoding="utf-8") as f:
            json.dump(telemetry.chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")
    acc = accuracy.summary()
    print(
        f"shard {shard}: {int(acc['audits'])} audits,"
        f" {int(acc['violations'])} violations -> {path}"
    )


def _fmt_s(v) -> str:
    return "-" if v is None else f"{v * 1e3:8.3f} ms"


def _fleet_chrome_trace(outdir: str, n_shards: int, path: str) -> None:
    """Concatenate the shards' chrome traces into ONE viewer document:
    shard ``s``'s tracks are re-homed onto pids ``s*10 + pid`` (the
    declared per-process pid scheme stays collision-free across the
    fleet) with the shard named in ``process_name``."""
    events = []
    for s in range(n_shards):
        shard_path = os.path.join(outdir, f"trace{s}.json")
        if not os.path.exists(shard_path):
            continue
        with open(shard_path, encoding="utf-8") as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = s * 10 + int(ev.get("pid", 0))
            if ev.get("name") == "process_name":
                args = dict(ev.get("args") or {})
                args["name"] = f"shard {s}: {args.get('name', '?')}"
                ev["args"] = args
            events.append(ev)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  indent=1, sort_keys=True)
        f.write("\n")


def run_fleet(n_shards: int, outdir: str, device: str, trace: str = None) -> int:
    """Spawn the shards, merge their snapshots, print the dashboard."""
    # Sequential shards: N concurrent processes contending for a few
    # cores (or one card) would bill scheduler noise to the latency SLOs.
    # A real fleet's shards own their hosts.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p
    )
    for s in range(n_shards):
        cmd = [sys.executable, "-m", "sketches_tpu_torch.examples.fleet_dashboard",
               "--worker", str(s), "--outdir", outdir, "--device", device]
        if trace:
            cmd += ["--trace", os.path.join(outdir, f"trace{s}.json")]
        done = subprocess.run(cmd, env=env, capture_output=True, text=True)
        print(done.stdout, end="")
        if done.returncode != 0:
            print(done.stderr, end="", file=sys.stderr)
            print(f"fleet: shard {s} failed (rc={done.returncode}); no merged verdict")
            return 1

    from sketches_tpu_torch import telemetry

    snaps = []
    for s in range(n_shards):
        with open(os.path.join(outdir, f"snap{s}.json"), encoding="utf-8") as f:
            snaps.append(json.load(f))
    merged = telemetry.merge_snapshots(*snaps)
    merged_path = os.path.join(outdir, "fleet-merged.json")
    with open(merged_path, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.write("\n")

    print(f"\n== fleet histograms ({merged['merged_from']} shards merged,"
          f" alpha={merged['histogram_relative_accuracy']}) ==")
    for name in sorted(merged["histograms"]):
        h = merged["histograms"][name]
        print(
            f"  {name:55s} n={h['count']:7.0f}"
            f" p50={_fmt_s(h['p50'])} p99={_fmt_s(h['p99'])}"
        )

    prof = merged.get("profiling") or {}
    rows = prof.get("attribution") or []
    print("\n== device-time attribution (merged measured vs roofline) ==")
    attribution_path = os.path.join(outdir, "attribution.json")
    with open(attribution_path, "w", encoding="utf-8") as f:
        json.dump(prof, f, indent=1, sort_keys=True)
        f.write("\n")
    measured = prof.get("measured") or {}
    for key in sorted(measured):
        m = measured[key]
        print(
            f"  {key:18s} calls={m['calls']:6.0f}"
            f" total={m['total_s']:8.4f}s mean={_fmt_s(m.get('mean_s'))}"
        )
    for row in rows:
        if row.get("x_roofline") is not None:
            print(
                f"  {row['phase']}/{row['tier']} -> {row['entry']}:"
                f" {row['x_roofline']:.0f}x above the declared roofline"
            )

    if trace:
        from sketches_tpu_torch import tracing

        _fleet_chrome_trace(outdir, n_shards, trace)
        bundle_path = trace + ".forensics.json"
        tracing.dump_forensics(
            "fleet_dashboard.end_of_run",
            detail={"shards": n_shards},
            snapshot=merged,
            path=bundle_path,
        )
        print(f"\nfleet: chrome trace -> {trace};"
              f" forensic bundle -> {bundle_path}")
        # The merged-exemplar drill: the trace ids behind the FLEET p99
        # (reservoirs survived merge_snapshots; ids name shard requests).
        try:
            found = telemetry.exemplars_for(merged, "query_s", 0.99)
        except Exception as e:  # noqa: BLE001 - diagnostic, not a gate
            print(f"fleet: p99 exemplars unavailable: {e}")
        else:
            print(f"fleet: query_s p99 exemplar traces (bin"
                  f" {found['bin_key']}):")
            for ex in found["exemplars"]:
                print(f"  trace {ex['trace_id']}  value {ex['value']:g}s")
            if not found["exemplars"]:
                print("  (no traced observation reached the p99 bin)")

    print("\n== SLO verdict ==")
    # The gate is the telemetry CLI's: exit 0 within budget, 1 burning,
    # 2 when nothing was evaluable.
    rc = telemetry.main(["--check-slo", merged_path])
    print(
        f"fleet: merged snapshot -> {merged_path};"
        f" attribution -> {attribution_path}"
    )
    if rc == 2:
        print("fleet: no SLO was evaluable (empty snapshots?)")
        return 1
    if rc:
        print("fleet: SLO(s) BURNING")
        return 1
    _, _, evaluated = telemetry.check_slo(merged)
    print(f"fleet: {evaluated} SLO(s) within budget")
    return 0


def main(argv=None) -> int:
    from sketches_tpu_torch.examples import parser as _parser

    parser = _parser(__doc__)
    parser.add_argument("--shards", type=int, default=3)
    parser.add_argument("--outdir", default=None)
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="write the fleet's combined chrome trace to"
                        " PATH and a forensic bundle (merged snapshot +"
                        " parent flight recorder) to PATH.forensics.json;"
                        " prints the exemplar trace ids behind the merged"
                        " p99")
    parser.add_argument("--worker", type=int, default=None,
                        help=__import__("argparse").SUPPRESS)
    args = parser.parse_args(argv)
    from sketches_tpu_torch.batched import resolve_device

    device = resolve_device(args.device)
    if args.worker is not None:
        run_shard(args.worker, args.outdir or tempfile.gettempdir(), device,
                  trace_path=args.trace)
        return 0
    outdir = args.outdir or tempfile.mkdtemp(prefix="fleet_dashboard_")
    os.makedirs(outdir, exist_ok=True)
    return run_fleet(args.shards, outdir, args.device, trace=args.trace)


if __name__ == "__main__":
    sys.exit(main())
