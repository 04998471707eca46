"""End-to-end example: a time-windowed quantile dashboard.

Scenario: a multi-tenant dashboard backend answers "p50/p99 over the
last W seconds" for tenants with Zipf-skewed traffic.  Each tenant is a
:class:`sketches_tpu_torch.windows.WindowedSketch` behind the serving tier: a
ring of 5 s time-slice buckets cascading into 20 s ladder buckets,
ingest routed to the current slice by a **virtual clock** (the whole
drill is deterministic -- zero sleeps, replays exactly), window queries
answered by ONE fused stacked-merge dispatch over the covered buckets
and cached under the covered-bucket fingerprint-set digest (rotation or
ingest moves the digest, so stale entries miss -- never serve a
stale-wrong window).

The drill prints rolling per-window p50/p99 per tenant as the clock
advances, then the mass-ledger verdict: every ingested value must be in
exactly one live bucket or in ``retired_mass`` (compared ``==``, never
approximately), every bucket's ledger entry must equal its device-side
mass, and every window answer must be bit-identical to the host-side
oracle merge of its covered buckets.  Exits 1 on any breach.

Runs on the card (``--device cpu`` for the CPU):
    python -m sketches_tpu_torch.examples.windowed_dashboard
"""

import sys

import numpy as np

from sketches_tpu_torch import integrity, serve
from sketches_tpu_torch.batched import SketchSpec, resolve_device
from sketches_tpu_torch.examples import host, parser
from sketches_tpu_torch.windows import VirtualClock, WindowConfig, oracle_quantile

N_STREAMS = 32          # endpoints per tenant
TENANTS = ("checkout", "search", "profile")
ZIPF_S = 1.2            # traffic skew across tenants
TICKS = 48              # 2 s per tick -> 96 s of virtual traffic
BATCH = 64
WINDOWS = (10.0, 60.0)  # the dashboard's "last 10 s" / "last minute"
QS = (0.5, 0.99)
CONFIG = WindowConfig(slices_s=(5.0, 20.0), lengths=(4, 3))


def main(argv=None) -> int:
    device = resolve_device(parser(__doc__).parse_args(argv).device)
    clock = VirtualClock(0.0)
    srv = serve.SketchServer(clock=clock)
    spec = SketchSpec(relative_accuracy=0.01, n_bins=256)
    for name in TENANTS:
        srv.add_tenant(name, N_STREAMS, window=CONFIG, spec=spec, device=device)
    rng = np.random.default_rng(2026)
    ranks = np.arange(1, len(TENANTS) + 1, dtype=np.float64)
    traffic = ranks ** -ZIPF_S
    traffic /= traffic.sum()
    print(
        f"windowed dashboard: {len(TENANTS)} tenants x {N_STREAMS}"
        f" streams, ladder"
        f" {[f'{s:g}s x {n}' for s, n in zip(CONFIG.slices_s, CONFIG.lengths)]},"
        f" Zipf({ZIPF_S}) traffic, virtual clock (zero sleeps)"
    )
    ingested = {name: 0.0 for name in TENANTS}
    for tick in range(TICKS):
        clock.advance(2.0)
        # Zipf-weighted ingest: the hot tenant gets most of the batches.
        for name, share in zip(TENANTS, traffic):
            n_batches = int(rng.poisson(share * 4))
            for _ in range(n_batches):
                # Latency-shaped values whose location drifts over time.
                vals = rng.lognormal(
                    0.2 + 0.01 * tick, 0.6, (N_STREAMS, BATCH)
                ).astype(np.float32)
                srv.ingest(name, vals)
                ingested[name] += vals.size
        if (tick + 1) % 12 == 0:
            print(f"--- t = {clock.t:5.0f} s ---")
            for name in TENANTS:
                row = [f"  {name:>8}"]
                for win in WINDOWS:
                    res = srv.quantile(name, list(QS), window=win)
                    vals = host(res.values)
                    p50 = float(np.nanmedian(vals[:, 0]))
                    p99 = float(np.nanmedian(vals[:, 1]))
                    src = "cache" if res.cached else "fused"
                    row.append(
                        f"last {win:3.0f}s: p50 {p50:6.3f}  p99"
                        f" {p99:6.3f} [{src}]"
                    )
                print("  |  ".join(row))

    # -- the verdict: exact ledger + oracle bit-identity ------------------
    stats = srv.stats()
    print(
        f"served {stats['requests']:.0f} requests, cache hits"
        f" {stats['cache_hits']:.0f}, dispatches {stats['dispatches']:.0f}"
    )
    failures = 0
    for name in TENANTS:
        wsk = srv.tenant(name)
        led = wsk.ledger()
        exact = (
            led["total"] == ingested[name]
            and led["total"] == led["live"] + led["retired"]
        )
        clean = not integrity.check_window(wsk)
        got = host(wsk.quantile(QS, window=60.0))
        want = host(oracle_quantile(wsk, QS, window=60.0))
        oracle_ok = bool(np.array_equal(got, want, equal_nan=True))
        ok = exact and clean and oracle_ok
        failures += not ok
        print(
            f"  {name:>8}: total {led['total']:9.0f} = live"
            f" {led['live']:9.0f} + retired {led['retired']:8.0f}"
            f" | rotations {led['rotations']:3.0f}"
            f" | ledger {'EXACT' if exact and clean else 'BROKEN'}"
            f" | oracle {'bit-identical' if oracle_ok else 'DIVERGED'}"
        )
    if failures:
        print(f"windowed dashboard FAILED: {failures} tenant(s) broken")
        return 1
    print("windowed dashboard passed: ledger exact, oracle bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
