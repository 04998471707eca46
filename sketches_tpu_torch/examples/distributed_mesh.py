"""Example: elastic mesh drill -- kill a shard mid-ingest, regrow the mesh.

Each value shard on the mesh ingests a different chunk of every stream's
values into a per-shard partial histogram; queries fold the partials --
the DDSketch ``merge()`` as a collective.  Because every partial is
itself an exact sketch (full mergeability), the fleet is *elastic*: this
drill ingests, KILLS a value shard mid-stream, regrows onto a LARGER mesh
with exact per-stream mass accounting (the dead shard's mass itemized, the
survivors' fold verified by the integrity layer's merge-additive
fingerprints), keeps ingesting, then SHRINKS the mesh -- all without
violating the alpha contract on the surviving mass.

The mesh's pool is eight entries of ``--device`` (the card by default):
eight value shards, which may share one card, as the JAX package's
example runs on an 8-device virtual CPU mesh:

    python -m sketches_tpu_torch.examples.distributed_mesh [--device cpu]
"""

import sys

import numpy as np

from sketches_tpu_torch import faults, integrity
from sketches_tpu_torch.batched import resolve_device
from sketches_tpu_torch.examples import host, parser
from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh

POOL = 8


def main(argv=None) -> int:
    device = resolve_device(parser(__doc__).parse_args(argv).device)
    pool = [device] * POOL
    n = len(pool)
    print(f"devices: {n} x {device.type}")

    # The reshard boundary must be PROVEN, not hoped: armed integrity
    # verifies the fingerprint lane at every fold and reshard.
    integrity.arm("raise")

    n_streams, batch = 32, 512
    k0 = min(4, n)
    mesh = SketchMesh(k0, n_hosts=2 if k0 >= 2 else 1, devices=pool)
    dist = DistributedDDSketch(
        n_streams, mesh=mesh, relative_accuracy=0.01, n_bins=1024
    )
    print(f"fleet: {mesh}")

    rng = np.random.default_rng(7)
    # Exact value ledger: a killed shard loses its WHOLE partial (every
    # batch's column block since the mesh was built), so the drill
    # tracks values per (stream, shard) for the current mesh epoch;
    # folding an epoch moves the surviving shards' values into `kept`.
    kept = [[] for _ in range(n_streams)]
    epoch = [[[] for _ in range(dist.n_value_shards)]
             for _ in range(n_streams)]

    def ingest(d, steps):
        # values[i] is stream i's next chunk; the mesh splits the chunk
        # across the value axis in contiguous column blocks, so the
        # drill knows EXACTLY which values live on which shard.
        k = d.n_value_shards
        w = batch // k
        for _ in range(steps):
            values = rng.lognormal(3.0, 0.5, (n_streams, batch)).astype(
                np.float32
            )
            d.add(values)
            for i in range(n_streams):
                for s in range(k):
                    epoch[i][s].extend(values[i, s * w:(s + 1) * w])
        return d

    def end_epoch(d, dead=()):
        # Fold the epoch's surviving shards into the flat ledger; the
        # regrown fleet's slot-0 partial holds all of it.
        for i in range(n_streams):
            for s in range(len(epoch[i])):
                if s not in dead:
                    kept[i].extend(epoch[i][s])
            epoch[i] = [[] for _ in range(d.n_value_shards)]

    dist = ingest(dist, 5)

    # --- kill a shard mid-ingest, regrow onto a LARGER mesh ------------
    dead = 1
    pre_count = host(dist.count, np.float64)
    faults.arm(faults.MESH_SHARD, shards=(dead,))
    try:
        dist, report = dist.reshard(mesh=mesh.resized(min(8, n)))
    finally:
        faults.disarm()
    end_epoch(dist, dead={dead})
    print(
        f"kill-and-regrow: {report.from_devices} -> {report.to_devices}"
        f" devices, dead shards {report.dead_shards}"
    )
    print(
        "  mass accounting: surviving"
        f" {report.surviving_count.sum():.0f}, dropped"
        f" {report.total_dropped:.0f}"
        f" ({report.total_dropped_fraction:.1%}), itemized per stream:"
        f" {report.dropped_count[:4]}..."
    )
    print(
        f"  exact fold: {report.exact}, fingerprints match:"
        f" {report.fingerprints_match}"
    )
    assert report.exact and report.fingerprints_match
    assert report.surviving_count.sum() + report.total_dropped == \
        pre_count.sum()

    # --- keep serving on the regrown fleet, then SHRINK ----------------
    dist = ingest(dist, 2)
    dist, shrink = dist.reshard(n_devices=2)
    end_epoch(dist)
    print(
        f"shrink: {shrink.from_devices} -> {shrink.to_devices} devices,"
        f" exact={shrink.exact}, fingerprints"
        f" match={shrink.fingerprints_match}"
    )
    assert shrink.exact and shrink.n_dead == 0

    # --- the alpha contract holds on the SURVIVING mass ----------------
    qs = [0.5, 0.99]
    got = host(dist.get_quantile_values(qs))
    print(f"{'stream':>6} {'p50':>8} {'exact':>8} {'p99':>8} {'exact':>8}")
    for i in (0, n_streams - 1):
        vals = np.asarray(kept[i], np.float64)
        e50 = np.quantile(vals, 0.5, method="lower")
        e99 = np.quantile(vals, 0.99, method="lower")
        print(
            f"{i:>6} {got[i, 0]:>8.2f} {e50:>8.2f} {got[i, 1]:>8.2f}"
            f" {e99:>8.2f}"
        )
        assert abs(got[i, 0] - e50) <= 0.0101 * e50
        assert abs(got[i, 1] - e99) <= 0.0101 * e99
    integrity.disarm()
    print(
        "elastic drill passed: exact mass accounting across"
        " kill/regrow/shrink, quantiles within the 1% contract"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
