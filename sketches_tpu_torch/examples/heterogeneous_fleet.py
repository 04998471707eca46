"""End-to-end example: a mesh-sharded fleet of wildly heterogeneous streams.

Scenario: one DistributedDDSketch tracks sensors whose scales span twelve
decades -- microsecond RPC latencies next to multi-hour batch jobs --
sharded over a (streams x values) device mesh.  Nothing is configured per
stream: the first batch auto-centers every stream's 512-bin window on its
own data (one broadcast recenter to every partial, preserving the
merge invariant), `maybe_recenter()` chases a mid-stream regime shift,
and the final states ship through the cross-language protobuf edge (the
message objects need ``google.protobuf``; without it the fleet ships as
the bulk codec's byte-identical wire bytes, and the output says so).

The mesh is 2 stream shards x 4 value shards over eight entries of
``--device`` (the card by default; the shards may share it):
    python -m sketches_tpu_torch.examples.heterogeneous_fleet [--device cpu]
"""

import sys

import numpy as np

from sketches_tpu_torch.batched import resolve_device
from sketches_tpu_torch.examples import host, parser, protobuf_available
from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh

N_STREAMS = 32
BATCH = 256  # rounded up to a multiple of the value-shard count in main()
QS = [0.5, 0.9, 0.99]
POOL = 8


def main(argv=None) -> int:
    device = resolve_device(parser(__doc__).parse_args(argv).device)
    devices = [device] * POOL
    n_dev = len(devices)
    # 2-D mesh when we have the devices for it; 1-D value sharding otherwise.
    if n_dev >= 4 and n_dev % 2 == 0:
        mesh = SketchMesh(n_dev, value_axis="values", stream_axis="streams",
                          stream_shards=2, devices=devices)
        shape = {"streams": 2, "values": n_dev // 2}
    else:
        mesh = SketchMesh(n_dev, value_axis="values", devices=devices)
        shape = {"values": n_dev}
    print(f"mesh: {shape}")

    # Default construction: no key_offset, no per-stream tuning.  Stream i
    # lives at scale 10**(i/2.6 - 6): twelve decades across the fleet,
    # every one of them far outside a default window centered on 1.0.
    fleet = DistributedDDSketch(
        N_STREAMS,
        mesh=mesh,
        value_axis="values",
        stream_axis="streams" if "streams" in shape else None,
        relative_accuracy=0.01,
        n_bins=512,
    )
    rng = np.random.RandomState(0)
    scales = 10.0 ** (np.arange(N_STREAMS) / 2.6 - 6.0)
    # Each add's batch width must divide across the value shards; round up
    # so the example runs on any device count (3, 6, 10, ...).
    nv = fleet.n_value_shards
    width = ((BATCH + nv - 1) // nv) * nv

    def batch():
        return (rng.lognormal(0.0, 0.25, (N_STREAMS, width))
                * scales[:, None]).astype(np.float32)

    history = [batch() for _ in range(3)]
    for b in history:
        fleet.add(b)  # first add auto-centers every stream

    got = host(fleet.get_quantile_values(QS))
    exact = np.concatenate(history, axis=1)
    worst = 0.0
    for j, q in enumerate(QS):
        e = np.quantile(exact, q, axis=1, method="lower")
        worst = max(worst, float(np.max(np.abs(got[:, j] - e) / np.abs(e))))
    print(f"12-decade fleet, default construction: worst rel err "
          f"{worst:.4f} (alpha contract: <= 0.0101)")
    assert worst <= 0.0101
    assert float(host(fleet.collapsed_fraction()).max()) == 0.0

    # Regime shift: half the fleet's sensors suddenly report 1e5x larger
    # values (a unit change).  Collapse counters notice; the policy arms;
    # the next batch re-centers exactly the drifting streams.
    scales[::2] *= 1e5
    fleet.add(batch())
    armed = fleet.maybe_recenter()
    print(f"after regime shift: maybe_recenter armed = {armed}")
    assert armed
    fleet.add(batch())  # armed streams recenter onto this batch
    fleet.add(batch())
    st = fleet.merged_state()
    coll_before = host(st.collapsed_low + st.collapsed_high).copy()
    fleet.add(batch())  # steady state in the new regime: no new collapse
    st = fleet.merged_state()
    coll_after = host(st.collapsed_low + st.collapsed_high)
    assert (coll_after == coll_before).all()
    print("post-recenter ingest collapses nothing")

    # Ship the fleet through the cross-language wire format (LOG mapping:
    # convention-free interop with the Go/Java/js/py DDSketch family).
    batched = fleet.to_batched()
    if protobuf_available():
        from sketches_tpu_torch.pb import batched_to_proto

        protos = batched_to_proto(batched.spec, batched.state)
        blob_bytes = sum(len(p.SerializeToString()) for p in protos)
        print(f"exported {len(protos)} wire-format sketches "
              f"({blob_bytes / 1024:.0f} KiB total)")
    else:
        from sketches_tpu_torch.pb import batched_to_bytes

        blobs = batched_to_bytes(batched.spec, batched.state)
        print(f"exported {len(blobs)} wire-format sketches "
              f"({sum(map(len, blobs)) / 1024:.0f} KiB total; bulk codec,"
              " protobuf not installed)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
