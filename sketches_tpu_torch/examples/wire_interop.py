"""End-to-end example: the cross-language wire edge at device-batch scale.

Scenario: a fleet of collector agents (any DDSketch implementation -- Go,
Java, Python, this library's host or native tier) ships sketches as
protobuf wire bytes; a device-side aggregator decodes whole batches into
one ``[n_streams, n_bins]`` device state, merges them, answers fleet-wide
quantiles, and re-exports bytes any family implementation can read.

The bulk codec (``batched_to_bytes`` / ``batched_from_bytes``) is the
fast path: vectorized numpy in/out, byte-identical to the per-sketch
object bridge (``DDSketchProto``).  The object-bridge step needs
``google.protobuf``; where it does not import, the single-sketch consumer
decodes the blob with the bulk codec instead, and the output says which
path ran.

Runs on the card (``--device cpu`` for the CPU):
    python -m sketches_tpu_torch.examples.wire_interop
"""

import sys

import numpy as np

from sketches_tpu_torch import BatchedDDSketch
from sketches_tpu_torch.batched import resolve_device
from sketches_tpu_torch.examples import host, parser, protobuf_available
from sketches_tpu_torch.pb import batched_from_bytes, batched_to_bytes

N_STREAMS = 4096
QS = [0.5, 0.9, 0.99]


def main(argv=None) -> int:
    device = resolve_device(parser(__doc__).parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- the "collector fleet": one device batch standing in for many
    # agents, exported to wire bytes -------------------------------------
    fleet = BatchedDDSketch(N_STREAMS, relative_accuracy=0.01, n_bins=512, device=device)
    # sigma kept moderate so every key lands inside the aggregator's
    # default window (decode renormalizes onto the spec window; keys past
    # its edge would clamp -- collapse semantics, surfaced in the
    # collapse counters, but this example wants exact byte round trips).
    latencies = rng.lognormal(np.log(10), 0.4, (N_STREAMS, 2048)).astype(
        np.float32
    )
    fleet.add(latencies)
    blobs = batched_to_bytes(fleet.spec, fleet.state)
    print(
        f"exported {len(blobs)} sketches, "
        f"{sum(map(len, blobs)) / 1e6:.1f} MB of wire bytes"
    )

    # --- one sketch of that batch read back by a SINGLE-sketch consumer
    # (any family implementation; here the reference-shaped host tier) ----
    if protobuf_available():
        from sketches_tpu_torch.pb import DDSketchProto
        from sketches_tpu_torch.pb import ddsketch_pb2 as pb

        solo = DDSketchProto.from_proto(pb.DDSketch.FromString(blobs[7]))
        print(
            "stream 7 via the object bridge: "
            f"p99 = {solo.get_quantile_value(0.99):.2f} ms"
        )
    else:
        one = BatchedDDSketch(
            1, spec=fleet.spec,
            state=batched_from_bytes(fleet.spec, [blobs[7]], device=device),
            device=device,
        )
        print(
            "stream 7 via the bulk codec (protobuf not installed, object"
            f" bridge skipped): p99 = {float(host(one.get_quantile_values([0.99]))[0, 0]):.2f} ms"
        )

    # --- the aggregator: decode the whole fleet into a fresh device batch
    # and answer every stream's quantiles in one fused query --------------
    agg = BatchedDDSketch(
        N_STREAMS, spec=fleet.spec,
        state=batched_from_bytes(fleet.spec, blobs, device=device), device=device,
    )
    got = host(agg.get_quantile_values(QS))
    exact = np.quantile(latencies, QS[-1], axis=1, method="lower")
    err = np.abs(got[:, -1] - exact) / exact
    print(
        f"fleet p99 decoded on-device: max relative error vs exact "
        f"{err.max():.4f} (alpha contract: <= 0.0101)"
    )
    assert (err <= 0.0101 + 1e-6).all()

    # --- round trip: aggregator re-exports; bytes are byte-identical ----
    blobs2 = batched_to_bytes(agg.spec, agg.state)
    same = sum(a == b for a, b in zip(blobs, blobs2))
    print(f"re-export: {same}/{len(blobs)} blobs byte-identical")
    assert same == len(blobs), "bulk codec round trip drifted"
    return 0


if __name__ == "__main__":
    sys.exit(main())
