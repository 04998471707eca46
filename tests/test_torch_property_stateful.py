"""Stateful property tests: random op interleavings against the oracle and JAX.

The port's counterparts of ``tests/test_property_stateful.py``'s three
machines: hypothesis draws sequences of {add, merge, recenter,
recenter_to_data, maybe_recenter, checkpoint/restore} on the batched
facade and on ``DistributedDDSketch`` (restored onto the next of three
topologies), and of cross-tier merges, round trips and injected faults on
a one-stream master.  Each example makes two kinds of assertion:

(a) the JAX test's invariants on the port fed the raw batches: count
    parity, mass conservation, and the alpha contract (the cross-tier
    bound for the cross-tier machine) while no mass collapsed at a window
    edge, against the model of raw value lists;
(b) a second port facade and the JAX package's facade driven by the same
    ops on the batches moved to mid-bucket: the final states equal on every
    leaf but ``sum`` bit for bit (``sum`` within 1e-5 of the sum of |v|),
    every ``maybe_recenter`` decision equal, and the answers within rtol
    1e-6 of the JAX package's eager ``quantile`` of its final state.

Shapes are fixed, as in the JAX file.  Settings differ from it where the
budget asks: ``derandomize=True`` and no database (a steady example set),
and fewer examples (below), since every example builds fresh JAX facades
whose jitted ops compile again (about 2 s an example without JAX's
persistent compilation cache, which this module turns on).  Torch runs on
one intra-op thread here (``one_torch_thread``).
"""

import os
import tempfile

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from sketches_tpu import batched as jb
from sketches_tpu import checkpoint as jck
from sketches_tpu import parallel as jp
from sketches_tpu_torch import checkpoint as tck
from sketches_tpu_torch import faults
from sketches_tpu_torch.batched import BatchedDDSketch, SketchSpec
from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh
from sketches_tpu_torch.resilience import CheckpointCorrupt
from torch_property_common import (
    ALPHA,
    CROSS_ALPHA_BOUND,
    CROSS_OPS,
    N_BINS,
    N_STREAMS,
    OPS,
    QS,
    Model,
    assert_same_state,
    gen_values,
    mid_bucket,
    model_check,
    state_arrays,
    steady,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")


#: The JAX file's counts are 100, 100 and 40.
BATCHED_EXAMPLES = 15
DISTRIBUTED_EXAMPLES = 12
CROSS_EXAMPLES = 20

_batched_kwargs = dict(relative_accuracy=ALPHA, n_bins=N_BINS, mapping="logarithmic")
_dist_kwargs = dict(relative_accuracy=ALPHA, n_bins=N_BINS, mapping_name="logarithmic")


def _mid(batch):
    return mid_bucket(batch, np.float32)


def _jax_answers(spec, state):
    """The JAX package's eager full-window answers (no fused rank), on an
    unsharded host copy of its state (so the eager ops' compilations are
    shared by every example)."""
    state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)
    return np.asarray(jb.quantile(spec, state, jnp.asarray(QS, jnp.float32)))


def _assert_parity(port_state, port_answers, jax_spec, jax_state, scale):
    assert_same_state(port_state, jax_state, scale)
    np.testing.assert_allclose(
        np.asarray(port_answers), _jax_answers(jax_spec, jax_state), rtol=1e-6, equal_nan=True
    )


# ---------------------------------------------------------------------------
# Batched facade
# ---------------------------------------------------------------------------


@steady(BATCHED_EXAMPLES)
@given(OPS)
def test_stateful_batched_vs_oracle(ops):
    new = lambda: BatchedDDSketch(N_STREAMS, device="cpu", **_batched_kwargs)  # noqa: E731
    sk, mid_sk = new(), new()
    jsk = jb.BatchedDDSketch(N_STREAMS, **_batched_kwargs)
    model, scale = Model(), 0.0
    for op in ops:
        kind = op[0]
        if kind in ("add", "merge"):
            batch = gen_values(op[1], op[2] if kind == "add" else 1.0)
            mid = _mid(batch)
            scale += float(np.abs(mid).sum())
            model.add(batch)
            if kind == "add":
                sk.add(batch)
                mid_sk.add(mid)
                jsk.add(jnp.asarray(mid))
            else:
                sk.merge(new().add(batch))
                mid_sk.merge(new().add(mid))
                other = jb.BatchedDDSketch(N_STREAMS, **_batched_kwargs)
                other.add(jnp.asarray(mid))
                jsk.merge(other)
        elif kind == "recenter_shift":
            sk.recenter(sk.state.key_offset + op[1])
            mid_sk.recenter(mid_sk.state.key_offset + op[1])
            jsk.recenter(jsk.state.key_offset + jnp.int32(op[1]))
        elif kind == "recenter_data":
            sk.recenter_to_data()
            mid_sk.recenter_to_data()
            jsk.recenter_to_data()
        elif kind == "maybe_recenter":
            sk.maybe_recenter()
            assert mid_sk.maybe_recenter() == jsk.maybe_recenter()
        elif kind == "checkpoint":
            # Round trip through the array checkpoint (facade rebuild).
            with tempfile.TemporaryDirectory() as d:
                p = os.path.join(d, "ck.npz")
                tck.save(p, sk)
                sk = tck.restore(p, device="cpu")
                tck.save(p, mid_sk)
                mid_sk = tck.restore(p, device="cpu")
                jck.save(p, jsk)
                jsk = jck.restore(p)
    model_check(model, sk.state, sk.get_quantile_values)
    jax.block_until_ready(jsk.state)
    _assert_parity(mid_sk.state, mid_sk.get_quantile_values(list(QS)), jsk.spec, jsk.state,
                   scale)


# ---------------------------------------------------------------------------
# Distributed facade, with topology-changing restores
# ---------------------------------------------------------------------------


def _meshes():
    """(port mesh, JAX mesh, JAX value axis, JAX stream axis): 2 value x 2
    stream shards, 4 value shards, 2 value x 4 stream shards."""
    devs = np.asarray(jax.devices())
    cpu = ["cpu"] * 8
    return [
        (SketchMesh(4, devices=cpu[:4], stream_axis="streams", stream_shards=2),
         Mesh(devs[:4].reshape(2, 2), ("values", "streams")), "values", "streams"),
        (SketchMesh(4, devices=cpu[:4]), Mesh(devs[:4].reshape(4), ("values",)), "values", None),
        (SketchMesh(8, devices=cpu, stream_axis="streams", stream_shards=4),
         Mesh(devs.reshape(2, 4), ("values", "streams")), "values", "streams"),
    ]


def _jax_dist(mesh, va, sa):
    return jp.DistributedDDSketch(N_STREAMS, mesh=mesh, value_axis=va, stream_axis=sa,
                                  **_dist_kwargs)


@steady(DISTRIBUTED_EXAMPLES)
@given(OPS)
def test_stateful_distributed_vs_oracle(ops):
    meshes = _meshes()
    mi = 0
    tmesh, jmesh, va, sa = meshes[mi]
    new = lambda m: DistributedDDSketch(N_STREAMS, mesh=m, **_dist_kwargs)  # noqa: E731
    sk, mid_sk, jsk = new(tmesh), new(tmesh), _jax_dist(jmesh, va, sa)
    model, scale = Model(), 0.0
    for op in ops:
        kind = op[0]
        if kind in ("add", "merge"):
            batch = gen_values(op[1], op[2] if kind == "add" else 1.0)
            mid = _mid(batch)
            scale += float(np.abs(mid).sum())
            model.add(batch)
            if kind == "add":
                sk.add(batch)
                mid_sk.add(mid)
                jsk.add(jnp.asarray(mid))
            else:
                sk.merge(new(sk.mesh).add(batch))
                mid_sk.merge(new(mid_sk.mesh).add(mid))
                jsk.merge(_jax_dist(jsk.mesh, jsk.value_axis, jsk.stream_axis)
                          .add(jnp.asarray(mid)))
        elif kind == "recenter_shift":
            sk.recenter(sk.merged_state().key_offset + op[1])
            mid_sk.recenter(mid_sk.merged_state().key_offset + op[1])
            jsk.recenter(jsk.merged_state().key_offset + jnp.int32(op[1]))
        elif kind == "recenter_data":
            sk.recenter_to_data()
            mid_sk.recenter_to_data()
            jsk.recenter_to_data()
        elif kind == "maybe_recenter":
            sk.maybe_recenter()
            assert mid_sk.maybe_recenter() == jsk.maybe_recenter()
        elif kind == "checkpoint":
            # Restore onto the next topology: the checkpoint carries no mesh,
            # so resuming must reproduce the folded state on another layout.
            mi = (mi + 1) % len(meshes)
            tmesh, jmesh, va, sa = meshes[mi]
            with tempfile.TemporaryDirectory() as d:
                p = os.path.join(d, "ck.npz")
                tck.save(p, sk)
                sk = tck.restore_distributed(p, mesh=tmesh)
                tck.save(p, mid_sk)
                mid_sk = tck.restore_distributed(p, mesh=tmesh)
                jck.save(p, jsk)
                jsk = jck.restore_distributed(p, mesh=jmesh, value_axis=va, stream_axis=sa)
    model_check(model, sk.merged_state(), sk.get_quantile_values)
    jax.block_until_ready(jsk.partials)
    _assert_parity(mid_sk.merged_state(), mid_sk.get_quantile_values(list(QS)), jsk.spec,
                   jsk.merged_state(), scale)


# ---------------------------------------------------------------------------
# Cross-tier machine: {host DDSketch, TorchDDSketch, NativeDDSketch,
# BatchedDDSketch} with cross-tier merges, wire / proto / host-object /
# native round trips of the master, and injected faults that must leave it
# untouched.  The JAX package's master walks the same ops with its own
# tiers (``JaxDDSketch`` where the port has ``TorchDDSketch``).
# ---------------------------------------------------------------------------


def _cross_tiers():
    """The source and round-trip tiers; native only where both packages'
    engines load (so both walk the same tier list)."""
    from sketches_tpu import native as jnative
    from sketches_tpu_torch import native as tnative

    tiers = ["host", "device", "wire", "proto"]
    if tnative.available() and jnative.available():
        tiers.append("native")
    return tiers


def _port_tier_state(spec, tier, batch1d):
    from sketches_tpu_torch import native
    from sketches_tpu_torch.batched import from_host_sketches
    from sketches_tpu_torch.ddsketch import DDSketch, TorchDDSketch

    if tier == "host":
        sk = DDSketch(ALPHA)
        for v in batch1d:
            sk.add(float(v))
        return from_host_sketches(spec, [sk], device="cpu")
    if tier == "device":
        sk = TorchDDSketch(relative_accuracy=ALPHA, n_bins=N_BINS, device="cpu")
        sk.add_many(batch1d.astype(np.float64))
        return from_host_sketches(spec, [sk], device="cpu")
    assert tier == "native", tier
    sk = native.NativeDDSketch(ALPHA, n_bins=N_BINS)
    sk.add_batch(batch1d.astype(np.float64))
    return sk.to_state(device="cpu")


def _jax_tier_state(spec, tier, batch1d):
    from sketches_tpu import native
    from sketches_tpu.batched import from_host_sketches
    from sketches_tpu.ddsketch import DDSketch, JaxDDSketch

    if tier == "host":
        sk = DDSketch(ALPHA)
        for v in batch1d:
            sk.add(float(v))
        return from_host_sketches(spec, [sk])
    if tier == "device":
        sk = JaxDDSketch(relative_accuracy=ALPHA, n_bins=N_BINS)
        sk.add_many(batch1d.astype(np.float64))
        return from_host_sketches(spec, [sk])
    assert tier == "native", tier
    sk = native.NativeDDSketch(ALPHA, n_bins=N_BINS)
    sk.add_batch(batch1d.astype(np.float64))
    return sk.to_state()


def _port_roundtrip(spec, master, which):
    from sketches_tpu_torch import native
    from sketches_tpu_torch.batched import from_host_sketches, to_host_sketches
    from sketches_tpu_torch.pb import wire
    from sketches_tpu_torch.pb.proto import DDSketchProto, messages

    if which == "wire":
        state = wire.bytes_to_state(spec, wire.state_to_bytes(spec, master.state), device="cpu")
    elif which == "proto":
        host = to_host_sketches(spec, master.state)[0]
        blob = DDSketchProto.to_proto(host).SerializeToString()
        back = DDSketchProto.from_proto(messages().DDSketch.FromString(blob))
        state = from_host_sketches(spec, [back], device="cpu")
    elif which == "native":
        state = native.NativeDDSketch.from_state(spec, master.state, 0).to_state(device="cpu")
    else:  # host-sketch object round trip
        state = from_host_sketches(spec, to_host_sketches(spec, master.state), device="cpu")
    return BatchedDDSketch(1, spec=spec, state=state, device="cpu")


def _jax_roundtrip(spec, master, which):
    from sketches_tpu import native
    from sketches_tpu.batched import BatchedDDSketch as JBatched
    from sketches_tpu.batched import from_host_sketches, to_host_sketches
    from sketches_tpu.pb import ddsketch_pb2 as pb2
    from sketches_tpu.pb import wire
    from sketches_tpu.pb.proto import DDSketchProto

    if which == "wire":
        state = wire.bytes_to_state(spec, wire.state_to_bytes(spec, master.state))
    elif which == "proto":
        host = to_host_sketches(spec, master.state)[0]
        blob = DDSketchProto.to_proto(host).SerializeToString()
        state = from_host_sketches(spec, [DDSketchProto.from_proto(pb2.DDSketch.FromString(blob))])
    elif which == "native":
        state = native.NativeDDSketch.from_state(spec, master.state, 0).to_state()
    else:
        state = from_host_sketches(spec, to_host_sketches(spec, master.state))
    return JBatched(1, spec=spec, state=state)


def _wire_fault(spec, master):
    """Quarantine decode of a corrupted copy: the corruption is detected
    (structured reason) and the master is untouched."""
    from sketches_tpu_torch.pb import wire

    blobs = wire.state_to_bytes(spec, master.state)
    bad, idx = faults.corrupt_blobs(blobs, 1.0, seed=5)
    assert idx == [0]
    _, report = wire.bytes_to_state(spec, bad, errors="quarantine", device="cpu")
    assert report.indices == [0]


def _ckpt_fault(master):
    """A torn checkpoint write surfaces as ``CheckpointCorrupt`` on
    restore; the in-memory master keeps serving."""
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ck.npz")
        with faults.active({faults.CHECKPOINT_WRITE: dict(mode="truncate")}):
            tck.save(p, master)
        with pytest.raises(CheckpointCorrupt):
            tck.restore(p, device="cpu")


def _cross_check(master, values):
    a = state_arrays(master.state)
    count, zero = float(a["count"][0]), float(a["zero_count"][0])
    mass = float(a["bins_pos"].sum() + a["bins_neg"].sum())
    assert count == pytest.approx(len(values))
    assert mass + zero == pytest.approx(count)
    got = master.get_quantile_values(list(QS)).numpy()
    if not values:
        assert np.isnan(got).all()
        return
    if float((a["collapsed_low"] + a["collapsed_high"]).sum()) > 0:
        return  # resolution legitimately lost at a window edge
    svals = sorted(values)
    for j, q in enumerate(QS):
        exact = svals[int(q * (len(svals) - 1))]
        assert abs(got[0, j] - exact) <= CROSS_ALPHA_BOUND * abs(exact) + 1e-9, (q, exact, got)


@steady(CROSS_EXAMPLES)
@given(CROSS_OPS)
def test_stateful_cross_tier_vs_oracle(ops):
    from sketches_tpu import faults as jfaults
    from sketches_tpu.batched import BatchedDDSketch as JBatched

    faults.disarm()
    jfaults.disarm()
    spec = SketchSpec(relative_accuracy=ALPHA, mapping_name="logarithmic", n_bins=N_BINS)
    jspec = jb.SketchSpec(relative_accuracy=ALPHA, mapping_name="logarithmic", n_bins=N_BINS)
    master = BatchedDDSketch(1, spec=spec, device="cpu")
    mid_master = BatchedDDSketch(1, spec=spec, device="cpu")
    jmaster = JBatched(1, spec=jspec)
    tiers = _cross_tiers()
    src_tiers = [t for t in tiers if t in ("host", "device", "native")]
    values: list = []
    scale = 0.0
    for op in ops:
        kind = op[0]
        if kind in ("add", "merge_tier"):
            batch = gen_values(op[1] if kind == "add" else op[2],
                               op[2] if kind == "add" else 1.0)[0]
            mid = _mid(batch)
            scale += float(np.abs(mid).sum())
            values.extend(float(x) for x in batch)
            if kind == "add":
                master.add(torch.from_numpy(batch[None, :]))
                mid_master.add(torch.from_numpy(mid[None, :]))
                jmaster.add(jnp.asarray(mid[None, :]))
            else:
                tier = src_tiers[op[1] % len(src_tiers)]
                for m, b in ((master, batch), (mid_master, mid)):
                    m.merge(BatchedDDSketch(1, spec=spec, device="cpu",
                                            state=_port_tier_state(spec, tier, b)))
                jmaster.merge(JBatched(1, spec=jspec, state=_jax_tier_state(jspec, tier, mid)))
        elif kind == "roundtrip":
            rt = ["wire", "proto", "hostobj", "native"][op[1] % 4]
            if rt == "native" and "native" not in tiers:
                rt = "hostobj"
            master = _port_roundtrip(spec, master, rt)
            mid_master = _port_roundtrip(spec, mid_master, rt)
            jmaster = _jax_roundtrip(jspec, jmaster, rt)
        elif kind == "wire_fault":
            _wire_fault(spec, master)
        elif kind == "ckpt_fault":
            _ckpt_fault(master)
    _cross_check(master, values)
    jax.block_until_ready(jmaster.state)
    _assert_parity(mid_master.state, mid_master.get_quantile_values(list(QS)), jspec,
                   jmaster.state, scale)
