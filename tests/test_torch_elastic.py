"""The port's elastic seams (``DistributedDDSketch.reshard`` and
``merge_partial``, ``fold_hosts`` of the dense and moment backends) under the
armed mesh faults, against the JAX package's, on the CPU.

Both packages ingest the same mid-bucket unit-weight batches (the port on
``["cpu"] * k`` meshes, the JAX package on ``k`` of the virtual CPU devices,
``engine="xla"`` against the port's ``engine="plain"``), so every partial
count is an integer and every comparison is **exact**: the reports'
itemized dropped and surviving mass, the regrown fold, the fingerprints
across the boundary (the same leaves, the same numpy sums), the ledger
steps and counters.  Answers of the regrown fleet compare **exactly** with
the port's own fold of the survivors.
"""

import jax
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import faults as jf
from sketches_tpu import integrity as ji
from sketches_tpu import parallel as jp
from sketches_tpu import resilience as jr
from sketches_tpu.backends import moment as JM
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.backends import moment as TM
from torch_robust_common import ALPHA, QS, mixed_batches, reset_both, steps
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

N = 64


@pytest.fixture(autouse=True)
def _clean():
    reset_both()
    yield
    reset_both()


def _fleets(k=4, n_hosts=None, seed=0):
    jm = jp.SketchMesh(k, devices=jax.devices()[:k], n_hosts=n_hosts)
    j = jp.DistributedDDSketch(N, mesh=jm, value_axis=jm.value_axis, stream_axis=jm.stream_axis,
                               relative_accuracy=ALPHA, n_bins=512, engine="xla")
    t = tp.DistributedDDSketch(N, mesh=tp.SketchMesh(k, devices=["cpu"] * k, n_hosts=n_hosts),
                               relative_accuracy=ALPHA, n_bins=512, engine="plain")
    for v in mixed_batches(N, 128 * k, seed=seed):
        jax.block_until_ready(j.add(v).partials)
        t.add(v)
    return j, t


def _counts(partials):
    return np.asarray(partials.count, np.float64) if not isinstance(
        partials.count, torch.Tensor) else partials.count.double().numpy()


def _armed_both(site, **plan):
    for f in (jf, tf):
        f.arm(getattr(f, site), **plan)


@pytest.mark.parametrize("armed_integrity", [False, True])
@pytest.mark.parametrize("dead", [(1,), (0, 2), (3,)])
def test_kill_and_regrow_itemizes_dropped_mass(dead, armed_integrity):
    j, t = _fleets(seed=len(dead))
    part = _counts(t.partials)
    np.testing.assert_array_equal(part, _counts(j.partials))
    if armed_integrity:
        ji.arm("raise")
        ti.arm("raise")
    _armed_both("MESH_SHARD", shards=dead)
    jnew, jrep = j.reshard(n_devices=2)
    new, rep = t.reshard(n_devices=2)
    reset_both()
    assert rep.dead_shards == jrep.dead_shards == sorted(dead)
    assert (rep.from_devices, rep.to_devices) == (jrep.from_devices, jrep.to_devices) == (4, 2)
    np.testing.assert_array_equal(rep.dropped_count, part[list(dead)].sum(0))
    np.testing.assert_array_equal(rep.dropped_count, jrep.dropped_count)
    np.testing.assert_array_equal(rep.surviving_count, jrep.surviving_count)
    assert rep.exact and jrep.exact and rep.lost_hosts == ()
    np.testing.assert_array_equal(new.merged_state().count.double().numpy(), rep.surviving_count)
    for f in tb.LEAVES:
        if f != "sum":
            np.testing.assert_array_equal(getattr(new.merged_state(), f).numpy(),
                                          np.asarray(getattr(jnew.merged_state(), f)), err_msg=f)
    if armed_integrity:
        assert rep.fingerprints_match is jrep.fingerprints_match is True
        for mine, theirs in ((rep.fingerprint_pre, jrep.fingerprint_pre),
                             (rep.fingerprint_post, jrep.fingerprint_post)):
            np.testing.assert_array_equal(mine.view(np.uint64), theirs.view(np.uint64))
    else:
        assert rep.fingerprints_match is None and rep.fingerprint_pre is None
    # The regrown fleet answers as the survivors' fold does.
    live = np.ones(4, bool)
    live[list(dead)] = False
    survivors = tp.fold_live_partials(t.spec, t.partials, live)
    want = tb.quantile(t.spec, survivors, torch.tensor(QS))
    torch.testing.assert_close(new.get_quantile_values_resolved(
        QS, disabled_tiers=("windowed", "wxla"))[1], want, rtol=0, atol=0, equal_nan=True)


def test_reshard_ledger_matches_jax():
    j, t = _fleets(seed=7)
    out = {}
    for f, res, sk in ((jf, jr, j), (tf, tr, t)):
        f.arm(f.MESH_SHARD, shards=(2,))
        sk.reshard(n_devices=2)
        f.disarm()
        sk.reshard(n_devices=4)  # a clean reshard: counted, nothing recorded
        out[f] = res.health()
    assert steps(out[tf]) == steps(out[jf]) == [
        ("distributed.mesh", "4 value shards", "3 value shards")]
    assert out[tf]["counters"] == out[jf]["counters"]
    assert out[tf]["counters"]["elastic.reshards"] == 2


def test_host_loss_kills_its_group():
    j, t = _fleets(n_hosts=2, seed=8)
    part = _counts(t.partials)
    _armed_both("MESH_HOST_LOSS", shards=(1,))
    jnew, jrep = j.reshard(n_devices=2)
    new, rep = t.reshard(n_devices=2)
    assert rep.lost_hosts == jrep.lost_hosts == (1,)
    assert rep.dead_shards == jrep.dead_shards == [2, 3]
    np.testing.assert_array_equal(rep.dropped_count, part[[2, 3]].sum(0))
    np.testing.assert_array_equal(rep.dropped_count, jrep.dropped_count)
    assert rep.exact and new.mesh.n_devices == 2
    assert tr.health()["counters"] == jr.health()["counters"]
    assert tr.health()["counters"]["mesh.host_losses"] == 1


def test_host_loss_and_dead_shard_combine():
    _, t = _fleets(n_hosts=2, seed=9)
    tf.arm(tf.MESH_HOST_LOSS, shards=(0,))
    tf.arm(tf.MESH_SHARD, shards=(3,))
    _, rep = t.reshard(n_devices=1, live_mask=[True, True, True, True])
    assert rep.dead_shards == [0, 1, 3] and rep.lost_hosts == (0,)


def test_torn_reshard_is_atomic():
    _, t = _fleets(seed=10)
    ti.arm("raise")
    before_fp = ti.fingerprint(t.spec, t.merged_state())
    before_parts = {f: getattr(t.partials, f).clone() for f in tb.LEAVES}
    tier0, before_q = t.get_quantile_values_resolved(QS)
    tf.arm(tf.RESHARD_TORN, times=1)
    with pytest.raises(tr.InjectedFault, match="reshard.torn"):
        t.reshard(n_devices=2)
    assert tr.health()["downgrades"] == []
    np.testing.assert_array_equal(ti.fingerprint(t.spec, t.merged_state()).view(np.uint64),
                                  before_fp.view(np.uint64))
    for f, x in before_parts.items():
        assert torch.equal(getattr(t.partials, f), x), f
    tier1, after_q = t.get_quantile_values_resolved(QS)
    assert tier1 == tier0
    torch.testing.assert_close(after_q, before_q, rtol=0, atol=0, equal_nan=True)
    new, rep = t.reshard(n_devices=2)  # the fault was capped: now it goes through
    assert rep.exact and rep.fingerprints_match


@pytest.mark.parametrize("how", ["mask", "shards", "hosts"])
def test_all_dead_raises_and_changes_nothing(how):
    _, t = _fleets(n_hosts=2, seed=11)
    kw = {}
    if how == "mask":
        kw["live_mask"] = [False] * 4
    elif how == "shards":
        tf.arm(tf.MESH_SHARD, shards=(0, 1, 2, 3))
    else:
        tf.arm(tf.MESH_HOST_LOSS, shards=(0, 1))
    before = t.merged_state().count.clone()
    with pytest.raises(tr.ShardLossError):
        t.reshard(n_devices=2, **kw)
    if how == "shards":
        with pytest.raises(tr.ShardLossError):
            t.merge_partial()
    assert torch.equal(t.merged_state().count, before)
    assert tr.health()["downgrades"] == []


def test_elastic_kill_switch(monkeypatch):
    _, t = _fleets(seed=12)
    monkeypatch.setenv(registry.ELASTIC.name, "0")
    with pytest.raises(tr.SpecError, match="SKETCHES_TPU_ELASTIC"):
        t.reshard(n_devices=2)


def _host_states(seed, n_hosts=3):
    out = []
    for h in range(n_hosts):
        j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="xla")
        t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                               engine="plain")
        for v in mixed_batches(N, 128, seed=seed + h):
            jax.block_until_ready(j.add(v).state)
            t.add(v)
        out.append((j, t))
    return out


@pytest.mark.parametrize("armed_integrity", [False, True])
def test_fold_hosts_partition_is_detected_and_accounted(armed_integrity):
    hosts = _host_states(13)
    if armed_integrity:
        ji.arm("raise")
        ti.arm("raise")
    _armed_both("DCN_PARTITION", shards=(1,))
    jfold, jrep = jp.fold_hosts(hosts[0][0].spec, [j.state for j, _ in hosts])
    fold, rep = tp.fold_hosts(hosts[0][1].spec, [t.state for _, t in hosts])
    assert rep.dead_shards == jrep.dead_shards == [1]
    np.testing.assert_array_equal(rep.dropped_count, hosts[1][1].state.count.double().numpy())
    np.testing.assert_array_equal(rep.dropped_count, jrep.dropped_count)
    np.testing.assert_array_equal(rep.surviving_count, jrep.surviving_count)
    for f in tb.LEAVES:
        if f != "sum":
            np.testing.assert_array_equal(getattr(fold, f).numpy(),
                                          np.asarray(getattr(jfold, f)), err_msg=f)
    assert steps(tr.health()) == steps(jr.health()) == [("distributed.dcn", "3 hosts", "2 hosts")]
    assert tr.health()["counters"] == jr.health()["counters"]
    assert tr.health()["counters"]["dcn.partitions"] == 1
    reset_both()
    # An explicit mask is accounted the same way; none reachable raises.
    _, rep2 = tp.fold_hosts(hosts[0][1].spec, [t.state for _, t in hosts],
                            reachable=[True, False, True])
    np.testing.assert_array_equal(rep2.dropped_count, rep.dropped_count)
    tf.arm(tf.DCN_PARTITION, shards=(0, 1, 2))
    with pytest.raises(tr.ShardLossError, match="across DCN"):
        tp.fold_hosts(hosts[0][1].spec, [t.state for _, t in hosts])


def test_moment_fold_hosts_partition_matches_jax():
    import jax.numpy as jnp

    kw = dict(relative_accuracy=ALPHA, backend="moment", n_moments=6)
    jspec, tspec = jb.SketchSpec(**kw), tb.SketchSpec(**kw)
    jstates, tstates = [], []
    for h in range(3):
        v = mixed_batches(16, 64, seed=20 + h)[0]
        jst = JM.add(jspec, JM.init(jspec, 16), jnp.asarray(v))
        jstates.append(jax.block_until_ready(jst))
        tstates.append(TM.add(tspec, TM.init(tspec, 16, "cpu"), torch.from_numpy(v)))
    _armed_both("DCN_PARTITION", shards=(2,))
    jfold, jrep = JM.fold_hosts(jspec, jstates)
    fold, rep = TM.fold_hosts(tspec, tstates)
    assert rep.dead_shards == jrep.dead_shards == [2]
    np.testing.assert_array_equal(rep.dropped_count, jrep.dropped_count)
    np.testing.assert_array_equal(rep.dropped_count, tstates[2].count.double().numpy())
    np.testing.assert_array_equal(fold.count.numpy(), np.asarray(jfold.count))
    assert tr.health()["counters"] == jr.health()["counters"] == {
        "faults.dcn.partition": 1, "dcn.partitions": 1}
