"""The port's resilience layer (``sketches_tpu_torch.resilience``) and the
seams that record into it, against the JAX package's, on the CPU.

* The taxonomy, the health ledger and ``demote_query_tier`` compare
  exactly (names, method resolution orders, fields, tier rules).
* The query ladders: the port's facades (``device="cpu"``: each kernel's
  plain version) and the JAX facades (``engine="pallas"``, kernels in
  interpret mode) walk the same tiers under the same armed plans and
  record the same ``(component, from, to)`` steps.  Answers: **rtol 1e-6**
  against the JAX facade on mid-bucket data (the same bucket; ``exp`` may
  differ by an ulp between XLA:CPU and torch), **exact** against the
  port's own plain facade.
* Ingest demotion: the port's tier labels are its engine names
  (``kernel -> plain``), which stand for JAX's ``pallas -> xla``
  (``INGEST_LABELS``); every other label, component and site is JAX's.
  The replayed state equals the plain twin exactly on every leaf but
  ``sum`` (**atol 1e-5 * sum|v|**: f32 sums in another order).
* Quarantine decode of 10,000 blobs with 1% corrupt: the same indices,
  reason counters and health counters as the JAX package, and the same
  decoded state, exactly.

JAX results are waited for before the port's side runs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import faults as jf
from sketches_tpu import parallel as jp
from sketches_tpu import resilience as jr
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import kernels as tk
from sketches_tpu_torch import native as tn
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch import resilience as tr
from torch_robust_common import ALPHA, INGEST_LABELS, QS, mixed_batches, reset_both, steps
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

N = 256
FLOOR_PLAN = {"tier": ("overlap", "tiles", "windowed", "wxla")}


@pytest.fixture(autouse=True)
def _clean():
    reset_both()
    yield
    reset_both()


# ---------------------------------------------------------------------------
# Taxonomy and ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jr.__all__)
def test_taxonomy_matches_jax(name):
    j, t = getattr(jr, name), getattr(tr, name)
    if isinstance(j, type):
        assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in j.__mro__]
        if dataclasses.is_dataclass(j):
            assert [f.name for f in dataclasses.fields(t)] == [
                f.name for f in dataclasses.fields(j)
            ]
            assert getattr(t, "__dataclass_params__").frozen == j.__dataclass_params__.frozen
        props = sorted(k for k, v in vars(j).items() if isinstance(v, property))
        assert props == sorted(k for k, v in vars(t).items() if isinstance(v, property))
    else:
        assert callable(t) == callable(j)
        if not callable(j):
            assert t == j


def test_error_fields():
    e = tr.IntegrityError("bad", report="r")
    assert (str(e), e.report) == ("bad", "r") and not isinstance(e, ValueError)
    for cls in (tr.ServeOverload, tr.ReplicaStale):
        e = cls("m", reason="why", tenant="web")
        assert (e.reason, e.tenant) == ("why", "web")
    assert isinstance(tr.EngineUnavailable("x"), RuntimeError)


def _strip_time(h):
    return {**h, "downgrades": [{k: v for k, v in e.items() if k != "time"}
                                for e in h["downgrades"]]}


def test_ledger_ring_bound_matches_jax(monkeypatch):
    for res in (jr, tr):
        monkeypatch.setattr(res, "_MAX_EVENTS", 3)
        for i in range(5):
            res.record_downgrade(f"c{i % 2}", "a", f"b{i}", "x" * 600)
        res.bump("wire.quarantined", 2)
        res.bump("wire.quarantined")
    t, j = tr.health(), jr.health()
    assert _strip_time(t) == _strip_time(j)
    assert t["downgrades_dropped"] == 2 and len(t["downgrades"]) == 3
    assert t["tiers"] == {"c0": "b4", "c1": "b3"}
    assert t["counters"] == {"downgrades": 5, "wire.quarantined": 3}
    assert len(t["downgrades"][0]["reason"]) == 500
    assert all(isinstance(e["time"], float) and e["time"] > 0 for e in t["downgrades"])


def test_health_is_a_snapshot():
    tr.record_downgrade("batched.query", "overlap", "tiles", "r")
    h = tr.health()
    h["downgrades"][0]["component"] = "x"
    h["tiers"].clear()
    h["counters"]["downgrades"] = 99
    assert tr.health()["downgrades"][0]["component"] == "batched.query"
    assert tr.health()["tiers"] == {"batched.query": "tiles"}
    assert tr.health()["counters"] == {"downgrades": 1}
    tr.reset()
    assert tr.health() == {"tiers": {}, "counters": {}, "downgrades": [],
                           "downgrades_dropped": 0}


@pytest.mark.parametrize("start", [(), ("overlap",), ("wxla",), ("overlap", "tiles")])
@pytest.mark.parametrize("tier", list(jr.QUERY_LADDER) + ["moment", "bogus"])
def test_demote_query_tier_matches_jax(start, tier):
    assert tr.QUERY_LADDER == jr.QUERY_LADDER
    a, b = set(start), set(start)
    assert tr.demote_query_tier(a, tier) == jr.demote_query_tier(b, tier)
    assert a == b


# ---------------------------------------------------------------------------
# Query ladders
# ---------------------------------------------------------------------------


def _batched_pair():
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    plain = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                               engine="plain")
    for v in mixed_batches(N, 128, seed=3):
        jax.block_until_ready(j.add(v).state)
        t.add(v)
        plain.add(v)
    return j, t, plain


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("exc", [tr.InjectedFault("armed"), RuntimeError("launch failed")])
def test_demote_query_on_the_card_survives_only_injected_faults(on_card, exc):
    """Off the card any failure steps down, as in the JAX package; on the
    card only an armed site's ``InjectedFault`` does, and a real kernel
    error is left to raise with nothing disabled or recorded."""
    want = not on_card or isinstance(exc, tr.InjectedFault)
    disabled: set = set()
    assert tr.survivable(exc, on_card) == want
    assert tr.demote_query("batched", disabled, "overlap", exc, on_card) == want
    assert disabled == ({"overlap"} if want else set())
    assert steps(tr.health()) == ([("batched.query", "overlap", "tiles")] if want else [])
    assert not tr.demote_query("batched", set(), "xla", exc, on_card)


@pytest.mark.parametrize("plan, want", [
    (dict(tier="overlap", times=1), "tiles"),
    (FLOOR_PLAN, "xla"),
])
def test_batched_ladder_matches_jax(plan, want):
    j, t, plain = _batched_pair()
    for f, res in ((jf, jr), (tf, tr)):
        f.arm(f.PALLAS_LOWERING, **plan)
    jtier, jv = j.get_quantile_values_resolved(QS)
    jv = np.asarray(jax.block_until_ready(jv))
    jsteps = steps(jr.health())
    ttier, tv = t.get_quantile_values_resolved(QS)
    assert ttier == jtier == want
    assert steps(tr.health()) == jsteps
    assert jsteps[0] == ("batched.query", "overlap", "tiles") and jsteps[-1][2] == want
    assert t._query_disabled == j._query_disabled
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, equal_nan=True)
    _, pv = plain.get_quantile_values_resolved(QS)
    torch.testing.assert_close(tv, pv, rtol=0, atol=0, equal_nan=True)
    # Demotions persist once the fault is gone; the floor re-raises.
    reset_both()
    assert t.get_quantile_values_resolved(QS)[0] == want
    assert t.copy()._query_disabled == t._query_disabled
    tf.arm(tf.PALLAS_LOWERING)
    with pytest.raises(tr.InjectedFault):
        t.get_quantile_values(QS)
    assert t._query_disabled == {"overlap", "tiles", "windowed", "wxla"}


@pytest.mark.parametrize("plan, want", [
    (dict(tier="overlap", times=1), "tiles"),
    (FLOOR_PLAN, "xla"),
])
def test_distributed_ladder_matches_jax(plan, want):
    jd = jax.devices()[:2]
    jm = jp.SketchMesh(2, devices=jd)
    j = jp.DistributedDDSketch(N, mesh=jm, value_axis=jm.value_axis, stream_axis=jm.stream_axis,
                               relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tp.DistributedDDSketch(N, mesh=tp.SketchMesh(2, devices=["cpu"] * 2),
                               relative_accuracy=ALPHA, n_bins=512)
    for v in mixed_batches(N, 256, seed=5):
        jax.block_until_ready(j.add(v).partials)
        t.add(v)
    for f in (jf, tf):
        f.arm(f.PALLAS_LOWERING, **plan)
    jtier, jv = j.get_quantile_values_resolved(QS)
    jv = np.asarray(jax.block_until_ready(jv))
    ttier, tv = t.get_quantile_values_resolved(QS)
    assert ttier == jtier == want
    assert steps(tr.health()) == steps(jr.health())
    assert steps(tr.health())[0] == ("distributed.query", "overlap", "tiles")
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, equal_nan=True)
    reset_both()
    _, clean = t.get_quantile_values_resolved(QS, disabled_tiers=("windowed", "wxla"))
    torch.testing.assert_close(tv, clean, rtol=0, atol=0, equal_nan=True)


def test_caller_exclusions_do_not_persist():
    _, t, _ = _batched_pair()
    tier, _ = t.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    assert tier == "tiles" and t._query_disabled == set()
    assert t.get_quantile_values_resolved(QS)[0] == "overlap"
    assert tr.health()["downgrades"] == []


# ---------------------------------------------------------------------------
# Ingest demotion
# ---------------------------------------------------------------------------


def _assert_twin(a, b, scale):
    for f in tb.LEAVES:
        x, y = getattr(a, f), getattr(b, f)
        if f == "sum":
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5 * scale)
        else:
            assert torch.equal(x, y), f


def test_ingest_demotion_replays_exactly_and_matches_jax():
    v1, v2, v3 = mixed_batches(N, 128, seed=8, n_batches=3)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    twin = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                              engine="plain")
    for sk in (j, t, twin):
        sk.add(v1)
    jax.block_until_ready(j.state)
    for f in (jf, tf):
        f.arm(f.PALLAS_INGEST, times=1)
    jax.block_until_ready(j.add(v2).state)
    t.add(v2)
    twin.add(v2)
    assert steps(tr.health(), INGEST_LABELS) == steps(jr.health()) == [
        ("batched.ingest", "pallas", "xla")]
    assert steps(tr.health()) == [("batched.ingest", "kernel", "plain")]
    assert not t._kernel_ingest
    reset_both()
    t.add(v3)  # stays on the plain path, nothing more recorded
    twin.add(v3)
    jax.block_until_ready(j.add(v3).state)
    assert tr.health()["downgrades"] == []
    scale = sum(float(np.abs(v).sum()) for v in (v1, v2, v3))
    _assert_twin(t.state, twin.state, scale)
    for f in tb.LEAVES:
        if f != "sum":
            np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                          np.asarray(getattr(j.state, f)), err_msg=f)


def test_ingest_variant_demotion_matches_jax():
    """A fault at a non-stock ingest rung demotes both facades to the stock
    rung (not off the kernel path), records the same ledger step, replays
    the batch exactly, and counts each call under the rung JAX counts."""
    from sketches_tpu import telemetry as jt
    from sketches_tpu_torch import telemetry as tt

    v1, v2, v3 = mixed_batches(N, 128, seed=18, n_batches=3)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    try:
        for telemetry in (jt, tt):
            telemetry.enable()
            telemetry.reset()
        for v in (v1, v2):
            jax.block_until_ready(j.add(v).state)
            t.add(v)
            if v is v1:
                for f in (jf, tf):
                    f.arm(f.PALLAS_INGEST_VARIANT, times=1)
        jax.block_until_ready(j.add(v3).state)
        t.add(v3)
        jc, tc = jt.snapshot()["counters"], tt.snapshot()["counters"]
    finally:
        for telemetry in (jt, tt):
            telemetry.disable()
            telemetry.reset()
    assert steps(tr.health()) == steps(jr.health()) == [
        ("batched.ingest_variant", "packed", "stock")]
    assert t._kernel_ingest and t._ingest_variant_demoted
    for k in ("ingest.variant.packed", "ingest.variant.stock"):
        assert tc.get(k) == jc.get(k), k
    # The first add recentres (plain); the second demotes to stock.
    assert tc.get("ingest.variant.stock") == 2 and "ingest.variant.packed" not in tc
    for f in tb.LEAVES:
        if f != "sum":
            np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                          np.asarray(getattr(j.state, f)), err_msg=f)


@pytest.mark.parametrize("packed", ["1", "0"])
def test_ingest_rung_counter_matches_jax(packed, monkeypatch):
    """Un-faulted, each kernel ingest counts under the rung the JAX facade
    runs: ``packed`` by default, ``stock`` under the kill switch."""
    from sketches_tpu import telemetry as jt
    from sketches_tpu_torch import telemetry as tt

    monkeypatch.setenv("SKETCHES_TPU_INGEST_PACKED", packed)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    try:
        for telemetry in (jt, tt):
            telemetry.enable()
            telemetry.reset()
        for v in mixed_batches(N, 128, seed=19, n_batches=3):
            jax.block_until_ready(j.add(v).state)
            t.add(v)
        jc, tc = jt.snapshot()["counters"], tt.snapshot()["counters"]
    finally:
        for telemetry in (jt, tt):
            telemetry.disable()
            telemetry.reset()
    rung = "ingest.variant.packed" if packed == "1" else "ingest.variant.stock"
    assert tc.get(rung) == jc.get(rung) == 2  # the first add recentres
    assert {k for k in tc if k.startswith("ingest.variant.")} == {rung}


def test_ingest_demotion_mid_batch_replays_only_the_rest(monkeypatch):
    """A kernel that fails after some stream chunks were written: the plain
    path finishes the batch from the first unwritten chunk -- no chunk is
    ingested twice."""
    v1, v2 = mixed_batches(N, 128, seed=9)
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    twin = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                              engine="plain")
    t.add(v1)
    twin.add(v1)
    monkeypatch.setattr(tb, "_stream_chunk", lambda n, b: 64)
    calls = []
    real = tk.add

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return real(*a, **k)

    monkeypatch.setattr(tk, "add", flaky)
    t.add(v2)
    twin.add(v2)
    assert len(calls) == 3 and t._rows_done == N
    assert steps(tr.health()) == [("batched.ingest", "kernel", "plain")]
    assert "launch failed" in tr.health()["downgrades"][0]["reason"]
    _assert_twin(t.state, twin.state, float(np.abs(v1).sum() + np.abs(v2).sum()))


def test_ingest_fault_replays_every_chunk(monkeypatch):
    """The fault fires before the first chunk: the plain path replays all
    of them (a chunked facade, as on the card at 1M streams)."""
    v1, v2 = mixed_batches(N, 128, seed=15)
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    twin = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                              engine="plain")
    monkeypatch.setattr(tb, "_stream_chunk", lambda n, b: 64)
    for sk in (t, twin):
        sk.add(v1)
    tf.arm(tf.PALLAS_INGEST, times=1)
    t.add(v2)
    twin.add(v2)
    assert steps(tr.health()) == [("batched.ingest", "kernel", "plain")]
    _assert_twin(t.state, twin.state, float(np.abs(v1).sum() + np.abs(v2).sum()))


def test_ingest_fails_on_both_paths(monkeypatch):
    v1, v2 = mixed_batches(N, 128, seed=10)
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    t.add(v1)
    tf.arm(tf.PALLAS_INGEST, times=1)

    def broken(*a, **k):
        raise RuntimeError("plain path down")

    monkeypatch.setattr(tb, "add", broken)
    with pytest.raises(tr.EngineUnavailable) as info:
        t.add(v2)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert steps(tr.health()) == [("batched.ingest", "kernel", "plain")]


# ---------------------------------------------------------------------------
# Native load
# ---------------------------------------------------------------------------


@pytest.fixture
def native_reset():
    from sketches_tpu import native as jn

    # SKETCHES_TPU_NATIVE is both packages' switch: neither engine keeps
    # a load made under it past the test.
    jn.reset()
    tn.reset()
    yield
    tf.disarm()
    jn.reset()
    tn.reset()


def test_native_load_retries_then_degrades(monkeypatch, native_reset):
    import os

    from sketches_tpu import native as jn

    sleeps = []
    monkeypatch.setattr(tn.time, "sleep", sleeps.append)
    tf.arm(tf.NATIVE_LOAD)  # every attempt fails
    assert not tn.available() and tn.wire_scanner() is None
    st = tn.status()
    assert st["tier"] == "python" and "after 3 attempts" in st["reason"]
    assert tf.stats() == {tf.NATIVE_LOAD: (3, 3)}
    pid = os.getpid()
    want = [min(tn._BACKOFF_BASE_S * 2 ** (a - 1), tn._BACKOFF_CAP_S) * jn._backoff_jitter(pid, a)
            for a in (1, 2)]
    assert sleeps == want
    assert [tn._backoff_jitter(k, a) for k in (1, 77, pid) for a in range(5)] == [
        jn._backoff_jitter(k, a) for k in (1, 77, pid) for a in range(5)]
    assert steps(tr.health()) == [("native", "native", "python")]
    assert tr.health()["counters"]["faults.native.load"] == 3


def test_native_load_transient_fault_recovers(monkeypatch, native_reset):
    sleeps = []
    monkeypatch.setattr(tn.time, "sleep", sleeps.append)
    tf.arm(tf.NATIVE_LOAD, times=2)
    assert tn.available(), tn.status()
    assert tf.stats() == {tf.NATIVE_LOAD: (3, 2)} and len(sleeps) == 2
    assert tr.health()["downgrades"] == []


def test_native_kill_switch_is_recorded(monkeypatch, native_reset):
    monkeypatch.setenv(tn.NATIVE_ENV, "0")
    assert not tn.available()
    assert steps(tr.health()) == [("native", "native", "python")]
    assert tr.health()["tiers"] == {"native": "python"}


# ---------------------------------------------------------------------------
# Quarantine decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver", ["native", "python"])
def test_quarantine_decode_matches_jax(monkeypatch, native_reset, driver):
    from sketches_tpu.pb import wire as jw
    from sketches_tpu_torch.pb import wire as tw

    n = 10_000
    r = np.random.RandomState(11)
    sk = tb.BatchedDDSketch(n, relative_accuracy=ALPHA, n_bins=128, key_offset=-64, device="cpu")
    sk.add(r.lognormal(0, 0.5, (n, 16)).astype(np.float32))
    blobs = tw.state_to_bytes(sk.spec, sk.state)
    jspec = jb.SketchSpec(relative_accuracy=ALPHA, n_bins=128, key_offset=-64)
    plan = dict(mode="corrupt", fraction=0.01, seed=7)
    jf.arm(jf.WIRE_BLOB, **plan)
    jstate, jrep = jw.bytes_to_state(jspec, blobs, errors="quarantine")
    jax.block_until_ready(jstate)
    if driver == "python":
        monkeypatch.setenv(tn.NATIVE_ENV, "0")
        tn.reset()
    tf.arm(tf.WIRE_BLOB, **plan)
    state, rep = tw.bytes_to_state(sk.spec, blobs, errors="quarantine", device="cpu")
    assert (tn.wire_scanner() is None) == (driver == "python")
    assert rep.indices == jrep.indices and rep.counters == jrep.counters
    assert 50 <= rep.n_quarantined <= 150 and rep.n_ok == n - rep.n_quarantined
    assert [(x.index, x.kind, x.error) for x in rep.records] == [
        (x.index, x.kind, x.error) for x in jrep.records]

    def wire_counters(h):
        return {k: v for k, v in h["counters"].items() if k.startswith(("wire.", "faults."))}

    assert wire_counters(tr.health()) == wire_counters(jr.health())
    assert tr.health()["counters"]["wire.quarantined"] == rep.n_quarantined
    for f in tb.LEAVES:
        if f not in ("sum", "min", "max"):  # not on the wire
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Dead shards, and one armed plan end to end
# ---------------------------------------------------------------------------


def _dist_pair(k=4, n=64, seed=12, **jkw):
    jm = jp.SketchMesh(k, devices=jax.devices()[:k])
    j = jp.DistributedDDSketch(n, mesh=jm, value_axis=jm.value_axis, stream_axis=jm.stream_axis,
                               relative_accuracy=ALPHA, n_bins=512, engine="xla", **jkw)
    t = tp.DistributedDDSketch(n, mesh=tp.SketchMesh(k, devices=["cpu"] * k),
                               relative_accuracy=ALPHA, n_bins=512, engine="plain", **jkw)
    for v in mixed_batches(n, 128 * k, seed=seed):
        jax.block_until_ready(j.add(v).partials)
        t.add(v)
    return j, t


def test_merge_partial_with_dead_shard_matches_jax():
    j, t = _dist_pair()
    for f in (jf, tf):
        f.arm(f.MESH_SHARD, shards=(1,))
    jst, jrep = j.merge_partial()
    st, rep = t.merge_partial()
    assert rep.dead_shards == jrep.dead_shards == [1]
    dead_count = t.partials.count[1].double().numpy()
    np.testing.assert_array_equal(rep.dropped_count, dead_count)  # exactly
    np.testing.assert_array_equal(rep.dropped_count, jrep.dropped_count)
    np.testing.assert_array_equal(rep.surviving_count, jrep.surviving_count)
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(jst.count))
    assert steps(tr.health()) == steps(jr.health()) == [
        ("distributed.mesh", "4 value shards", "3 value shards")]
    assert tr.health()["counters"] == jr.health()["counters"]
    assert tr.health()["counters"]["mesh.dead_shards"] == 1


def test_armed_plan_sequence_matches_jax():
    """One plan across ingest, the query ladder and the mesh: the port's
    ledger is the JAX package's, step for step (ingest labels mapped)."""
    j, t, _ = _batched_pair()
    jd, td = _dist_pair(k=2, seed=13)
    v = mixed_batches(N, 128, seed=14, n_batches=1)[0]
    out = {}
    for f, res, sk, dist in ((jf, jr, j, jd), (tf, tr, t, td)):
        f.arm(f.PALLAS_INGEST, times=1)
        sk.add(v)
        f.arm(f.PALLAS_LOWERING, tier="overlap", times=1)
        sk.get_quantile_values(QS)
        f.arm(f.PALLAS_LOWERING, tier=("tiles", "windowed"))
        sk.get_quantile_values(QS)
        f.arm(f.MESH_SHARD, shards=(0,))
        dist.merge_partial()
        f.disarm()
        if f is jf:
            jax.block_until_ready(sk.state)
        out[f] = (res.health(), f.stats())
    assert steps(out[tf][0], INGEST_LABELS) == steps(out[jf][0]) == [
        ("batched.ingest", "pallas", "xla"),
        ("batched.query", "overlap", "tiles"),
        ("batched.query", "tiles", "windowed"),
        ("batched.query", "windowed", "wxla"),
        ("distributed.mesh", "2 value shards", "1 value shards"),
    ]
    assert out[tf][0]["tiers"] == {
        "batched.ingest": "plain", "batched.query": "wxla", "distributed.mesh": "1 value shards"}
    assert out[tf][0]["counters"] == out[jf][0]["counters"]
