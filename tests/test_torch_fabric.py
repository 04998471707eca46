"""The port's serve fabric (``sketches_tpu_torch.fabric``) against
``sketches_tpu.fabric``: one fleet in each package, the same tenants, the
same seeded batches and the same op log on virtual clocks, on the CPU.

Compared exactly: ``placement`` over a tenants x ``n_hosts`` grid, the
current copy sets, ``stats()``, the mass ledgers (per-stream expected and
dropped counts, the primary's fingerprint digest), every
``FailoverReport`` (``dropped_count`` with ``==``), the refusals and their
reasons, and each read's role, host, tier and flags.  Values: a replica
answer equals the primary's bit for bit; port against JAX through
``same_answers`` (ROADMAP queue C, "jitted decode").  The seeded chaos
campaigns (``TestCampaign``) wait for the chaos module (ROADMAP A11).
"""

import numpy as np
import pytest
from sketches_tpu import fabric as jfab
from sketches_tpu import faults as jf
from sketches_tpu import windows as jw
from sketches_tpu_torch import fabric as tfab
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch import windows as tw
from sketches_tpu_torch.analysis import registry as treg
from torch_window_common import DENSE, host, mid_bucket, reset_all, same_answers
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

QS = (0.5, 0.99)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


def _batch(seed=0, n_streams=4, n=16):
    rng = np.random.default_rng(seed)
    return mid_bucket(rng.lognormal(0.0, 0.7, (n_streams, n)))


class Fleets:
    """One fabric per package on equal virtual clocks, fed the same ops."""

    def __init__(self, n_hosts=4, replication=3, staleness_s=600.0):
        self.cj, self.ct = jw.VirtualClock(0.0), tw.VirtualClock(0.0)
        self.j = jfab.ServeFabric(jfab.FabricConfig(n_hosts=n_hosts, replication=replication,
                                                    staleness_s=staleness_s), clock=self.cj)
        self.t = tfab.ServeFabric(tfab.FabricConfig(n_hosts=n_hosts, replication=replication,
                                                    staleness_s=staleness_s), clock=self.ct)

    def add(self, name="t", n=4):
        self.j.add_tenant(name, n, spec=DENSE[0])
        self.t.add_tenant(name, n, spec=DENSE[1], device="cpu")

    def advance(self, dt):
        self.cj.advance(dt)
        self.ct.advance(dt)

    def both(self, method, *args, **kwargs):
        out = {}
        for k, fab in (("j", self.j), ("t", self.t)):
            try:
                out[k] = getattr(fab, method)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - compared below
                out[k] = e
        j, t = out["j"], out["t"]
        if isinstance(j, Exception) or isinstance(t, Exception):
            assert type(j).__name__ == type(t).__name__, (j, t)
            assert getattr(j, "reason", None) == getattr(t, "reason", None)
            raise t
        return j, t

    def read(self, name="t"):
        rj, rt = self.both("quantile", name, QS)
        assert (rj.tier, rj.role, rj.host, rj.degraded, rj.hedged, rj.staleness_s) == (
            rt.tier, rt.role, rt.host, rt.degraded, rt.hedged, rt.staleness_s)
        assert same_answers(rt.values, rj.values)
        return rt

    def corrupt(self, name, host_id):
        """Silently flip a material bit in one replica, in both fleets."""
        for fab, faults in ((self.j, jf), (self.t, tf)):
            facade = fab.host_server(host_id).tenant(name)
            facade.state = faults.apply_state_bitflips(facade.state, ((0, 0, 40, 30),))

    def consistent(self, name="t") -> bool:
        lj, lt = self.j.ledger(name), self.t.ledger(name)
        return (self.j.stats() == self.t.stats()
                and self.j.placement(name) == self.t.placement(name)
                and np.array_equal(lj["expected_count"], lt["expected_count"])
                and np.array_equal(lj["dropped_count"], lt["dropped_count"])
                and lj.get("fingerprint") == lt.get("fingerprint")
                and self.j.live_hosts() == self.t.live_hosts())


def _warm(seed=5, **kw):
    f = Fleets(**kw)
    f.add()
    f.both("ingest", "t", _batch(seed))
    f.both("sync", "t")
    return f


class TestPlacement:
    def test_placement_grid_matches_the_jax_package(self):
        for name in [f"tenant-{i}" for i in range(24)] + ["a", "b", "web"]:
            for n_hosts in range(1, 9):
                for replication in (1, 2, 3, 5):
                    assert tfab.placement(name, n_hosts, replication) == jfab.placement(
                        name, n_hosts, replication)

    def test_minimal_movement_on_host_loss(self):
        for name in ("a", "b", "c", "d", "e"):
            full = tfab.placement(name, 6, 6)
            for victim in range(6):
                ranked = sorted((h for h in range(6) if h != victim),
                                key=lambda h: (-tfab._rendezvous_score(name, h), h))
                assert tuple(h for h in full if h != victim) == tuple(ranked)

    def test_invalid_args_refused(self):
        with pytest.raises(tr.SketchValueError):
            tfab.placement("a", 0, 1)
        with pytest.raises(tr.SketchValueError):
            tfab.placement("a", 4, 0)
        with pytest.raises(tr.SketchValueError):
            tfab.FabricConfig(n_hosts=0)

    def test_module_surface(self):
        assert tfab.__all__ == jfab.__all__


class TestKillSwitch:
    def test_disarmed_construction_refuses_loudly(self, monkeypatch):
        monkeypatch.setenv(treg.FABRIC.name, "0")
        with pytest.raises(tr.SpecError, match="SKETCHES_TPU_FABRIC"):
            tfab.ServeFabric(tfab.FabricConfig(n_hosts=2))

    def test_registry_row(self):
        v = treg.lookup("SKETCHES_TPU_FABRIC")
        assert v is treg.FABRIC and v.owner == "sketches_tpu_torch.fabric"


class TestTenancy:
    def test_add_tenant_places_and_replicates(self):
        f = Fleets()
        f.add()
        assert f.t.placement("t") == tfab.placement("t", 4, 3)
        assert f.t.stats()["replica_syncs"] == 2 and f.consistent()

    def test_reregister_refused(self):
        f = Fleets()
        f.add()
        with pytest.raises(tr.SpecError, match="already registered"):
            f.t.add_tenant("t", 4, spec=DENSE[1], device="cpu")

    def test_windowed_and_mesh_tenants_refused(self):
        f = Fleets()
        with pytest.raises(tr.SpecError, match="dense folds"):
            f.t.add_tenant("w", 4, window=True, spec=DENSE[1])
        with pytest.raises(tr.SpecError, match="dense folds"):
            f.t.add_tenant("m", 4, mesh=object(), spec=DENSE[1])


class TestSyncAndLedger:
    def test_ingest_tracks_exact_mass(self):
        f = Fleets()
        f.add()
        f.both("ingest", "t", _batch(1))
        f.both("ingest", "t", _batch(2))
        led = f.t.ledger("t")
        assert np.array_equal(led["expected_count"], np.full(4, 32.0))
        assert led["dropped_total"] == 0.0 and f.consistent()

    def test_nonfinite_mass_not_ledgered(self):
        f = Fleets()
        f.add()
        b = _batch(3)
        b[0, 0] = np.nan
        b[1, 0] = np.inf
        f.both("ingest", "t", b)
        assert f.t.ledger("t")["expected_count"].tolist() == [15.0, 15.0, 16.0, 16.0]
        assert f.consistent()

    def test_replica_answers_bit_identical_after_sync(self):
        f = Fleets()
        f.add()
        f.both("ingest", "t", _batch(4))
        primary = host(f.read().values)
        assert f.both("sync", "t") == (2, 2)
        f.both("partition_host", f.t.placement("t")[0])
        res = f.read()
        assert res.role == "replica" and res.degraded
        assert np.array_equal(host(res.values), primary, equal_nan=True)
        assert f.consistent()


class TestFailover:
    def test_exact_dropped_mass_and_convergence(self):
        f = _warm(5)
        f.both("ingest", "t", _batch(6))
        primary = f.t.placement("t")[0]
        rj, rt = f.both("kill_host", primary)
        assert len(rt) == 1 == len(rj)
        r, q = rt[0], rj[0]
        assert (r.tenant, r.from_host, r.to_host, r.exact, r.fingerprint_hex,
                r.refused_replicas) == (q.tenant, q.from_host, q.to_host, q.exact,
                                        q.fingerprint_hex, q.refused_replicas)
        assert r.exact and np.array_equal(r.dropped_count, q.dropped_count)
        assert np.array_equal(r.dropped_count, np.full(4, 16.0))
        led = f.t.ledger("t")
        assert np.array_equal(led["expected_count"], np.full(4, 16.0))
        assert np.array_equal(led["dropped_count"], np.full(4, 16.0))
        assert led["expected_total"] + led["dropped_total"] == 2 * 4 * 16
        assert f.read().role in ("primary", "cache") and f.consistent()

    def test_failover_restores_replication(self):
        f = _warm(7)
        f.both("kill_host", f.t.placement("t")[0])
        assert len(f.t.placement("t")) == 3 and f.t.stats()["failovers"] == 1
        assert f.consistent()

    def test_corrupted_replica_never_promoted(self):
        f = _warm(8)
        pl = f.t.placement("t")
        f.corrupt("t", pl[1])
        rj, rt = f.both("kill_host", pl[0])
        assert pl[1] in rt[0].refused_replicas and rt[0].to_host == pl[2]
        assert rj[0].refused_replicas == rt[0].refused_replicas and f.consistent()

    def test_no_verified_replica_is_unavailable(self):
        f = _warm(9, n_hosts=3, replication=2)
        pl = f.t.placement("t")
        for h in pl[1:]:
            f.corrupt("t", h)
        with pytest.raises(tr.FabricUnavailable, match="no"):
            f.both("kill_host", pl[0])

    def test_revive_host_reprovisions(self):
        f = _warm(10)
        victim = f.t.placement("t")[0]
        f.both("kill_host", victim)
        assert victim not in f.t.live_hosts()
        assert f.both("revive_host", victim)[1] >= 0
        assert victim in f.t.live_hosts()
        f.both("sync")
        assert f.read().role in ("primary", "cache") and f.consistent()


class TestBoobyTrap:
    def test_corrupt_replica_refuses_and_rehomes(self):
        f = _warm(11)
        want = host(f.read().values)
        pl = f.t.placement("t")
        f.corrupt("t", pl[1])
        f.both("partition_host", pl[0])
        res = f.read()
        assert res.role == "replica" and res.host == pl[2]
        assert np.array_equal(host(res.values), want, equal_nan=True)
        assert f.t.stats()["stale_refusals"] == 1 and f.consistent()

    def test_armed_replica_stale_site_refuses(self):
        """The ``fabric.replica_stale`` adversary corrupts the replica at
        read time, at the same coordinates in both packages: the two fleets
        refuse or serve alike, and whatever serves answers the primary's
        values (a flip too small to move the fingerprint moves no answer
        either)."""
        f = _warm(21)
        want = host(f.read().values)
        pl = f.t.placement("t")
        f.both("partition_host", pl[0])
        for seed in range(4):
            tf.arm(tf.FABRIC_REPLICA_STALE, seed=seed, times=1)
            jf.arm(jf.FABRIC_REPLICA_STALE, seed=seed, times=1)
            res = f.read()
            tf.disarm()
            jf.disarm()
            assert res.role == "replica" and f.consistent()
            assert np.array_equal(host(res.values), want, equal_nan=True)
            f.both("sync", "t")
        assert f.t.stats()["stale_refusals"] >= 1

    def test_all_replicas_corrupt_raises_loudly(self):
        f = _warm(12)
        pl = f.t.placement("t")
        for h in pl[1:]:
            f.corrupt("t", h)
        f.both("partition_host", pl[0])
        with pytest.raises(tr.ReplicaStale) as exc:
            f.both("quantile", "t", QS)
        assert exc.value.reason == "fingerprint"

    def test_sync_repairs_corrupt_replica(self):
        f = _warm(13)
        pl = f.t.placement("t")
        f.corrupt("t", pl[1])
        assert f.both("sync", "t") == (2, 2)
        f.both("partition_host", pl[0])
        assert f.read().role == "replica" and f.consistent()


class TestPartitions:
    def test_partitioned_primary_degrades_reads_refuses_writes(self):
        f = _warm(14)
        f.both("partition_host", f.t.placement("t")[0])
        res = f.read()
        assert res.degraded and res.role == "replica"
        with pytest.raises(tr.FabricUnavailable, match="fork"):
            f.both("ingest", "t", _batch(15))

    def test_beyond_bound_replica_refuses(self):
        f = _warm(16, staleness_s=30.0)
        f.both("partition_host", f.t.placement("t")[0])
        f.advance(31.0)
        with pytest.raises(tr.ReplicaStale) as exc:
            f.both("quantile", "t", QS)
        assert exc.value.reason == "staleness"

    def test_heal_reconciles_and_restores_primary(self):
        f = _warm(17)
        want = host(f.read().values)
        p = f.t.placement("t")[0]
        f.both("partition_host", p)
        f.read()
        f.both("heal_partition", p)
        res = f.read()
        assert res.role in ("primary", "cache")
        assert np.array_equal(host(res.values), want, equal_nan=True) and f.consistent()

    def test_torn_heal_is_atomic(self):
        f = _warm(18)
        h = f.t.placement("t")[1]
        f.both("partition_host", h)
        tf.arm(tf.MESH_PARTITION_HEAL, times=1)
        jf.arm(jf.MESH_PARTITION_HEAL, times=1)
        with pytest.raises(tr.InjectedFault):
            f.both("heal_partition", h)
        tf.disarm()
        jf.disarm()
        assert h not in f.t.live_hosts()
        assert f.both("heal_partition", h) == (1, 1) and f.consistent()


class TestHandoff:
    def test_clean_handoff_moves_replica_and_ledger(self):
        f = _warm(19)
        pl = f.t.placement("t")
        free = next(h for h in f.t.live_hosts() if h not in pl)
        rj, rt = f.both("handoff_replica", "t", pl[1], free)
        assert rt.cache_preserved and rt.fingerprint_hex == rj.fingerprint_hex
        assert free in f.t.placement("t") and pl[1] not in f.t.placement("t")
        f.both("partition_host", f.t.placement("t")[0])
        assert f.read().role == "replica" and f.consistent()

    def test_cache_survives_handoff(self):
        f = _warm(19)
        pl = f.t.placement("t")
        f.both("partition_host", pl[0])
        f.read()
        f.both("heal_partition", pl[0])
        moved_from = f.t.placement("t")[1]
        free = next(h for h in f.t.live_hosts() if h not in f.t.placement("t"))
        f.both("handoff_replica", "t", moved_from, free)
        before = f.t.stats()["cache_hits"]
        f.both("partition_host", f.t.placement("t")[0])
        assert f.read().tier == "cache"
        assert f.t.stats()["cache_hits"] == before + 1 and f.consistent()

    def test_torn_handoff_leaves_source_intact(self):
        f = _warm(19)
        pl = f.t.placement("t")
        free = next(h for h in f.t.live_hosts() if h not in pl)
        tf.arm(tf.RESHARD_TORN, times=1)
        jf.arm(jf.RESHARD_TORN, times=1)
        with pytest.raises(tr.InjectedFault):
            f.both("handoff_replica", "t", pl[1], free)
        tf.disarm()
        jf.disarm()
        assert f.t.placement("t") == pl
        f.both("partition_host", pl[0])
        assert f.read().role == "replica"

    def test_handoff_validations(self):
        f = _warm(19)
        pl = f.t.placement("t")
        free = next(h for h in f.t.live_hosts() if h not in pl)
        with pytest.raises(tr.SpecError, match="holds no replica"):
            f.both("handoff_replica", "t", free, pl[1])
        with pytest.raises(tr.SpecError, match="already holds"):
            f.both("handoff_replica", "t", pl[1], pl[2])


class TestHedge:
    def test_primary_engine_failure_hedges_cross_host(self, monkeypatch):
        f = _warm(20)
        want = host(f.read().values)
        primary = f.t.placement("t")[0]

        def _boom(*a, **k):
            raise RuntimeError("primary engine ladder down")

        for fab in (f.j, f.t):
            monkeypatch.setattr(fab.host_server(primary), "query", _boom)
            fab._cache.clear()
            fab._cache_order.clear()
        res = f.read()
        assert res.hedged and res.role == "replica"
        assert np.array_equal(host(res.values), want, equal_nan=True)
        assert f.t.stats()["hedges"] == 1 and f.consistent()
