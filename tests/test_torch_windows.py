"""The port's time windows (``sketches_tpu_torch.windows``) against
``sketches_tpu.windows`` on the same seeded inputs and virtual-clock op
log, on the CPU: configuration and kill switch, the exact mass ledger,
window answers against the oracle, the coarsening ladder, rotation
atomicity and the maintained two-stacks aggregates.

Tolerances, with their reasons (``torch_window_common``):

* **Exact** for ``buckets()``, ``ledger()``, ``agg_stats()``, plan keys,
  recipes, fingerprints and digests, and for every port answer against the
  port's own ``oracle_quantile``.
* **Bucket keys exact, values rtol 1e-6** for a port answer against the
  JAX package's: its decode runs under ``jit`` (ROADMAP queue C, "jitted
  decode").
* **Moment answers rtol 1e-3**: the port's f32 power sums add in another
  order than XLA's, and the maxent solve turns those last bits into a
  small relative change.
"""

import numpy as np
import pytest
import torch
from sketches_tpu import faults as jf
from sketches_tpu import integrity as ji
from sketches_tpu import serve as js
from sketches_tpu import telemetry as jt
from sketches_tpu import windows as jw
from sketches_tpu.analysis import registry as jreg
from sketches_tpu_torch import checkpoint as tc
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch import serve as ts
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import windows as tw
from sketches_tpu_torch.analysis import registry as treg
from sketches_tpu_torch.backends import wirefmt as twf
from torch_window_common import (
    ADAPTIVE,
    CFG,
    DENSE,
    MOMENT,
    QS,
    Pair,
    batch,
    configs,
    host,
    reset_all,
    same_answers,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


def _answers_match(pair, window, qs=QS):
    """The port's window answer equals its oracle bit for bit and the JAX
    package's oracle within the documented tolerance."""
    backend = pair.t.spec.backend
    got = host(pair.t.quantile(qs, window=window))
    own = host(tw.oracle_quantile(pair.t, qs, window=window))
    ref = host(jw.oracle_quantile(pair.j, qs, window=window))
    assert np.array_equal(got, own, equal_nan=True), (window, got - own)
    if backend == "moment":
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(got)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-3)
    else:
        assert same_answers(got, ref), (window, got, ref)


# ---------------------------------------------------------------------------
# Config validation + kill switch
# ---------------------------------------------------------------------------


class TestConfigAndKillSwitch:
    def test_kill_switch_refuses_loudly(self, monkeypatch):
        monkeypatch.setenv(treg.WINDOWED.name, "0")
        for w, s, srv in ((tw, DENSE[1], ts.SketchServer(clock=tw.VirtualClock())),
                          (jw, DENSE[0], js.SketchServer(clock=jw.VirtualClock()))):
            with pytest.raises(Exception, match="SKETCHES_TPU_WINDOWED"):
                w.WindowedSketch(2, spec=s, clock=w.VirtualClock())
            with pytest.raises(Exception, match="SKETCHES_TPU_WINDOWED"):
                srv.add_tenant("w", 2, window=True, spec=s)

    def test_armed_by_default_constructs(self):
        p = Pair()
        assert p.t.config == CFG[1] and p.t.total_mass == 0.0
        assert p.t.device == torch.device("cpu")

    def test_registry_declared(self):
        for reg, owner in ((treg, "sketches_tpu_torch.windows"), (jreg, "sketches_tpu.windows")):
            v = reg.lookup("SKETCHES_TPU_WINDOWED")
            assert v.default == "1" and v.owner == owner

    def test_metrics_declared(self):
        for name, kind in (("window.rotations", "counter"), ("window.retired_mass", "counter"),
                           ("window.ladder_collapses", "counter"),
                           ("window.covered_buckets", "gauge")):
            assert tt.METRICS[name].kind == jt.METRICS[name].kind == kind

    @pytest.mark.parametrize(
        "kwargs",
        [
            dict(slices_s=(), lengths=()),
            dict(slices_s=(5.0,), lengths=(3, 3)),
            dict(slices_s=(5.0, 0.0), lengths=(3, 3)),
            dict(slices_s=(5.0, 60.0), lengths=(3, 0)),
            dict(slices_s=(5.0, 12.0), lengths=(3, 3)),
            dict(slices_s=(60.0, 5.0), lengths=(3, 3)),
            dict(slices_s=(5.0, 60.0), lengths=(3, 3), collapse_levels=(1,)),
            dict(slices_s=(5.0, 60.0), lengths=(3, 3), collapse_levels=(2, 1)),
        ],
    )
    def test_bad_configs_refuse(self, kwargs):
        with pytest.raises(tr.SpecError):
            tw.WindowConfig(**kwargs)
        with pytest.raises(Exception):
            jw.WindowConfig(**kwargs)

    def test_collapse_levels_need_adaptive_backend(self):
        cfg = tw.WindowConfig((5.0, 20.0), (2, 2), collapse_levels=(0, 2))
        with pytest.raises(tr.SpecError, match="uniform_collapse"):
            tw.WindowedSketch(2, spec=DENSE[1], config=cfg, clock=tw.VirtualClock(),
                              device="cpu")

    def test_default_ladder_shape(self):
        assert tw.DEFAULT_LADDER == tw.WindowConfig()
        assert tw.DEFAULT_LADDER.slices_s == jw.DEFAULT_LADDER.slices_s
        assert tw.DEFAULT_LADDER.lengths == jw.DEFAULT_LADDER.lengths
        assert tw.DEFAULT_LADDER.horizon_s() == jw.DEFAULT_LADDER.horizon_s()
        assert tw.__all__ == jw.__all__

    def test_virtual_clock_monotone(self):
        clk = tw.VirtualClock(3.0)
        assert clk() == 3.0 and clk.advance(2.0) == 5.0
        with pytest.raises(tr.SketchValueError):
            clk.advance(-1.0)


# ---------------------------------------------------------------------------
# Rotation + the exact mass ledger
# ---------------------------------------------------------------------------


class TestLedger:
    def test_ledger_exact_through_rotations(self):
        p = Pair()
        rng = np.random.default_rng(0)
        for _ in range(30):
            p.drive(rng, 1)
            assert p.ledgers_equal()
        led = p.t.ledger()
        assert led["total"] == 30 * 8 * 16
        assert led["total"] == led["live"] + led["retired"] and led["rotations"] > 0
        device = p.t.device_masses()
        assert device == p.j.device_masses()
        for rung, bid, mass in p.t.buckets():
            assert device[(rung, bid)] == mass

    def test_everything_retires_after_horizon(self):
        p = Pair()
        rng = np.random.default_rng(1)
        p.drive(rng, 6)
        total = p.t.total_mass
        p.advance(10_000.0)
        p.add(np.ones((8, 4), np.float32))
        led = p.t.ledger()
        assert p.ledgers_equal()
        assert led["retired"] == total and led["live"] == 8 * 4
        vals = host(p.t.quantile([0.5], window=None))
        assert np.allclose(vals, 1.0, rtol=0.03)

    def test_weighted_and_padded_mass(self):
        p = Pair()
        p.advance(1.0)
        w = np.ones((8, 8), np.float32)
        w[:, ::2] = 0.0
        w[:, 1] = 2.5
        p.add(np.ones((8, 8), np.float32), w)
        assert p.ledgers_equal()
        assert p.t.total_mass == 8 * 5.5
        (key,) = p.t.device_masses()
        assert p.t.device_masses()[key] == p.t.total_mass

    def test_check_window_catches_forged_ledger(self):
        p = Pair()
        p.advance(1.0)
        p.add(np.ones((8, 8), np.float32))
        assert not ti.check_window(p.t) and not ji.check_window(p.j)
        p.t._total += 1.0
        report = ti.check_window(p.t)
        assert report and "window_ledger" in report.counters
        with pytest.raises(tr.IntegrityError):
            ti.verify_window(p.t, errors="raise")

    def test_merge_rings(self):
        a, b = Pair(), Pair()
        rng = np.random.default_rng(2)
        for _ in range(8):
            for p in (a, b):
                p.advance(3.0)
                p.add(batch(rng, 8, 8, 0.5))
        a.j.merge(b.j)
        a.t.merge(b.t)
        assert a.ledgers_equal()
        led = a.t.ledger()
        assert led["total"] == 2 * 8 * 8 * 8 and led["total"] == led["live"] + led["retired"]
        assert a.plans_equal(None)
        _answers_match(a, None)

    def test_merge_mismatch_refuses(self):
        a = Pair()
        b = Pair(config=configs((5.0,), (4,)))
        with pytest.raises(tr.UnequalSketchParametersError):
            a.t.merge(b.t)


# ---------------------------------------------------------------------------
# Window answers: bit-identical to the oracle, equal to the JAX package's
# ---------------------------------------------------------------------------


class TestOracleExactness:
    @pytest.mark.parametrize(
        "spec,cfg,wins,checks",
        [
            (DENSE, CFG, (3.0, 17.0, None), (3, 7, 13)),
            (ADAPTIVE, configs((5.0, 20.0), (2, 2), (0, 2)), (17.0, None), (6, 13)),
            (MOMENT, configs((5.0, 20.0), (2, 2)), (17.0, None), (6, 13)),
        ],
        ids=["dense", "uniform_collapse", "moment"],
    )
    def test_bit_identical_to_oracle(self, spec, cfg, wins, checks):
        p = Pair(spec=spec, config=cfg, n=4)
        rng = np.random.default_rng(5)
        for step in range(14):
            p.drive(rng, 1, dt=(1.0, 6.0), width=8)
            assert p.ledgers_equal()
            if step in checks:
                for win in wins:
                    if spec is not MOMENT:
                        assert p.plans_equal(win)
                    _answers_match(p, win)

    def test_empty_window_answers_nan(self):
        p = Pair()
        p.advance(1.0)
        p.add(np.ones((8, 4), np.float32))
        p.advance(500.0)
        vals = host(p.t.quantile([0.5, 0.9], window=2.0))
        assert vals.shape == (8, 2) and np.isnan(vals).all()

    def test_fresh_ring_answers_nan(self):
        assert np.isnan(host(Pair().t.quantile([0.5]))).all()

    def test_current_bucket_at_slice_boundary_is_covered(self):
        p = Pair(t0=100.0)
        p.add(np.full((8, 4), 2.0, np.float32))
        assert np.isfinite(host(p.t.quantile([0.5], window=10.0))).all()
        assert p.plans_equal(10.0)

    def test_facade_parity_alias(self):
        p = Pair()
        p.advance(1.0)
        p.add(np.full((8, 4), 3.0, np.float32))
        assert np.array_equal(host(p.t.get_quantile_values([0.5, 0.9])),
                              host(p.t.quantile([0.5, 0.9], window=None)), equal_nan=True)

    def test_post_reshard_bit_identity(self):
        """A mesh-backed ring (two value shards on the CPU): frozen buckets
        survive reshard, and the answer still equals the oracle and the
        JAX package's unsharded ring on the same op log."""
        from sketches_tpu_torch.parallel import SketchMesh

        clk = tw.VirtualClock(0.0)
        w = tw.WindowedSketch(8, spec=DENSE[1], config=CFG[1], clock=clk,
                              mesh=SketchMesh(devices=["cpu", "cpu"]))
        cj = jw.VirtualClock(0.0)
        wj = jw.WindowedSketch(8, spec=DENSE[0], config=CFG[0], clock=cj)
        rng = np.random.default_rng(6)
        for _ in range(8):
            dt = float(rng.uniform(1.0, 5.0))
            clk.advance(dt)
            cj.advance(dt)
            v = batch(rng, 8, 8)
            wj.add(v)
            host(wj._live.state.count)
            w.add(v)
        assert w.buckets() == wj.buckets()
        before = host(w.quantile([0.5, 0.99], window=25.0))
        report = w.reshard(n_devices=1)
        assert report.n_dead == 0 and w._live.mesh.n_devices == 1
        after = host(w.quantile([0.5, 0.99], window=25.0))
        assert np.array_equal(before, after, equal_nan=True)
        assert np.array_equal(after, host(tw.oracle_quantile(w, [0.5, 0.99], window=25.0)),
                              equal_nan=True)
        assert same_answers(after, jw.oracle_quantile(wj, [0.5, 0.99], window=25.0))
        led = w.ledger()
        assert led["total"] == led["live"] + led["retired"]
        with pytest.raises(tr.SpecError, match="mesh-backed"):
            Pair().t.reshard(n_devices=1)


# ---------------------------------------------------------------------------
# Ladder coarsening: collapse-on-retire + the declared alpha contract
# ---------------------------------------------------------------------------


class TestLadder:
    def test_collapse_on_retire_and_effective_alpha(self):
        p = Pair(spec=ADAPTIVE, config=configs((5.0, 20.0), (2, 2), (0, 2)), n=4)
        rng = np.random.default_rng(7)
        p.drive(rng, 14, width=8)
        assert p.ledgers_equal()
        led = p.t.ledger()
        assert led["ladder_collapses"] > 0 and led["total"] == led["live"] + led["retired"]
        alphas = p.t.rung_effective_alpha()
        np.testing.assert_allclose(alphas, p.j.rung_effective_alpha(), rtol=1e-6)
        assert alphas[0] == pytest.approx(0.02, rel=1e-3) and alphas[1] > alphas[0]
        for b in p.t._rungs[1].values():
            assert int(b.state.level.min()) >= 2

    def test_dense_ladder_keeps_spec_alpha(self):
        assert Pair().t.rung_effective_alpha() == [0.02, 0.02]

    def test_rotation_telemetry_counters(self):
        for t in (tt, jt):
            t.enable()
        p = Pair(config=configs((5.0,), (2,)))
        rng = np.random.default_rng(8)
        p.drive(rng, 10, dt=(4.0, 7.0), width=4)
        p.t.quantile([0.5], window=8.0)
        p.j.quantile([0.5], window=8.0)
        snaps = [t.snapshot() for t in (tt, jt)]
        for name in ("window.rotations", "window.retired_mass"):
            assert snaps[0]["counters"][name] == snaps[1]["counters"][name] > 0
        assert snaps[0]["gauges"]["window.covered_buckets"] >= 1


# ---------------------------------------------------------------------------
# Rotation atomicity (the window.rotate_torn site)
# ---------------------------------------------------------------------------


class TestRotationAtomicity:
    def test_torn_rotation_mutates_nothing(self):
        p = Pair()
        rng = np.random.default_rng(9)
        p.drive(rng, 5)
        before_led, before_buckets = p.t.ledger(), p.t.buckets()
        before_fp = ti.fingerprint(p.t.spec, p.t._live.state)
        before_q = host(p.t.quantile([0.5], window=None))
        p.advance(12.0)
        tf.arm(tf.WINDOW_ROTATE_TORN, times=1)
        with pytest.raises(tr.InjectedFault):
            p.t.add(np.ones((8, 4), np.float32))
        tf.disarm()
        assert p.t.ledger() == before_led and p.t.buckets() == before_buckets
        assert np.array_equal(ti.fingerprint(p.t.spec, p.t._live.state), before_fp)
        assert np.array_equal(host(p.t.quantile([0.5], window=None)), before_q, equal_nan=True)
        p.t.add(np.ones((8, 4), np.float32))
        led = p.t.ledger()
        assert led["total"] == before_led["total"] + 8 * 4
        assert led["total"] == led["live"] + led["retired"]

    def test_site_is_declared(self):
        assert tf.WINDOW_ROTATE_TORN in tf.SITES and tf.WINDOW_ROTATE_TORN == jf.WINDOW_ROTATE_TORN


# ---------------------------------------------------------------------------
# Incremental two-stacks window aggregation
# ---------------------------------------------------------------------------


class TestWindowAgg:
    def test_registry_declared(self):
        v = treg.lookup("SKETCHES_TPU_WINDOW_AGG")
        assert v.default == "1" and v.owner == "sketches_tpu_torch.windows"

    def test_metrics_declared(self):
        for name in ("window.agg_reuse", "window.agg_rebuilds", "window.query_merges"):
            assert tt.METRICS[name].kind == "counter"

    def test_sites_declared(self):
        assert tf.WINDOW_STACK_TORN in tf.SITES and tf.WINDOW_AGG_STALE in tf.SITES

    def test_disarmed_parity(self, monkeypatch):
        monkeypatch.setenv(treg.WINDOW_AGG.name, "0")
        p = Pair(n=4)
        rng = np.random.default_rng(17)
        p.drive(rng, 10, width=8)
        assert p.t.agg_stats()["enabled"] == 0.0
        plan = p.t.window_plan(25.0)
        assert plan.components is None and plan.recipes is None
        assert p.plans_equal(25.0)
        _answers_match(p, 25.0, [0.5, 0.99])

    def test_amortized_maintenance_budget(self):
        p = Pair()
        rng = np.random.default_rng(18)
        for step in range(40):
            p.drive(rng, 1, dt=(2.0, 6.0), width=8)
            if step % 3 == 0:
                p.t.quantile([0.5], window=30.0)
                p.j.quantile([0.5], window=30.0)
        stats = p.t.agg_stats()
        assert stats == p.j.agg_stats()
        rotations = p.t.ledger()["rotations"]
        assert rotations >= 10
        assert stats["maintenance_merges"] <= 2 * rotations and stats["rebuilds"] <= 1

    def test_query_is_one_merge_of_maintained_states(self):
        p = Pair()
        rng = np.random.default_rng(19)
        p.drive(rng, 16, dt=(4.0, 6.0), width=8)
        plan = p.t.window_plan(None)
        p.j.window_plan(None)
        assert plan.components is not None and plan.n_covered >= 4
        assert [r for r in plan.recipes if r[0] == "fold"]
        assert len(plan.components) < plan.n_covered
        s1 = p.t.agg_stats()
        plan2 = p.t.window_plan(None)
        s2 = p.t.agg_stats()
        assert s2["maintenance_merges"] == s1["maintenance_merges"]
        assert s2["query_merges"] == s1["query_merges"] and s2["reuse"] > s1["reuse"]
        got = host(p.t.query_plan(plan2, [0.5, 0.99]))
        assert np.array_equal(got, host(tw.oracle_quantile(p.t, [0.5, 0.99], window=None)),
                              equal_nan=True)
        # A repeat on the unchanged window decodes from the cached fold.
        again = host(p.t.query_plan(p.t.window_plan(None), [0.5, 0.99]))
        assert np.array_equal(again, got, equal_nan=True)

    def test_decode_facade_wraps_the_fold_in_place(self):
        """The repeat query's throwaway facade holds the folded state
        itself: same tensors, same windows, no plans cached up front."""
        p = Pair()
        rng = np.random.default_rng(28)
        p.drive(rng, 16, dt=(4.0, 6.0), width=8)
        plan = p.t.window_plan(None)
        folded = p.t._agg_fold(plan)
        fac = p.t._agg_fold_cache[4]
        assert fac.state is folded and fac.state.key_offset is folded.key_offset
        assert fac.device == folded.device and fac._window_plan is None and not fac._tile_plans
        assert not fac._auto_recenter_pending

    def test_query_merge_telemetry(self):
        tt.enable()
        p = Pair()
        rng = np.random.default_rng(27)
        p.drive(rng, 12, dt=(4.0, 6.0), width=8)
        p.t.quantile([0.5], window=30.0)
        p.t._agg_invalidate()
        p.t.quantile([0.9], window=30.0)
        counters = tt.snapshot()["counters"]
        for name in ("window.query_merges", "window.agg_rebuilds", "window.agg_reuse"):
            assert counters.get(name, 0) >= 1, name

    def test_ladder_boundary_5s_to_1m_dense(self):
        p = Pair(config=configs((5.0, 60.0), (12, 2)), n=4)
        rng = np.random.default_rng(20)
        p.drive(rng, 40, dt=(3.0, 8.0), width=8)
        assert p.ledgers_equal()
        for win in (70.0, 130.0, None):
            assert p.plans_equal(win)
            _answers_match(p, win)
        led = p.t.ledger()
        assert led["rotations"] > 12 and led["retired"] > 0
        assert led["total"] == led["live"] + led["retired"]
        assert not p.t._agg_audit()

    def test_restore_rebuilds_stacks(self, tmp_path):
        p = Pair()
        rng = np.random.default_rng(22)
        p.drive(rng, 10)
        p.t.quantile([0.5], window=25.0)
        path = str(tmp_path / "w.ckpt")
        tc.save_windowed(path, p.t)
        restored = tc.restore_windowed(path, clock=tw.VirtualClock(p.ct.t), device="cpu")
        assert restored.agg_stats()["rebuilds"] == 0.0
        got = host(restored.quantile([0.5, 0.9], window=25.0))
        assert np.array_equal(got, host(tw.oracle_quantile(restored, [0.5, 0.9], window=25.0)),
                              equal_nan=True)
        assert restored.agg_stats()["rebuilds"] == 1.0 and not restored._agg_audit()

    def test_wire_restore_rebuilds_stacks(self):
        p = Pair()
        rng = np.random.default_rng(23)
        p.drive(rng, 8)
        p.t.quantile([0.5], window=25.0)
        restored = twf.windowed_from_bytes(DENSE[1], twf.windowed_to_bytes(p.t),
                                           clock=tw.VirtualClock(p.ct.t), device="cpu")
        assert restored.agg_stats()["rebuilds"] == 0.0
        got = host(restored.quantile([0.5, 0.9], window=25.0))
        assert np.array_equal(got, host(tw.oracle_quantile(restored, [0.5, 0.9], window=25.0)),
                              equal_nan=True)
        assert restored.agg_stats()["rebuilds"] >= 1.0

    def test_ring_merge_invalidates_stacks(self):
        a, b = Pair(), Pair()
        rng = np.random.default_rng(24)
        for p in (a, b):
            for _ in range(8):
                p.advance(3.0)
                p.add(batch(rng, 8, 8))
        a.t.quantile([0.5], window=25.0)
        a.j.quantile([0.5], window=25.0)
        a.t.merge(b.t)
        a.j.merge(b.j)
        _answers_match(a, 25.0, [0.5, 0.99])
        assert not a.t._agg_audit()

    def test_stale_aggregate_caught_by_check_window(self):
        p = Pair()
        rng = np.random.default_rng(25)
        p.drive(rng, 10)
        p.t.quantile([0.5], window=25.0)
        assert not ti.check_window(p.t)
        assert p.t._agg_corrupt(((0, 1, 7, 5),))
        assert ti.check_window(p.t).counters.get("window_agg", 0) > 0
        p.t._agg_invalidate()
        assert not ti.check_window(p.t)

    def test_torn_stack_sync_degrades_to_rebuild(self):
        """``window.stack_torn`` drops the derived stacks (recorded in the
        health ledger); the next plan rebuilds them and answers right."""
        p = Pair()
        rng = np.random.default_rng(26)
        p.drive(rng, 8)
        tf.arm(tf.WINDOW_STACK_TORN, times=1)
        p.t.window_plan(25.0)
        tf.disarm()
        assert p.t._agg_stacks is None
        assert tr.health()["downgrades"][0]["component"] == "windows.agg"
        _answers_match(p, 25.0)
        assert p.t._agg_stacks is not None
