"""The port's serving tier (``sketches_tpu_torch.serve``) against
``sketches_tpu.serve``: one server in each package, the same tenants, the
same seeded mid-bucket batches and the same op log on virtual clocks, on
the CPU.

Compared exactly: result tiers, ``cached`` and ``hedged`` flags,
``deadline_missed``, ``stats()``, breaker states, the shed reasons and the
health-ledger counters.  Served values equal the port tenant's own direct
query bit for bit, and the JAX package's within ``same_answers`` (bucket
keys exact, values rtol 1e-6: its decode runs under ``jit``; ROADMAP queue
C).  The windowed tenants' cases close the file (``test_windows.py``'s
``TestServe``).  The seeded chaos campaigns wait for the chaos module
(ROADMAP A11).
"""

import numpy as np
import pytest
from sketches_tpu import faults as jf
from sketches_tpu import integrity as ji
from sketches_tpu import resilience as jr
from sketches_tpu import serve as js
from sketches_tpu import telemetry as jt
from sketches_tpu import windows as jw
from sketches_tpu_torch import faults as tf
from sketches_tpu_torch import integrity as ti
from sketches_tpu_torch import resilience as tr
from sketches_tpu_torch import serve as ts
from sketches_tpu_torch import telemetry as tt
from sketches_tpu_torch import windows as tw
from sketches_tpu_torch.analysis import registry as treg
from torch_window_common import CFG, DENSE, host, mid_bucket, reset_all, same_answers
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

PKG = {"j": (js, jf, jr, jt, ji, jw), "t": (ts, tf, tr, tt, ti, tw)}


class VirtualClock:
    """A deterministic serving clock: manual ``advance`` plus an optional
    per-read ``auto_step`` (elapsed time inside a dispatch, no sleeping)."""

    def __init__(self, auto_step: float = 0.0):
        self.t = 0.0
        self.auto_step = auto_step

    def __call__(self) -> float:
        self.t += self.auto_step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


class Servers:
    """One server per package on equal virtual clocks (a wall clock would
    make the JAX package's first compile a straggler), fed the same op
    log."""

    def __init__(self, auto_step=0.0, **cfg):
        self.clocks = {}
        self.s = {}
        for k, (serve, *_rest) in PKG.items():
            clk = VirtualClock(auto_step)
            self.clocks[k] = clk
            self.s[k] = serve.SketchServer(serve.ServeConfig(**cfg), clock=clk)

    def add(self, name, n, **kw):
        self.s["j"].add_tenant(name, n, spec=DENSE[0], **kw.get("j", {}))
        self.s["t"].add_tenant(name, n, spec=DENSE[1], device="cpu", **kw.get("t", {}))

    def ingest(self, name, values):
        for k in ("j", "t"):
            self.s[k].ingest(name, values)

    def advance(self, dt):
        for clk in self.clocks.values():
            clk.advance(dt)

    def both(self, method, *args, **kwargs):
        """Call ``method`` on both servers -> (jax result, port result); a
        refusal must be the same exception class (and reason) on both."""
        out = {}
        for k in ("j", "t"):
            try:
                out[k] = getattr(self.s[k], method)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - compared below
                out[k] = e
        j, t = out["j"], out["t"]
        if isinstance(j, Exception) or isinstance(t, Exception):
            assert type(j).__name__ == type(t).__name__, (j, t)
            assert getattr(j, "reason", None) == getattr(t, "reason", None)
            raise t
        return j, t

    def stats_equal(self) -> bool:
        return self.s["j"].stats() == self.s["t"].stats()

    def direct(self, name, qs):
        return host(self.s["t"].tenant(name).get_quantile_values(list(qs)))


def _same_result(rj, rt, srv=None, name=None, qs=None):
    assert (rj.tier, rj.cached, rj.hedged, rj.deadline_missed) == (
        rt.tier, rt.cached, rt.hedged, rt.deadline_missed)
    assert same_answers(rt.values, rj.values)
    if srv is not None:
        assert np.array_equal(rt.values, srv.direct(name, qs), equal_nan=True)


def _servers(auto_step=0.0, **cfg):
    srv = Servers(auto_step=auto_step, **cfg)
    srv.add("a", 8)
    srv.add("b", 4)
    rng = np.random.RandomState(7)
    srv.ingest("a", mid_bucket(rng.lognormal(0.0, 0.5, (8, 64))))
    srv.ingest("b", mid_bucket(rng.lognormal(1.0, 0.5, (4, 64))))
    return srv


# ---------------------------------------------------------------------------
# Serving never changes an answer
# ---------------------------------------------------------------------------


class TestAnswers:
    def test_served_equals_direct_bit_identical(self):
        srv = _servers()
        rj, rt = srv.both("query", "a", [0.5, 0.99])
        assert rt.values.shape == (8, 2)
        _same_result(rj, rt, srv, "a", (0.5, 0.99))

    def test_cross_tenant_fused_dispatch(self):
        srv = _servers()
        t1 = srv.both("submit", "a", [0.9])
        t2 = srv.both("submit", "b", [0.9])
        oj, ot = srv.both("flush")
        assert srv.s["t"].stats()["fused_dispatches"] == 1 and srv.stats_equal()
        _same_result(oj[t1[0].id], ot[t1[1].id], srv, "a", (0.9,))
        _same_result(oj[t2[0].id], ot[t2[1].id], srv, "b", (0.9,))
        assert ot[t1[1].id].tier == "xla"

    def test_stacked_flush_equals_each_tenants_own_quantile(self):
        """The stacked dispatch answers each tenant exactly as
        ``batched.quantile`` on that tenant's own state."""
        from sketches_tpu_torch import batched as tb

        srv = _servers()
        srv.add("c", 8)
        srv.ingest("c", mid_bucket(np.random.RandomState(9).lognormal(0, 2, (8, 64))))
        tks = [srv.s["t"].submit(n, [0.25, 0.5, 0.99]) for n in ("a", "b", "c")]
        srv.s["t"].flush()
        for tk in tks:
            st = srv.s["t"].tenant(tk.tenant).state
            want = tb.quantile(DENSE[1], st, [0.25, 0.5, 0.99]).numpy()
            assert tk.result.tier == "xla"
            assert np.array_equal(tk.result.values, want, equal_nan=True)

    def test_requests_fold_into_one_union_dispatch(self):
        srv = _servers()
        t1 = srv.both("submit", "a", [0.5])
        t2 = srv.both("submit", "a", [0.99, 0.5])
        before = srv.s["t"].stats()["dispatches"]
        oj, ot = srv.both("flush")
        assert srv.s["t"].stats()["dispatches"] == before + 1 and srv.stats_equal()
        _same_result(oj[t1[0].id], ot[t1[1].id], srv, "a", (0.5,))
        _same_result(oj[t2[0].id], ot[t2[1].id], srv, "a", (0.5, 0.99))

    def test_unknown_tenant_and_empty_qs_refused(self):
        srv = _servers()
        with pytest.raises(tr.SpecError):
            srv.both("query", "nobody", [0.5])
        with pytest.raises(ValueError):
            srv.both("query", "a", [])
        with pytest.raises(tr.SpecError):
            srv.s["t"].add_tenant("a", 8, spec=DENSE[1], device="cpu")

    def test_empty_flush_is_empty(self):
        assert _servers().s["t"].flush() == {}

    def test_module_surface(self):
        assert ts.__all__ == js.__all__


# ---------------------------------------------------------------------------
# Admission control / shed order
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_shed_order_quota_before_depth(self):
        srv = _servers(max_queue_depth=4, tenant_quota=3, cache_capacity=0)
        tickets = [srv.both("submit", "a", [0.1 * (i + 1)]) for i in range(3)]
        with pytest.raises(tr.ServeOverload) as ei:
            srv.both("submit", "a", [0.7])
        assert ei.value.reason == "tenant_quota" and ei.value.tenant == "a"
        tickets.append(srv.both("submit", "b", [0.1]))
        with pytest.raises(tr.ServeOverload) as ei:
            srv.both("submit", "b", [0.7])
        assert ei.value.reason == "queue_depth"
        oj, ot = srv.both("flush")
        assert sorted(ot) == sorted(tk[1].id for tk in tickets) == sorted(oj)
        assert srv.s["t"].stats()["shed"] == 2 and srv.stats_equal()

    def test_injected_overflow_is_shed_and_counted(self):
        srv = _servers()
        jf.arm(jf.SERVE_QUEUE_OVERFLOW, times=1)
        tf.arm(tf.SERVE_QUEUE_OVERFLOW, times=1)
        with pytest.raises(tr.ServeOverload) as ei:
            srv.both("query", "a", [0.5])
        assert ei.value.reason == "injected"
        rj, rt = srv.both("query", "a", [0.5])
        _same_result(rj, rt)
        assert srv.s["t"].stats()["shed"] == 1 and srv.stats_equal()
        assert tr.health()["counters"]["serve.shed"] == jr.health()["counters"]["serve.shed"] == 1

    def test_shed_counts_mirror_telemetry(self):
        tt.enable()
        jt.enable()
        srv = _servers(max_queue_depth=1, tenant_quota=1, cache_capacity=0)
        srv.both("submit", "a", [0.5])
        with pytest.raises(tr.ServeOverload):
            srv.both("submit", "a", [0.9])
        srv.both("flush")
        for tel in (tt, jt):
            counters = tel.snapshot()["counters"]
            assert counters['serve.shed{reason="tenant_quota"}'] == 1
            assert counters["serve.requests"] == 2


# ---------------------------------------------------------------------------
# Deadline budgets
# ---------------------------------------------------------------------------


class TestDeadlines:
    def test_near_deadline_skips_to_floor_tier(self):
        srv = _servers(auto_step=0.0, cache_capacity=0, floor_margin_s=0.02)
        fresh = srv.both("query", "a", [0.5], deadline_s=10.0)
        assert fresh[1].tier == "wxla"
        near = srv.both("query", "a", [0.5], deadline_s=0.01)
        assert near[1].tier == "xla"
        _same_result(*fresh)
        _same_result(*near)
        assert np.array_equal(near[1].values, fresh[1].values)

    def test_floor_and_hedge_answer_through_the_floor_router(self, monkeypatch):
        """The near-deadline floor and a slow primary's hedge both answer
        through ``kernels.floor_quantile``, the one router of the ``xla``
        tier (K2 on the card), and equal the JAX package's answers."""
        from sketches_tpu_torch import kernels as tk

        routed = []
        real = tk.floor_quantile

        def spy(spec, state, qs):
            routed.append(state.n_streams)
            return real(spec, state, qs)

        monkeypatch.setattr(tk, "floor_quantile", spy)
        srv = _servers(auto_step=0.0, cache_capacity=0, floor_margin_s=0.02)
        near = srv.both("query", "a", [0.5], deadline_s=0.01)
        assert near[1].tier == "xla" and routed == [8]
        _same_result(*near)
        srv = _servers(auto_step=0.1, cache_capacity=0, hedge_after_s=0.05,
                       default_deadline_s=100.0, breaker_threshold=100)
        routed.clear()
        rj, rt = srv.both("query", "b", [0.5, 0.99])
        assert rt.hedged and rt.tier == "wxla" and routed == [4]
        _same_result(rj, rt, srv, "b", (0.5, 0.99))

    def test_spent_budget_raises_and_counts(self):
        srv = _servers(auto_step=0.0)
        with pytest.raises(tr.DeadlineExceeded):
            srv.both("query", "a", [0.5], deadline_s=0.0)
        assert srv.s["t"].stats()["deadline_misses"] == 1 and srv.stats_equal()
        assert tr.health()["counters"]["serve.deadline_misses"] == 1

    def test_late_answer_returned_but_counted(self):
        srv = _servers(auto_step=0.0, cache_capacity=0)
        tk = srv.both("submit", "a", [0.5], deadline_s=0.5)
        srv.advance(1.0)
        oj, ot = srv.both("flush")
        assert ot[tk[1].id].deadline_missed
        _same_result(oj[tk[0].id], ot[tk[1].id], srv, "a", (0.5,))
        assert srv.s["t"].stats()["deadline_misses"] == 1 and srv.stats_equal()


# ---------------------------------------------------------------------------
# Hedged retries
# ---------------------------------------------------------------------------


class TestHedging:
    def test_injected_straggler_is_hedged_around(self):
        srv = _servers(cache_capacity=0)
        want = srv.direct("a", (0.5, 0.99))
        jf.arm(jf.SERVE_STRAGGLER, times=1)
        tf.arm(tf.SERVE_STRAGGLER, times=1)
        rj, rt = srv.both("query", "a", [0.5, 0.99])
        assert rt.hedged and rt.tier == "xla"
        _same_result(rj, rt)
        assert np.array_equal(rt.values, want)
        assert srv.s["t"].stats()["hedges"] == 1 and srv.stats_equal()
        assert tr.health()["counters"]["serve.hedges"] == 1

    def test_slow_primary_hedge_discarded_bit_identically(self):
        srv = _servers(auto_step=0.1, cache_capacity=0, hedge_after_s=0.05,
                       default_deadline_s=100.0, breaker_threshold=100)
        rj, rt = srv.both("query", "a", [0.5])
        assert rt.hedged and rt.tier == "wxla"
        _same_result(rj, rt, srv, "a", (0.5,))
        assert srv.s["t"].stats()["hedges"] == 1 and srv.stats_equal()

    def test_hedge_kill_switch_restores_fail_loud(self, monkeypatch):
        monkeypatch.setenv(treg.SERVE_HEDGE.name, "0")
        srv = _servers(cache_capacity=0)
        jf.arm(jf.SERVE_STRAGGLER, times=1)
        tf.arm(tf.SERVE_STRAGGLER, times=1)
        with pytest.raises(tr.InjectedFault):
            srv.both("query", "a", [0.5])
        assert srv.s["t"].stats()["hedges"] == 0

    def test_straggling_stacked_flush_is_hedged(self):
        """An injected straggler on the stacked dispatch re-runs it: the
        hedge equals an unhedged flush bit for bit."""
        srv = _servers(cache_capacity=0)
        tks = [srv.s["t"].submit(n, [0.5]) for n in ("a", "b")]
        tf.arm(tf.SERVE_STRAGGLER, times=1)
        srv.s["t"].flush()
        tf.disarm()
        again = [srv.s["t"].submit(n, [0.5]) for n in ("a", "b")]
        srv.s["t"].flush()
        for tk, ref in zip(tks, again):
            assert tk.result.hedged and not ref.result.hedged
            assert np.array_equal(tk.result.values, ref.result.values)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


class TestBreaker:
    def test_open_half_open_close_walk(self):
        srv = _servers(auto_step=0.0, cache_capacity=0, breaker_threshold=2,
                       breaker_cooldown=2)

        def step(want_tier, hedged):
            rj, rt = srv.both("query", "a", [0.5])
            _same_result(rj, rt)
            assert (rt.tier, rt.hedged) == (want_tier, hedged)

        def state(want):
            assert srv.s["t"].breaker_state("wxla") == srv.s["j"].breaker_state("wxla") == want

        state("closed")
        jf.arm(jf.SERVE_STRAGGLER, tier="wxla", times=4)
        tf.arm(tf.SERVE_STRAGGLER, tier="wxla", times=4)
        for _ in range(2):
            step("xla", True)
        state("open")
        for _ in range(2):
            step("xla", False)
        state("half_open")
        step("xla", True)
        state("open")
        jf.disarm()
        tf.disarm()
        for _ in range(2):
            step("xla", False)
        state("half_open")
        step("wxla", False)
        state("closed")
        assert srv.s["t"].stats()["breaker_trips"] == 2 and srv.stats_equal()
        assert srv.s["t"].tenant("a")._query_disabled == set()

    def test_floor_tier_never_opens(self):
        srv = _servers(cache_capacity=0, breaker_threshold=1)
        jf.arm(jf.SERVE_STRAGGLER, tier="xla", times=1)
        tf.arm(tf.SERVE_STRAGGLER, tier="xla", times=1)
        rj, rt = srv.both("query", "a", [0.5], deadline_s=0.001)
        assert rt.hedged and rt.tier == "xla"
        _same_result(rj, rt)
        assert srv.s["t"].breaker_state("xla") == "closed"
        with pytest.raises(tr.SpecError):
            srv.s["t"].breaker_state("warp")


# ---------------------------------------------------------------------------
# Fingerprint-keyed cache + poison detection
# ---------------------------------------------------------------------------


class TestCache:
    def test_hit_bit_identical_and_write_invalidates(self):
        srv = _servers()
        cold = srv.both("query", "a", [0.5, 0.99])
        assert not cold[1].cached
        hit = srv.both("query", "a", [0.5, 0.99])
        assert hit[1].cached and np.array_equal(hit[1].values, cold[1].values)
        _same_result(*hit)
        srv.ingest("a", mid_bucket(np.random.RandomState(8).lognormal(0.0, 0.5, (8, 16))))
        warm = srv.both("query", "a", [0.5, 0.99])
        assert not warm[1].cached
        _same_result(*warm, srv, "a", (0.5, 0.99))
        assert srv.s["t"].stats()["cache_hits"] == 1 and srv.stats_equal()

    def test_cache_keys_are_the_jax_packages(self):
        """Tenant fingerprints are bit-equal across the packages, so cache
        keys (tenant, fingerprint digest, qs) are too."""
        srv = _servers()
        srv.both("query", "a", [0.5])
        assert list(srv.s["t"]._cache) == list(srv.s["j"]._cache)

    def test_poison_detect_quarantine_recompute(self):
        srv = _servers()
        srv.both("query", "b", [0.9])
        want = srv.direct("b", (0.9,))
        jf.arm(jf.SERVE_CACHE_POISON, times=1)
        tf.arm(tf.SERVE_CACHE_POISON, times=1)
        rj, rt = srv.both("query", "b", [0.9])
        jf.disarm()
        tf.disarm()
        assert not rt.cached and np.array_equal(rt.values, want)
        _same_result(rj, rt)
        assert srv.s["t"].stats()["cache_poisoned"] == 1 and srv.stats_equal()
        assert tr.health()["counters"]["serve.cache_poisoned"] == 1
        again = srv.both("query", "b", [0.9])
        assert again[1].cached and np.array_equal(again[1].values, want)

    def test_lru_bound(self):
        srv = _servers(cache_capacity=2)
        for q in (0.1, 0.2, 0.3):
            srv.both("query", "a", [q])
        assert srv.s["t"].stats()["cache_entries"] == 2
        assert not srv.both("query", "a", [0.1])[1].cached
        assert srv.both("query", "a", [0.3])[1].cached
        assert srv.stats_equal()

    def test_cache_kill_switch_booby_trap(self, monkeypatch):
        monkeypatch.setenv(treg.SERVE_CACHE.name, "0")
        srv = _servers()

        def _bomb(*a, **k):  # pragma: no cover - armed proof
            raise AssertionError("disabled cache touched the fingerprint")

        monkeypatch.setattr(ti, "fingerprint", _bomb)
        rt = srv.s["t"].query("a", [0.5])
        assert np.array_equal(rt.values, srv.direct("a", (0.5,)))
        assert srv.s["t"].stats()["cache_hits"] == srv.s["t"].stats()["cache_misses"] == 0

    def test_out_of_band_write_caught_by_invalidate(self):
        srv = _servers()
        srv.both("query", "a", [0.5])
        v = mid_bucket(np.random.RandomState(9).lognormal(0.0, 0.5, (8, 16)))
        for k in ("j", "t"):
            srv.s[k].tenant("a").add(v)
            srv.s[k].invalidate("a")
        rj, rt = srv.both("query", "a", [0.5])
        assert not rt.cached
        _same_result(rj, rt, srv, "a", (0.5,))


# ---------------------------------------------------------------------------
# Config validation, registry
# ---------------------------------------------------------------------------


class TestEnvelope:
    @pytest.mark.parametrize("bad", [
        dict(max_queue_depth=0), dict(tenant_quota=-1), dict(default_deadline_s=0.0),
        dict(breaker_threshold=0), dict(cache_capacity=-1),
    ])
    def test_config_validation(self, bad):
        with pytest.raises(tr.SpecError):
            ts.ServeConfig(**bad)

    def test_kill_switches_registered(self):
        for var in (treg.SERVE_CACHE, treg.SERVE_HEDGE):
            assert treg.lookup(var.name).owner == "sketches_tpu_torch.serve"
            assert treg.get(var) == "1"

    def test_serve_slos_declared(self):
        names = {slo.name for slo in tt.SLOS}
        assert {"serve-shed", "serve-deadline"} <= names


# ---------------------------------------------------------------------------
# Windowed tenants: quantile(tenant, q, window=...) on fingerprint-set keys
# ---------------------------------------------------------------------------


class TestWindowedServe:
    def _servers(self, t0=100.0):
        srv = Servers()
        for k in ("j", "t"):
            srv.clocks[k] = (jw if k == "j" else tw).VirtualClock(t0)
            srv.s[k] = PKG[k][0].SketchServer(clock=srv.clocks[k])
        srv.add("w", 4, j={"window": CFG[0]}, t={"window": CFG[1]})
        rng = np.random.default_rng(13)
        srv.ingest("w", mid_bucket(rng.lognormal(0, 0.5, (4, 16))))
        return srv, rng

    def test_hit_then_ingest_misses(self):
        srv, rng = self._servers()
        r1 = srv.both("quantile", "w", [0.5, 0.99], window=15.0)
        assert r1[1].tier == "window"
        _same_result(*r1)
        r2 = srv.both("quantile", "w", [0.5, 0.99], window=15.0)
        assert r2[1].cached and np.array_equal(r1[1].values, r2[1].values, equal_nan=True)
        srv.ingest("w", mid_bucket(rng.lognormal(0, 0.5, (4, 16))))
        assert srv.both("quantile", "w", [0.5, 0.99], window=15.0)[1].tier == "window"
        assert srv.stats_equal()

    def test_rotation_can_never_serve_stale_wrong(self):
        srv, rng = self._servers()
        for step in range(10):
            srv.both("quantile", "w", [0.5, 0.99], window=15.0)
            srv.advance(float(rng.uniform(1.0, 7.0)))
            srv.ingest("w", mid_bucket(rng.lognormal(0, 0.5, (4, 16))))
            rj, rt = srv.both("quantile", "w", [0.5, 0.99], window=15.0)
            _same_result(rj, rt)
            direct = host(srv.s["t"].tenant("w").quantile([0.5, 0.99], window=15.0))
            assert np.array_equal(rt.values, direct, equal_nan=True), step
            oracle = host(tw.oracle_quantile(srv.s["t"].tenant("w"), [0.5, 0.99], window=15.0))
            assert np.array_equal(rt.values, oracle, equal_nan=True), step
        assert srv.stats_equal()

    def test_rotation_without_content_change_hits_correctly(self):
        srv, rng = self._servers()
        r1 = srv.both("quantile", "w", [0.5], window=15.0)
        srv.advance(6.0)
        r2 = srv.both("quantile", "w", [0.5], window=15.0)
        _same_result(*r2)
        assert np.array_equal(r1[1].values, r2[1].values, equal_nan=True)

    def test_cache_poison_recomputes(self):
        srv, rng = self._servers()
        srv.both("quantile", "w", [0.9], window=15.0)
        direct = host(srv.s["t"].tenant("w").quantile([0.9], window=15.0))
        jf.arm(jf.SERVE_CACHE_POISON, times=1)
        tf.arm(tf.SERVE_CACHE_POISON, times=1)
        rj, rt = srv.both("quantile", "w", [0.9], window=15.0)
        assert not rt.cached and np.array_equal(rt.values, direct, equal_nan=True)
        _same_result(rj, rt)
        assert srv.s["t"].stats()["cache_poisoned"] == 1 and srv.stats_equal()

    def test_submit_path_refuses_windowed_tenant(self):
        srv, _ = self._servers()
        with pytest.raises(tr.SpecError, match="window"):
            srv.both("query", "w", [0.5])

    def test_plain_tenant_window_query_refuses(self):
        srv, rng = self._servers()
        srv.add("p", 4)
        with pytest.raises(tr.SpecError, match="not time-windowed"):
            srv.both("quantile", "p", [0.5], window=5.0)
        srv.ingest("p", mid_bucket(rng.lognormal(0, 0.5, (4, 16))))
        rj, rt = srv.both("quantile", "p", [0.5])
        assert rt.values.shape == (4, 1) and rt.tier != "window"
        _same_result(rj, rt)

    def test_spent_deadline_refuses(self):
        srv, _ = self._servers()
        with pytest.raises(tr.DeadlineExceeded):
            srv.both("quantile", "w", [0.5], window=15.0, deadline_s=0.0)

    def test_quantile_many_stacks_one_fused_dispatch(self):
        srv = Servers()
        for k in ("j", "t"):
            srv.clocks[k] = (jw if k == "j" else tw).VirtualClock(100.0)
            srv.s[k] = PKG[k][0].SketchServer(clock=srv.clocks[k])
        rng = np.random.default_rng(26)
        for name in ("a", "b", "c"):
            srv.add(name, 4, j={"window": CFG[0]}, t={"window": CFG[1]})
            for _ in range(4):
                srv.advance(2.0)
                srv.ingest(name, mid_bucket(rng.lognormal(0, 0.5, (4, 16))))
        before = srv.s["t"].stats()["fused_dispatches"]
        oj, ot = srv.both("quantile_many", ["a", "b", "c"], [0.5, 0.99], window=15.0)
        assert set(ot) == {"a", "b", "c"}
        assert srv.s["t"].stats()["fused_dispatches"] == before + 1 and srv.stats_equal()
        for name in ("a", "b", "c"):
            facade = srv.s["t"].tenant(name)
            direct = host(facade.query_plan(facade.window_plan(15.0), (0.5, 0.99)))
            assert np.array_equal(ot[name].values, direct, equal_nan=True), name
            assert ot[name].tier == "window"
            _same_result(oj[name], ot[name])
        assert srv.s["t"].quantile("a", [0.5, 0.99], window=15.0).cached
        out2 = srv.s["t"].quantile_many(["a", "b"], [0.5, 0.99], window=15.0)
        assert all(r.tier == "cache" for r in out2.values())

    def test_quantile_many_edge_cases(self):
        srv, _ = self._servers()
        assert srv.s["t"].quantile_many([], [0.5], window=15.0) == {}
        srv.add("p", 4)
        with pytest.raises(tr.SpecError, match="not time-windowed"):
            srv.both("quantile_many", ["w", "p"], [0.5], window=15.0)
        with pytest.raises(tr.DeadlineExceeded):
            srv.both("quantile_many", ["w"], [0.5], window=15.0, deadline_s=0.0)
