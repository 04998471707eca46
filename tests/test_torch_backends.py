"""The port's accuracy backends (``sketches_tpu_torch.backends``) against
``sketches_tpu.backends`` on the same seeded numpy inputs, on the CPU.

Tolerances, with their reasons:

* **Exact** for collapse levels, bins, key offsets, occupied bounds, tile
  sums and every mass counter on integer-valued states (unit weights or
  random integer bins): the pair-sum collapse and the JAX package's
  scatter add the same two numbers.  Exact for the keys ``premap_values``
  leads to, and for the moment counters and the moment solve on equal f32
  states (the numpy solve is the same code).
* **rtol 2e-6** for level-corrected quantiles and the premapped ``min`` /
  ``max``: the corrected decode is one ``exp`` (and ``premap_values`` one
  base decode), which may differ by a few ulps between XLA:CPU and torch.
* **atol 1e-5 * sum|v|** for the ``sum`` leaf (f32 sums in another order).
* **1e-5 * sum|w * term|** for the moment power sums and ``sum`` (f32 sums
  of up to S terms in another reduction order; odd powers of mixed signs,
  and of ``ln|v|`` either side of 1, cancel, so a relative tolerance on
  the result would not hold), with NaN and infinity positions equal:
  ``v**12`` overflows to inf on heavy tails on both sides.

The collapse, merge, psum and fold tests run at ``max_collapses=3``:
the JAX package unrolls ``max_collapses`` collapses under ``jit``, and
compiling ten of them takes longer than the whole file should.  The
list-form ``psum_merge`` is held to the JAX package's fold algebra on one
device (``collapse_to`` the elementwise max level, then ``merge_axis``),
which is what its ``shard_map`` form computes.

Ingest data sits mid-bucket (XLA:CPU's f32 ``log`` is not correctly
rounded, so a value within an ulp of a bucket edge can key one bucket
apart; ROADMAP queue C).  Every JAX result is waited for
(``jax.block_until_ready``) before the port's side runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sketches_tpu import batched as jb
from sketches_tpu.backends import BACKEND_ENUM as J_ENUM
from sketches_tpu.backends import facade_for as j_facade_for
from sketches_tpu.backends import moment as JM
from sketches_tpu.backends import uniform as JU
from sketches_tpu.resilience import ShardLossError as JShardLossError
from sketches_tpu_torch import BatchedDDSketch, convert
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch.backends import BACKEND_ENUM, BACKEND_NAMES, facade_for
from sketches_tpu_torch.backends import moment as TM
from sketches_tpu_torch.backends import uniform as TU
from sketches_tpu_torch.resilience import (
    ShardLossError,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

LEAVES = tb.LEAVES
ALPHA = 0.01
GAMMA = (1 + ALPHA) / (1 - ALPHA)
QS = [0.0, 0.1, 0.5, 0.9, 0.99, 1.0, -0.1]
MQS = [0.05, 0.25, 0.5, 0.75, 0.95, 0.99]


def _aspecs(n_bins=256, thr=0.05, int_bins=False, max_collapses=10):
    kw = dict(relative_accuracy=ALPHA, n_bins=n_bins, backend="uniform_collapse",
              collapse_threshold=thr, max_collapses=max_collapses)
    return (jb.SketchSpec(**kw, **({"bin_dtype": jnp.int32} if int_bins else {})),
            tb.SketchSpec(**kw, **({"bin_dtype": torch.int32} if int_bins else {})))


def _mspecs(k=12):
    kw = dict(relative_accuracy=ALPHA, backend="moment", n_moments=k)
    return jb.SketchSpec(**kw), tb.SketchSpec(**kw)


def _mid_bucket(v):
    """Each nonzero value moved to the middle of its bucket in log space."""
    a = np.abs(v).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.ceil(np.log(a) / np.log(GAMMA))
        out = np.sign(v) * GAMMA ** (k - 0.5)
    return np.where(np.isfinite(out) & (a > 0), out, v).astype(np.float32)


def _batch(r, n, s, sigma, neg=0.3):
    v = r.lognormal(0, sigma, (n, s)) * np.where(r.rand(n, s) < neg, -1, 1)
    return _mid_bucket(v)


def _jax_adaptive(astate):
    return {**{f: np.asarray(getattr(astate.base, f)) for f in LEAVES},
            "level": np.asarray(astate.level)}


def _port_adaptive(spec_t, jstate):
    return convert.adaptive_from_numpy(spec_t, _jax_adaptive(jstate), device="cpu")


def _port_moment(spec_t, jstate):
    return convert.moment_from_numpy(
        spec_t, {f: np.asarray(getattr(jstate, f)) for f in TM.FIELDS}, device="cpu")


def assert_adaptive_equal(got, ref, *, sum_scale=None, value_rtol=None):
    """Port ``AdaptiveState`` vs JAX: every leaf exact, except ``sum`` within
    ``sum_scale`` and, with ``value_rtol``, ``min``/``max`` within it."""
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(ref.level))
    for f in LEAVES:
        g, r = getattr(got.base, f).numpy(), np.asarray(getattr(ref.base, f))
        assert g.dtype == r.dtype, f
        if f == "sum" and sum_scale is not None:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * sum_scale, err_msg=f)
        elif f in ("min", "max") and value_rtol is not None:
            np.testing.assert_allclose(g, r, rtol=value_rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def _random_adaptive(n, spec_j, seed):
    """A random integer-valued adaptive state (both key-offset parities,
    every level up to the cap) as numpy leaves."""
    r = np.random.RandomState(seed)
    b = spec_j.n_bins
    bd = np.dtype(jnp.dtype(spec_j.bin_dtype).name)
    pos = np.where(r.rand(n, b) < 0.3, r.randint(1, 50, (n, b)), 0).astype(bd)
    neg = np.where(r.rand(n, b) < 0.15, r.randint(1, 50, (n, b)), 0).astype(bd)
    pos[:4] = 0  # empty positive stores
    neg[4:8] = 0
    zero = r.randint(0, 20, n).astype(bd)
    lo, hi = tb.occupied_bounds_np(pos)
    nlo, nhi = tb.occupied_bounds_np(neg)
    leaves = {
        "bins_pos": pos, "bins_neg": neg, "zero_count": zero,
        "count": (pos.sum(-1) + neg.sum(-1) + zero).astype(bd),
        "sum": r.randn(n).astype(np.float32), "min": -r.rand(n).astype(np.float32),
        "max": r.rand(n).astype(np.float32),
        "collapsed_low": r.randint(0, 5, n).astype(bd),
        "collapsed_high": r.randint(0, 5, n).astype(bd),
        "key_offset": r.randint(-600, 200, n).astype(np.int32),
        "pos_lo": lo, "pos_hi": hi, "neg_lo": nlo, "neg_hi": nhi,
        "neg_total": neg.sum(-1).astype(bd),
        "tile_sums": tb.tile_sums_np(pos, neg).astype(bd),
        "level": r.randint(0, spec_j.max_collapses + 1, n).astype(np.int32),
    }
    jstate = JU.AdaptiveState(
        jb.SketchState(**{f: jnp.asarray(leaves[f]) for f in LEAVES}),
        jnp.asarray(leaves["level"]),
    )
    return jstate, leaves


# ---------------------------------------------------------------------------
# The seam: enum table, facade_for
# ---------------------------------------------------------------------------


def test_wire_enum_table_is_the_jax_packages():
    assert BACKEND_ENUM == J_ENUM == {"dense": 0, "uniform_collapse": 1, "moment": 2,
                                      "windowed": 3}
    assert BACKEND_NAMES == {v: k for k, v in J_ENUM.items()}


def test_facade_for_dispatch_and_spec_errors():
    sa, ta = _aspecs()
    sm, tm = _mspecs()
    assert isinstance(facade_for(2, spec=ta, device="cpu"), TU.AdaptiveDDSketch)
    assert isinstance(facade_for(2, spec=tm, device="cpu"), TM.MomentDDSketch)
    assert isinstance(facade_for(2, spec=tb.SketchSpec(n_bins=128), device="cpu"),
                      BatchedDDSketch)
    got = facade_for(2, backend="moment", n_moments=8, device="cpu")
    ref = j_facade_for(2, backend="moment", n_moments=8)
    assert isinstance(got, TM.MomentDDSketch) and got.spec.n_moments == ref.spec.n_moments == 8
    for call in (
        lambda f: f(2, backend="moment", spec=ta if f is facade_for else sa),
        lambda f: f(2, backend="btree"),
    ):
        with pytest.raises(jb.SpecError):
            call(j_facade_for)
        with pytest.raises(SpecError):
            call(facade_for)
    with pytest.raises(SpecError, match="uniform_collapse"):
        TU.AdaptiveDDSketch(2, spec=tm, device="cpu")
    with pytest.raises(SpecError, match="moment"):
        TM.MomentDDSketch(2, spec=ta, device="cpu")
    with pytest.raises(SpecError):  # no card and no device="cpu"
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        TU.AdaptiveDDSketch(2)


# ---------------------------------------------------------------------------
# Uniform collapse: pure transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bins,int_bins", [(256, False), (128, False), (256, True)])
def test_collapse_once_and_collapse_to_match_jax(n_bins, int_bins):
    # 64 streams at 256 bins: the merge, psum and fold tests' shapes, whose
    # eager JAX collapses then reuse these compilations.
    sj, st = _aspecs(n_bins=n_bins, int_bins=int_bins, max_collapses=3)
    jstate, leaves = _random_adaptive(64, sj, seed=n_bins + int_bins)
    tstate = convert.adaptive_from_numpy(st, leaves, device="cpu")
    mask = np.random.RandomState(3).rand(64) < 0.7
    ref = jax.block_until_ready(JU.collapse_once(sj, jstate, jnp.asarray(mask)))
    assert_adaptive_equal(TU.collapse_once(st, tstate, torch.from_numpy(mask)), ref)
    ref = jax.block_until_ready(JU.collapse_once(sj, jstate))
    got = TU.collapse_once(st, tstate)
    assert_adaptive_equal(got, ref)
    assert np.array_equal(got.base.bins_pos.double().sum(-1).numpy(),
                          leaves["bins_pos"].astype(np.float64).sum(-1))
    target = np.random.RandomState(4).randint(0, sj.max_collapses + 2, 64).astype(np.int32)
    ref = jax.block_until_ready(JU.collapse_to(sj, jstate, jnp.asarray(target)))
    assert_adaptive_equal(TU.collapse_to(st, tstate, torch.from_numpy(target)), ref)


def test_premap_values_lands_on_the_jax_keys():
    sj, st = _aspecs(n_bins=512)
    r = np.random.RandomState(1)
    v = _batch(r, 6, 512, 3.0)
    v[:, :4] = [0.0, np.nan, 1e-40, -0.0]
    level = np.array([0, 1, 2, 4, 7, 10], np.int32)
    uj = np.asarray(jax.block_until_ready(JU.premap_values(sj, jnp.asarray(level), v)))
    ut = TU.premap_values(st, torch.from_numpy(level), torch.from_numpy(v)).numpy()
    live = np.abs(uj) >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(np.isnan(ut), np.isnan(uj))
    np.testing.assert_array_equal(ut[~live & ~np.isnan(uj)], uj[~live & ~np.isnan(uj)])
    kj = np.asarray(sj.mapping.key_array(jnp.asarray(np.abs(uj[live]))))
    kt = st.mapping.key_array(torch.from_numpy(np.abs(ut[live]))).numpy()
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(np.sign(ut[live]), np.sign(v[live]))
    np.testing.assert_array_equal(ut[0], v[0])  # level 0 passes through
    np.testing.assert_allclose(ut[live], uj[live], rtol=2e-6)


def test_effective_alpha_gamma_and_correct_values_match_jax():
    sj, st = _aspecs()
    lv = np.arange(0, 11, dtype=np.int32)
    for jf, tf in ((JU.effective_alpha, TU.effective_alpha),
                   (JU.effective_gamma, TU.effective_gamma)):
        np.testing.assert_allclose(tf(st, torch.from_numpy(lv)).numpy(),
                                   np.asarray(jf(sj, jnp.asarray(lv))), rtol=2e-6)
    r = np.random.RandomState(2)
    vals = _batch(r, 11, 7, 2.0)
    vals[:, 0] = [np.nan, 0.0] + [1.0] * 9
    # JAX eager: under jit, XLA:CPU rewrites the decode's arithmetic (up to
    # 128 ulp; ROADMAP queue C).
    ref = np.asarray(jax.block_until_ready(
        JU.correct_values(sj, jnp.asarray(lv), jnp.asarray(vals))))
    got = TU.correct_values(st, torch.from_numpy(lv), torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, equal_nan=True)
    np.testing.assert_array_equal(got[0], vals[0])


# ---------------------------------------------------------------------------
# The adaptive facade
# ---------------------------------------------------------------------------


_FORCED_N = 128


def _forced_batches():
    r = np.random.RandomState(5)
    return [_batch(r, _FORCED_N, 256, sigma) for sigma in (0.5, 2.0, 4.0, 1.0)]


def _drive_forced(sk, batches):
    """Widening regimes (the pre-ingest guard and the post-ingest trigger),
    an explicit collapse of every third stream, one more batch."""
    for v in batches[:3]:
        sk.add(v)
    sk.collapse(np.arange(_FORCED_N) % 3 == 0)
    sk.add(batches[3])
    return sk


@pytest.fixture(scope="module")
def forced_jax():
    sj, _ = _aspecs(n_bins=256)
    j = _drive_forced(JU.AdaptiveDDSketch(_FORCED_N, spec=sj), _forced_batches())
    # The level correction in JAX eager: the facade's jitted decode may
    # differ from it by up to 128 ulp (XLA:CPU rewrites the arithmetic under
    # jit; ROADMAP queue C).  Every stream here has collapsed, so the eager
    # correction recomputes every answer from its (exact) level key.
    assert int(np.asarray(j.level).min()) >= 1
    base = jax.jit(functools.partial(jb.quantile, sj))(j.state.base, jnp.asarray(QS))
    jq = jax.block_until_ready(JU.correct_values(sj, j.level, base))
    return j, jq, {
        "effective_alpha": np.asarray(j.effective_alpha()),
        "collapsed_fraction": np.asarray(j.collapsed_fraction()),
    }


@pytest.mark.parametrize("engine", ["plain", "auto"])
def test_adaptive_ingest_with_forced_collapse_matches_jax(engine, forced_jax):
    """The state equals the JAX facade's (levels, bins, counters exactly);
    quantiles within rtol 2e-6 of JAX eager on that state."""
    _, st = _aspecs(n_bins=256)
    j, jq, jextra = forced_jax
    batches = _forced_batches()
    t = _drive_forced(TU.AdaptiveDDSketch(_FORCED_N, spec=st, engine=engine, device="cpu"),
                      batches)
    scale = float(sum(np.abs(v).sum() for v in batches))
    assert int(t.level.min()) >= 1 and int(t.level.max()) > int(t.level.min())
    assert_adaptive_equal(t.state, j.state, sum_scale=scale, value_rtol=2e-6)
    np.testing.assert_allclose(t.get_quantile_values(QS).numpy(), np.asarray(jq), rtol=2e-6,
                               equal_nan=True)
    # The plain level-corrected quantile too.
    np.testing.assert_allclose(TU.quantile(st, t.state, QS).numpy(), np.asarray(jq),
                               rtol=2e-6, equal_nan=True)
    np.testing.assert_allclose(t.effective_alpha().numpy(), jextra["effective_alpha"],
                               rtol=2e-6)
    np.testing.assert_array_equal(t.collapsed_fraction().numpy(), jextra["collapsed_fraction"])
    tier, vals = t.get_quantile_values_resolved(QS, disabled_tiers=("overlap",))
    np.testing.assert_array_equal(vals.numpy(), t.get_quantile_values(QS).numpy())


def test_adaptive_nan_contract_and_merge_spec_mismatch():
    _, st = _aspecs()
    t = TU.AdaptiveDDSketch(2, spec=st, device="cpu")
    assert torch.isnan(t.get_quantile_values([0.5])).all()
    t.add(np.ones((2, 4), np.float32))
    out = t.get_quantile_values([-0.1, 0.5, 1.5])
    assert torch.isnan(out[:, 0]).all() and torch.isnan(out[:, 2]).all()
    assert torch.isfinite(out[:, 1]).all()
    other = TU.AdaptiveDDSketch(2, spec=_aspecs(thr=0.2)[1], device="cpu")
    with pytest.raises(UnequalSketchParametersError):
        t.merge(other)


def _to_jax(astate):
    """A port ``AdaptiveState`` as the JAX package's (host copies)."""
    leaves = convert.adaptive_to_numpy(astate)
    return JU.AdaptiveState(
        jb.SketchState(**{f: jnp.asarray(leaves[f]) for f in LEAVES}),
        jnp.asarray(leaves["level"]),
    )


def _centred(st, n, v):
    """A port adaptive state holding ``v`` on windows centred on it (the
    inputs of the merge tests: built by the port, handed to both sides)."""
    a = TU.init(st, n, "cpu")
    v = torch.from_numpy(v)
    base = tb.recenter(st, a.base, tb.auto_offset(st, a.base, v))
    return TU.AdaptiveState(tb.add(st, base, v), a.level)


def test_mixed_level_merge_matches_jax():
    sj, st = _aspecs(n_bins=256, max_collapses=3)
    n = 64
    r = np.random.RandomState(6)
    va, vb = _batch(r, n, 256, 1.0), _batch(r, n, 512, 3.0)
    ta, tb_ = _centred(st, n, va), TU.collapse_once(st, _centred(st, n, vb))
    # Collapse, recenter and merge move integer masses only: jit is exact.
    ref = jax.block_until_ready(jax.jit(functools.partial(JU.merge, sj))(_to_jax(ta),
                                                                        _to_jax(tb_)))
    got = TU.merge(st, ta, tb_)
    scale = float(np.abs(va).sum() + np.abs(vb).sum())
    assert_adaptive_equal(got, ref, sum_scale=scale)
    assert int(got.level.min()) >= 1
    # The facade's merge is the same alignment, committed in place.
    fa = TU.AdaptiveDDSketch(n, spec=st, state=ta, device="cpu")
    fa.merge(TU.AdaptiveDDSketch(n, spec=st, state=tb_, device="cpu"))
    assert_adaptive_equal(fa.state, ref, sum_scale=scale)
    assert float(fa.count.double().sum()) == va.size + vb.size
    np.testing.assert_array_equal(fa.get_quantile_values(QS).numpy(),
                                  TU.quantile(st, got, QS).numpy())


def _partials(sj, st, k, seed, collapsed=(2,)):
    r = np.random.RandomState(seed)
    tparts = []
    for i in range(k):
        v = torch.from_numpy(_mid_bucket(r.lognormal(0, 0.5, (64, 128))))
        a = TU.init(st, 64, "cpu")
        a = TU.AdaptiveState(tb.add(st, a.base, v), a.level)
        tparts.append(TU.collapse_once(st, a) if i in collapsed else a)
    return [_to_jax(p) for p in tparts], tparts


def test_merge_equals_merge_then_collapse_reference_fingerprints_match_jax():
    """``test_backends``' merge-then-collapse acceptance on the port: the
    mixed-gamma merge collapsed one level deeper fingerprints like the
    merge of the operands collapsed first, and each fingerprint equals the
    JAX package's on the same (mid-bucket) traffic."""
    from sketches_tpu import integrity as ji
    from sketches_tpu_torch import integrity as ti

    sj, st = _aspecs(n_bins=128)
    r = np.random.RandomState(5)
    va = _mid_bucket(r.lognormal(0, 1.0, (2, 512)))
    vb = _mid_bucket(r.lognormal(1.0, 2.5, (2, 1024)))
    fps = []
    for U, spec, integrity, wrap in (
        (JU, sj, ji, jnp.asarray), (TU, st, ti, torch.as_tensor),
    ):
        a = U.AdaptiveDDSketch(2, spec=spec, **({} if U is JU else {"device": "cpu"}))
        b = U.AdaptiveDDSketch(2, spec=spec, **({} if U is JU else {"device": "cpu"}))
        a.add(va)
        b.add(vb)
        merged = U.merge(spec, a.state, b.state)
        deeper = wrap(np.asarray(merged.level) + 1)
        lhs = U.collapse_to(spec, merged, deeper)
        rhs = U.merge(spec, U.collapse_to(spec, a.state, deeper),
                      U.collapse_to(spec, b.state, deeper))
        fl, fr = integrity.fingerprint(spec, lhs.base), integrity.fingerprint(spec, rhs.base)
        np.testing.assert_allclose(fl, fr, rtol=1e-9, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(lhs.base.count), np.asarray(rhs.base.count))
        fps.append((fl, fr))
    for j, t in zip(*fps):
        np.testing.assert_array_equal(t, j)


def test_psum_merge_list_form_matches_jax():
    sj, st = _aspecs(n_bins=256, max_collapses=3)
    jparts, tparts = _partials(sj, st, 4, seed=7)
    target = functools.reduce(jnp.maximum, [p.level for p in jparts])

    @jax.jit
    def fold(parts, target):  # integer masses: jit is exact
        aligned = [JU.collapse_to(sj, p, target) for p in parts]
        return jb.merge_axis(sj, jax.tree.map(lambda *xs: jnp.stack(xs),
                                              *[p.base for p in aligned]))

    ref = jax.block_until_ready(JU.AdaptiveState(fold(jparts, target), target))
    got = TU.psum_merge(st, tparts)
    assert_adaptive_equal(got, ref, sum_scale=64 * 128 * 4 * 10.0)
    got2 = TU.psum_merge(st, tparts, n_hosts=2)
    assert_adaptive_equal(got2, ref, sum_scale=64 * 128 * 4 * 10.0)
    with pytest.raises(SketchValueError):
        TU.psum_merge(st, [])


@pytest.mark.parametrize("reachable", [None, [True, False, True], [False, False, False]])
def test_fold_hosts_matches_jax(reachable):
    sj, st = _aspecs(n_bins=256, max_collapses=3)
    jparts, tparts = _partials(sj, st, 3, seed=8, collapsed=(1,))
    if reachable is not None and not any(reachable):
        with pytest.raises(JShardLossError):
            JU.fold_hosts(sj, jparts, reachable=reachable)
        with pytest.raises(ShardLossError):
            TU.fold_hosts(st, tparts, reachable=reachable)
        return
    ref, rrep = JU.fold_hosts(sj, jparts, reachable=reachable)
    ref = jax.block_until_ready(ref)
    got, rep = TU.fold_hosts(st, tparts, reachable=reachable)
    assert_adaptive_equal(got, ref, sum_scale=64 * 128 * 3 * 10.0)
    np.testing.assert_array_equal(rep.live, rrep.live)
    np.testing.assert_array_equal(rep.dropped_count, rrep.dropped_count)
    np.testing.assert_array_equal(rep.surviving_count, rrep.surviving_count)


def test_kill_switch_refuses_both_triggers(monkeypatch):
    """``SKETCHES_TPU_ADAPTIVE=0``: an explicit collapse, an ingest whose
    guard or trigger would collapse, and a merge that needs a collapse all
    raise ``SpecError`` and leave the facade as it was."""
    _, st = _aspecs(thr=0.02)
    r = np.random.RandomState(3)
    t = TU.AdaptiveDDSketch(4, spec=st, device="cpu")
    t.add(r.lognormal(0, 0.3, (4, 256)).astype(np.float32))
    other = TU.AdaptiveDDSketch(4, spec=st, device="cpu")
    other.add(np.ones((4, 8), np.float32))
    other.collapse()
    before = {f: getattr(t.state.base, f).clone() for f in LEAVES}
    monkeypatch.setenv(TU.ADAPTIVE_ENV, "0")
    with pytest.raises(SpecError, match="SKETCHES_TPU_ADAPTIVE"):
        t.collapse()
    with pytest.raises(SpecError, match="SKETCHES_TPU_ADAPTIVE"):
        t.add(r.lognormal(0, 6.0, (4, 1024)).astype(np.float32))
    with pytest.raises(SpecError, match="mixed-gamma"):
        t.merge(other)
    for f in LEAVES:
        assert torch.equal(getattr(t.state.base, f), before[f]), f
    assert int(t.level.max()) == 0
    # The post-ingest trigger alone: a pinned window that clamps.
    p = TU.AdaptiveDDSketch(2, relative_accuracy=ALPHA, n_bins=128, key_offset=-64,
                            collapse_threshold=0.02, device="cpu")
    with pytest.raises(SpecError, match="uniform collapse triggered"):
        p.add(np.full((2, 64), 50.0, np.float32))
    monkeypatch.setenv(TU.ADAPTIVE_ENV, "1")
    p.add(np.full((2, 64), 50.0, np.float32))
    assert int(p.level.min()) >= 1


# ---------------------------------------------------------------------------
# Moment backend
# ---------------------------------------------------------------------------


def _moment_values(seed, n=96, s=256):
    r = np.random.RandomState(seed)
    v = (r.lognormal(0, 1.0, (n, s)) * np.where(r.rand(n, s) < 0.2, -1, 1)).astype(np.float32)
    v[: n // 4] = r.lognormal(0, 6.0, (n // 4, s)).astype(np.float32)  # v**12 overflows
    u = r.rand(n, s)
    v[u < 0.03] = 0.0
    v[(u > 0.03) & (u < 0.04)] = np.nan
    v[(u > 0.04) & (u < 0.05)] = 1e-40
    w = np.where(r.rand(n, s) < 0.1, 0.0, r.choice([1.0, 0.5, 2.0], (n, s))).astype(np.float32)
    v[-1] = np.nan
    w[-2] = 0.0  # an empty stream
    return v, w


def _assert_close_inf_aware(g, r, scale, what):
    """NaN and infinity positions equal; elsewhere |g - r| <= 1e-5 * scale."""
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=what)
    inf = np.isinf(g) | np.isinf(r)
    np.testing.assert_array_equal(g[inf], r[inf], err_msg=what)
    ok = ~np.isnan(g) & ~inf
    bad = np.abs(g[ok].astype(np.float64) - r[ok]) > 1e-5 * scale[ok]
    assert not bad.any(), (what, g[ok][bad][:4], r[ok][bad][:4])


def _term_scales(v, w, k):
    """sum over each row of |w * v**j| and |w * ln|v|**j|, j = 1..k, in f64,
    over the lanes a moment sum takes (live, |v| >= FLT_MIN, not NaN)."""
    w = np.ones_like(v) if w is None else w
    a = np.abs(v.astype(np.float64))
    take = (w > 0) & (a >= np.finfo(np.float32).tiny)
    a = np.where(take, a, 1.0)
    wl = np.where(take, w, 0.0)
    la = np.abs(np.log(a))
    p = np.stack([(wl * a**j).sum(-1) for j in range(1, k + 1)], -1)
    lp = np.stack([(wl * la**j).sum(-1) for j in range(1, k + 1)], -1)
    return p, lp, (wl * a).sum(-1)


@pytest.mark.parametrize("weighted", [False, True])
def test_moment_add_matches_jax(weighted):
    sj, st = _mspecs(12)
    v, w = _moment_values(11)
    w = w if weighted else None
    ref = jax.jit(functools.partial(JM.add, sj))(
        JM.init(sj, 96), jnp.asarray(v), None if w is None else jnp.asarray(w))
    ref = jax.block_until_ready(ref)
    got = TM.add(st, TM.init(st, 96, "cpu"), torch.from_numpy(v),
                 None if w is None else torch.from_numpy(w))
    p_scale, lp_scale, sum_scale = _term_scales(v, w, 12)
    for f in TM.FIELDS:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape, f
        if f in ("min", "max", "zero_count") or (f in ("count", "neg_count") and not weighted):
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            scale = {"powers": p_scale, "log_powers": lp_scale, "sum": sum_scale}.get(f)
            _assert_close_inf_aware(g, r, np.abs(r) if scale is None else scale, f)
    assert np.isinf(got.powers[0, -1].item()) and np.isnan(got.sum[-1].item())


def test_moment_quantiles_bit_equal_on_a_converted_jax_state():
    sj, st = _mspecs(12)
    v, w = _moment_values(12, n=48)
    j = JM.MomentDDSketch(48, spec=sj)
    jax.block_until_ready(j.add(v[:, :128], w[:, :128]).add(v[:, 128:], w[:, 128:]).state.powers)
    tstate = _port_moment(st, j.state)
    np.testing.assert_array_equal(TM.quantile(st, tstate, MQS), JM.quantile(sj, j.state, MQS))
    t = TM.MomentDDSketch(48, spec=st, state=tstate, device="cpu")
    assert t.get_quantile_values_resolved(MQS, disabled_tiers=("overlap",))[0] == "moment"
    np.testing.assert_array_equal(t.get_quantile_values(MQS), j.get_quantile_values(MQS))
    np.testing.assert_array_equal(t.get_quantile_value(0.5), j.get_quantile_value(0.5))
    odd = [-0.1, 0.5, 1.5]
    out = t.get_quantile_values(odd)
    np.testing.assert_array_equal(out, j.get_quantile_values(odd))
    assert np.isnan(out[:-1, [0, 2]]).all() and np.isnan(out[-2]).all()  # empty stream
    assert (out[-1] == 0.0).all()  # a zero-only stream (all NaN) answers 0


def test_moment_merge_psum_and_fold_hosts_match_jax():
    sj, st = _mspecs(8)
    r = np.random.RandomState(9)
    add = jax.jit(functools.partial(JM.add, sj))
    parts_j = [jax.block_until_ready(add(JM.init(sj, 32), jnp.asarray(
        r.lognormal(0, 1.5, (32, 64)).astype(np.float32)))) for _ in range(4)]
    parts_t = [_port_moment(st, p) for p in parts_j]
    ref = jax.block_until_ready(functools.reduce(lambda a, b: JM.merge(sj, a, b), parts_j))
    for got in (TM.psum_merge(st, parts_t), TM.psum_merge(st, parts_t, n_hosts=1),
                functools.reduce(lambda a, b: TM.merge(st, a, b), parts_t)):
        for f in TM.FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), *parts_j)
    stacked_t = TM.MomentState(**{f: torch.stack([getattr(p, f) for p in parts_t])
                                  for f in TM.FIELDS})
    mref = jax.block_until_ready(JM.merge_axis(sj, stacked_j))
    mgot = TM.merge_axis(st, stacked_t)
    for f in TM.FIELDS:
        np.testing.assert_allclose(getattr(mgot, f).numpy(), np.asarray(getattr(mref, f)),
                                   rtol=1e-6)
    folded_j, rep_j = JM.fold_hosts(sj, parts_j[:3], reachable=[False, True, True])
    folded_j = jax.block_until_ready(folded_j)
    folded_t, rep_t = TM.fold_hosts(st, parts_t[:3], reachable=[False, True, True])
    for f in TM.FIELDS:
        np.testing.assert_array_equal(getattr(folded_t, f).numpy(),
                                      np.asarray(getattr(folded_j, f)))
    np.testing.assert_array_equal(rep_t.dropped_count, rep_j.dropped_count)
    assert rep_t.dropped_count.sum() == 32 * 64
    with pytest.raises(ShardLossError):
        TM.fold_hosts(st, parts_t[:2], reachable=[False, False])
    with pytest.raises(SketchValueError):
        TM.fold_hosts(st, [])
    a, b = TM.MomentDDSketch(2, n_moments=8, device="cpu"), TM.MomentDDSketch(
        2, n_moments=10, device="cpu")
    with pytest.raises(UnequalSketchParametersError):
        a.merge(b)


def test_moment_facade_ingest_semantics_match_jax():
    sj, st = _mspecs(8)
    vals = np.asarray([[0.0, 1.0, np.nan, 2.0], [5.0, 5.0, 5.0, 5.0],
                       [0.0, 0.0, 0.0, 0.0]], np.float32)
    weights = np.asarray([[1.0, 1.0, 1.0, 0.0], [1.0, 0.0, 1.0, 1.0],
                          [1.0, 1.0, 0.0, 0.0]], np.float32)
    j = JM.MomentDDSketch(3, spec=sj)
    jax.block_until_ready(j.add(vals, weights).state.count)
    t = TM.MomentDDSketch(3, spec=st, device="cpu").add(vals, weights)
    for f in ("count", "zero_count", "neg_count", "min", "max"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                      np.asarray(getattr(j.state, f)), err_msg=f)
    assert np.isnan(float(t.sum[0]))
    q = t.get_quantile_values([0.5])
    np.testing.assert_array_equal(q, j.get_quantile_values([0.5]))
    assert q[2, 0] == 0.0  # a zero-only stream answers 0


@pytest.mark.parametrize("k", [2, 8, 12, 16])
def test_bytes_per_stream(k):
    sj, st = _mspecs(k)
    assert TM.bytes_per_stream(st) == JM.bytes_per_stream(sj) == (6 + 2 * k) * 4 <= 256
    sk = TM.MomentDDSketch(100, n_moments=k, device="cpu")
    nbytes = sum(getattr(sk.state, f).nbytes for f in TM.FIELDS)
    assert nbytes == 100 * sk.bytes_per_stream()
    if k == 12:
        assert sk.bytes_per_stream() == 120


def test_convert_carries_backend_states_and_refuses_bad_leaves():
    _, st = _aspecs(n_bins=128)
    _, tm = _mspecs(8)
    a = TU.AdaptiveDDSketch(4, spec=st, device="cpu").add(np.ones((4, 8), np.float32)).collapse()
    leaves = convert.adaptive_to_numpy(a.state)
    back = convert.adaptive_from_numpy(st, leaves, device="cpu")
    assert torch.equal(back.level, a.level) and torch.equal(back.base.bins_pos,
                                                           a.state.base.bins_pos)
    for bad in ({k: v for k, v in leaves.items() if k != "level"},
                dict(leaves, level=leaves["level"].astype(np.int64)),
                dict(leaves, level=leaves["level"][:2])):
        with pytest.raises(SpecError):
            convert.adaptive_from_numpy(st, bad, device="cpu")
    m = TM.MomentDDSketch(4, spec=tm, device="cpu").add(np.ones((4, 8), np.float32))
    mleaves = convert.moment_to_numpy(m.state)
    mback = convert.moment_from_numpy(tm, mleaves, device="cpu")
    assert all(torch.equal(getattr(mback, f), getattr(m.state, f)) for f in TM.FIELDS)
    for bad in ({k: v for k, v in mleaves.items() if k != "powers"},
                dict(mleaves, count=mleaves["count"].astype(np.float64)),
                dict(mleaves, powers=mleaves["powers"][:, :4])):
        with pytest.raises(SpecError):
            convert.moment_from_numpy(tm, bad, device="cpu")


# ---------------------------------------------------------------------------
# Backend tenants behind the serving tier (``tests/test_backends.py``'s
# ``TestServe``): mixed-backend fleets, poison-free cache hits, write
# invalidation, and the stacked dispatch of same-spec adaptive and moment
# tenants, each result held to the JAX server's on the same inputs.
# ---------------------------------------------------------------------------


def _serve_pair(tenants):
    """A JAX and a port server with the same ``{name: (jax spec, port
    spec)}`` tenants of 4 streams (the port's on the CPU)."""
    from sketches_tpu import serve as js
    from sketches_tpu_torch import serve as ts

    clocks = (lambda: 0.0, lambda: 0.0)
    srv = (js.SketchServer(clock=clocks[0]), ts.SketchServer(clock=clocks[1]))
    for name, (sj, st) in tenants.items():
        srv[0].add_tenant(name, 4, spec=sj)
        srv[1].add_tenant(name, 4, spec=st, device="cpu")
    return srv


def _serve_specs():
    a, m = _aspecs(n_bins=128, max_collapses=3), _mspecs(k=8)
    return {"adaptive": a, "moment": m,
            "dense": (jb.SketchSpec(n_bins=256), tb.SketchSpec(n_bins=256))}


class TestServe:
    def test_mixed_backend_fleet_answers_concurrently(self):
        srv = _serve_pair(_serve_specs())
        v = _mid_bucket(np.random.RandomState(5).lognormal(0, 1.5, (4, 2048)))
        got = []
        for s in srv:
            for name in ("adaptive", "moment", "dense"):
                s.ingest(name, v)
            tickets = [s.submit(n, [0.5, 0.9]) for n in ("adaptive", "moment", "dense")]
            assert len(s.flush()) == 3
            got.append([(t.tenant, t.result.tier, np.asarray(t.result.values)) for t in tickets])
        ex = np.stack([np.quantile(v[i], [0.5, 0.9]) for i in range(4)])
        for (jn, jtier, jv), (tn, ttier, tv) in zip(*got):
            assert (jn, jtier) == (tn, ttier)
            rel = np.abs(tv.astype(np.float64) - ex) / np.abs(ex)
            assert rel.max() < 0.25, (tn, rel.max())
            if tn == "dense":
                np.testing.assert_allclose(tv, jv, rtol=1e-6)
            elif tn == "adaptive":
                np.testing.assert_allclose(tv, jv, rtol=2e-6)

    def test_cache_hits_stay_poison_free_across_backends(self):
        srv = _serve_pair(_serve_specs())[1]
        v = np.random.RandomState(6).lognormal(0, 1.0, (4, 512)).astype(np.float32)
        names = ("adaptive", "moment", "dense")
        for name in names:
            srv.ingest(name, v)
        first = [srv.submit(n, [0.5]) for n in names]
        srv.flush()
        second = [srv.submit(n, [0.5]) for n in names]
        srv.flush()
        assert all(t.result.cached for t in second)
        assert srv.stats()["cache_poisoned"] == 0
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a.result.values, b.result.values)

    def test_write_invalidates_backend_tenants(self):
        srv = _serve_pair(_serve_specs())[1]
        v = np.ones((4, 64), np.float32)
        srv.ingest("moment", v)
        t1 = srv.submit("moment", [0.5])
        srv.flush()
        srv.ingest("moment", 3.0 * v)
        t2 = srv.submit("moment", [0.5])
        srv.flush()
        assert not t2.result.cached
        assert not np.array_equal(t1.result.values, t2.result.values)

    def test_same_spec_adaptive_tenants_fuse(self):
        spec = _aspecs(n_bins=128, max_collapses=3)
        srv = _serve_pair({"a1": spec, "a2": spec})
        r = np.random.RandomState(11)
        v1 = _mid_bucket(r.lognormal(0, 0.5, (4, 512)))
        v2 = _mid_bucket(r.lognormal(0, 3.0, (4, 2048)))
        out = []
        for s in srv:
            s.ingest("a1", v1)
            s.ingest("a2", v2)  # wide: this tenant collapses
            tks = [s.submit("a1", [0.5]), s.submit("a2", [0.5])]
            s.flush()
            assert s.stats()["fused_dispatches"] == 1
            out.append([np.asarray(t.result.values) for t in tks])
        for (jv, tv), v, name in zip(zip(*out), (v1, v2), ("a1", "a2")):
            np.testing.assert_allclose(tv, jv, rtol=2e-6)
            want = np.quantile(v, 0.5, axis=1)
            ea = srv[1].tenant(name).effective_alpha().numpy().astype(np.float64)
            assert (np.abs(tv[:, 0] - want) / np.abs(want) <= ea + 0.02).all()
        assert int(srv[1].tenant("a2").level.min()) == int(np.asarray(srv[0].tenant("a2").level).min())

    def test_same_spec_moment_tenants_fuse(self):
        spec = _mspecs(k=8)
        srv = _serve_pair({"m1": spec, "m2": spec})[1]
        r = np.random.RandomState(7)
        srv.ingest("m1", r.lognormal(0, 1.0, (4, 256)).astype(np.float32))
        srv.ingest("m2", r.lognormal(1.0, 1.0, (4, 256)).astype(np.float32))
        t1, t2 = srv.submit("m1", [0.5]), srv.submit("m2", [0.5])
        srv.flush()
        assert srv.stats()["fused_dispatches"] == 1
        assert np.isfinite(t1.result.values).all() and np.isfinite(t2.result.values).all()
        for t in (t1, t2):
            own = srv.tenant(t.tenant).get_quantile_values([0.5])
            np.testing.assert_array_equal(t.result.values, own)
