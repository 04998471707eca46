"""The port's single-sketch layer (``sketches_tpu_torch.ddsketch``) against
``sketches_tpu.ddsketch`` on the same seeded numpy inputs, on the CPU.

``TorchDDSketch(device="cpu")`` runs against ``JaxDDSketch`` on both flush
tiers: the native tier (both packages' native engines, built from the same
``native/`` sources) and the device-flush tier (``SKETCHES_TPU_NATIVE=0``,
each chunk through the batched ``add``).

Tolerances, with their reasons:

* **Exact** for the pure-Python presets (the same Python arithmetic on the
  same floats): every store field, counter and quantile.
* **Exact** for the torch facade's host counters (count, sum, min, max,
  zero_count: the same f64 numpy bookkeeping) and for every state leaf but
  ``sum``: on mid-bucket data for the logarithmic mapping (XLA:CPU's f32
  ``log`` is not correctly rounded, so a value within an ulp of a bucket
  edge can key one bucket apart; ROADMAP queue C), on all data for the
  interpolated mappings.
* **atol 1e-5 * sum|v|** for the state's f32 ``sum`` leaf (the native
  tier's is exact: one f64 total cast once).
* **rtol 1e-6** for quantiles: the decode's ``exp`` may differ by an ulp
  between XLA:CPU and torch.

JAX results are waited for (``jax.block_until_ready``) before the port's
side runs, so the two never compute at once in one process.
"""

import math

import jax
import numpy as np
import pytest

from sketches_tpu import ddsketch as jd
from sketches_tpu import native as jn
from sketches_tpu_torch import convert
from sketches_tpu_torch import ddsketch as td
from sketches_tpu_torch import native as tn
from sketches_tpu_torch.batched import LEAVES
from sketches_tpu_torch.resilience import (
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

ALPHA = 0.01
GAMMA = (1 + ALPHA) / (1 - ALPHA)
QS = [0.0, 0.01, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999, 1.0]
MAPPINGS = (
    "logarithmic",
    "linear_interpolated",
    "quadratic_interpolated",
    "cubic_interpolated",
)


def _mid_bucket(v):
    """Each value moved to the middle of its logarithmic bucket."""
    a = np.abs(v).astype(np.float64)
    k = np.ceil(np.log(a) / np.log(GAMMA))
    return np.sign(v) * GAMMA ** (k - 0.5)


def _values(seed, n, mapping="logarithmic", zeros=True):
    """Mixed-sign lognormal(0, 2) values as f32-exact floats: 40% negated,
    a few zeros and f32 subnormals (both land in the zero bucket)."""
    r = np.random.RandomState(seed)
    v = r.lognormal(0, 2, n) * np.where(r.rand(n) < 0.4, -1, 1)
    if mapping == "logarithmic":
        v = _mid_bucket(v)
    if zeros:
        u = r.rand(n)
        v[u < 0.02] = 0.0
        v[(u > 0.02) & (u < 0.03)] = 1e-40
    return v.astype(np.float32).astype(np.float64)


@pytest.fixture(params=["native", "device"])
def tier(request, monkeypatch):
    """The flush tier of both packages' facades, for the test's duration."""
    if request.param == "device":
        monkeypatch.setenv("SKETCHES_TPU_NATIVE", "0")
    jn.reset()
    tn.reset()
    yield request.param
    monkeypatch.delenv("SKETCHES_TPU_NATIVE", raising=False)
    jn.reset()
    tn.reset()


def _store_fields(s):
    return (list(s.bins), s.count, s.offset, s.min_key, s.max_key)


def _assert_py_equal(a, b):
    assert _store_fields(a.store) == _store_fields(b.store)
    assert _store_fields(a.negative_store) == _store_fields(b.negative_store)
    for f in ("zero_count", "count", "sum"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a._min, a._max) == (b._min, b._max)
    for q in QS + [-0.5, 1.5]:
        assert a.get_quantile_value(q) == b.get_quantile_value(q)


def _settled_leaves(j, t):
    j._settle()
    jax.block_until_ready(j._state)
    jl = {f: np.asarray(getattr(j._state, f)) for f in LEAVES}
    t._settle()
    return jl, convert.state_to_numpy(t._state)


def _assert_facades_equal(j, t, abs_scale):
    """Host counters exact, every leaf but ``sum`` exact, ``sum`` within
    1e-5 * abs_scale, quantiles rtol 1e-6."""
    for f in ("count", "zero_count", "sum"):
        a, b = getattr(j, f), getattr(t, f)
        assert a == b or (math.isnan(a) and math.isnan(b)), f
    assert (j._min, j._max) == (t._min, t._max)
    jl, tl = _settled_leaves(j, t)
    for f in LEAVES:
        assert jl[f].dtype == tl[f].dtype, f
        if f == "sum":
            ok = np.isclose(tl[f], jl[f], rtol=0, atol=1e-5 * abs_scale, equal_nan=True)
            assert ok.all(), f
        else:
            np.testing.assert_array_equal(tl[f], jl[f], err_msg=f)
    for q in QS + [-0.1, 1.1]:
        a = j.get_quantile_value(q)
        b = t.get_quantile_value(q)
        if a is None:
            assert b is None
        else:
            assert b == pytest.approx(a, rel=1e-6, abs=0)


# ---------------------------------------------------------------------------
# Pure-Python presets
# ---------------------------------------------------------------------------

PRESETS = {
    "DDSketch": lambda m: m.DDSketch(ALPHA),
    "LogCollapsingLowest": lambda m: m.LogCollapsingLowestDenseDDSketch(ALPHA, bin_limit=256),
    "LogCollapsingHighest": lambda m: m.LogCollapsingHighestDenseDDSketch(ALPHA, bin_limit=256),
    "LogCollapsingLowest_tiny": lambda m: m.LogCollapsingLowestDenseDDSketch(0.05, bin_limit=8),
    "LogCollapsingHighest_tiny": lambda m: m.LogCollapsingHighestDenseDDSketch(0.05, bin_limit=8),
}


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_py_presets_exact(preset, seed):
    a, b = PRESETS[preset](jd), PRESETS[preset](td)
    v = _values(seed, 5000)
    w = np.random.RandomState(seed + 100).exponential(1.0, v.size) + 0.01
    for x, wt in zip(v.tolist(), w.tolist()):
        a.add(x, wt)
        b.add(x, wt)
    _assert_py_equal(a, b)
    # merge of a second half, and copy
    a2, b2 = PRESETS[preset](jd), PRESETS[preset](td)
    for x in _values(seed + 7, 2000).tolist():
        a2.add(x)
        b2.add(x)
    a.merge(a2)
    b.merge(b2)
    _assert_py_equal(a, b)
    _assert_py_equal(a.copy(), b.copy())


# ---------------------------------------------------------------------------
# TorchDDSketch against JaxDDSketch
# ---------------------------------------------------------------------------


def _pair(mapping="logarithmic", n_bins=None, key_offset=None):
    j = jd.DDSketch(ALPHA, backend="jax", mapping=mapping, n_bins=n_bins, key_offset=key_offset)
    t = td.DDSketch(
        ALPHA, backend="torch", mapping=mapping, n_bins=n_bins, key_offset=key_offset,
        device="cpu",
    )
    return j, t


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_scalar_adds_match_jax(tier, mapping):
    j, t = _pair(mapping)
    assert t.flush_tier == tier and j._use_native == (tier == "native")
    v = _values(3, 40_000, mapping)  # two whole flush chunks and a part
    for x in v.tolist():
        j.add(x)
    jax.block_until_ready(j._state)
    for x in v.tolist():
        t.add(x)
    _assert_facades_equal(j, t, np.abs(v).sum())


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_add_many_weighted_matches_jax(tier, mapping):
    j, t = _pair(mapping, n_bins=512)
    v = _values(4, 50_000, mapping)
    w = np.random.RandomState(5).randint(1, 4, v.size).astype(np.float64)
    j.add_many(v[:30_000], w[:30_000])
    j.add(float(v[30_000]), 2.0)  # a pending scalar add flushes first
    j.add_many(v[30_001:])
    jax.block_until_ready(j._state)
    t.add_many(v[:30_000], w[:30_000])
    t.add(float(v[30_000]), 2.0)
    t.add_many(v[30_001:])
    _assert_facades_equal(j, t, (np.abs(v) * 3).sum())


def test_pinned_window_and_collapse_match_jax(tier):
    j, t = _pair(n_bins=128, key_offset=-20)
    v = _values(6, 20_000)  # a narrow pinned window: mass collapses at both edges
    j.add_many(v)
    jax.block_until_ready(j._state)
    t.add_many(v)
    _assert_facades_equal(j, t, np.abs(v).sum())
    assert t._state.collapsed_low.item() > 0 and t._state.collapsed_high.item() > 0
    assert int(t._state.key_offset[0]) == -20


def test_store_views_match_jax(tier):
    j, t = _pair()
    v = _values(8, 5000)
    j.add_many(v)
    jax.block_until_ready(j._state)
    t.add_many(v)
    assert _store_fields(t.store) == _store_fields(j.store)
    assert _store_fields(t.negative_store) == _store_fields(j.negative_store)


def test_nan_and_infinite_median_match_jax(tier):
    j, t = _pair()
    v = np.array([np.nan, 1.0, np.inf, np.inf, np.inf, -2.0, 0.0])
    for x in v.tolist():
        j.add(x)
    jax.block_until_ready(j._state)
    for x in v.tolist():
        t.add(x)
    assert math.isnan(t.sum) and math.isnan(j.sum)
    _assert_facades_equal(j, t, 1.0)


# ---------------------------------------------------------------------------
# Merge, copy, probes
# ---------------------------------------------------------------------------


def test_cross_backend_merge_matches_jax(tier):
    j, t = _pair()
    jp, tp = jd.DDSketch(ALPHA), td.DDSketch(ALPHA)
    v, u = _values(9, 20_000), _values(10, 3000)
    j.add_many(v)
    for x in u.tolist():
        jp.add(x)
    j.merge(jp)
    jax.block_until_ready(j._state)
    t.add_many(v)
    for x in u.tolist():
        tp.add(x)
    t.merge(tp)
    _assert_facades_equal(j, t, np.abs(np.concatenate([v, u])).sum())
    # and a py sketch merging a torch one (through its host stores)
    jq, tq = jd.DDSketch(ALPHA), td.DDSketch(ALPHA)
    jq2 = jd.LogCollapsingLowestDenseDDSketch(ALPHA, bin_limit=2048)
    tq2 = td.LogCollapsingLowestDenseDDSketch(ALPHA, bin_limit=2048)
    jq2.merge(j)
    tq2.merge(t)
    jq.merge(jq2)
    tq.merge(tq2)
    assert _store_fields(tq.store) == _store_fields(jq.store)
    assert tq.count == jq.count


def test_torch_merge_realigns_windows_like_jax(tier):
    (j1, t1), (j2, t2) = _pair(), _pair()
    a, b = _values(11, 20_000), _values(12, 20_000) * 50.0  # another centre
    j1.add_many(a)
    j2.add_many(b.astype(np.float32).astype(np.float64))
    j1.merge(j2)
    jax.block_until_ready(j1._state)
    t1.add_many(a)
    t2.add_many(b.astype(np.float32).astype(np.float64))
    t1.merge(t2)
    _assert_facades_equal(j1, t1, np.abs(a).sum() + np.abs(b).sum())
    # an empty torch sketch adopts the operand's window
    je, te = _pair()
    je.merge(j2)
    te.merge(t2)
    assert te._window_offset == je._window_offset


def test_copy_is_independent(tier):
    _, t = _pair()
    t.add_many(_values(13, 1000))
    c = t.copy()
    assert c.get_quantile_value(0.5) == t.get_quantile_value(0.5)
    assert c.count == t.count
    c.add_many(np.full(5000, 1e6))
    assert c.count == t.count + 5000
    assert t.get_quantile_value(0.99) < 1e5 < c.get_quantile_value(0.99)


def test_none_and_error_probes():
    for sk in (td.DDSketch(ALPHA), td.DDSketch(ALPHA, backend="torch", device="cpu")):
        assert sk.get_quantile_value(0.5) is None
        sk.add(1.0)
        assert sk.get_quantile_value(-0.01) is None
        assert sk.get_quantile_value(1.01) is None
        for bad in (0.0, -1.0):
            with pytest.raises(SketchValueError):
                sk.add(1.0, bad)
    t = td.DDSketch(ALPHA, backend="torch", device="cpu")
    with pytest.raises(SketchValueError):
        t.add_many([1.0, 2.0], [1.0, 0.0])
    t.add_many([])  # no-op
    assert t.count == 0
    with pytest.raises(UnequalSketchParametersError):
        t.merge(td.DDSketch(0.02))
    with pytest.raises(UnequalSketchParametersError):
        t.merge(td.DDSketch(ALPHA, backend="torch", n_bins=512, device="cpu"))
    with pytest.raises(UnequalSketchParametersError):
        td.DDSketch(ALPHA).merge(td.DDSketch(0.05))
    with pytest.raises(SpecError):
        td.DDSketch(ALPHA, backend="jax")
    with pytest.raises(SpecError):
        td.DDSketch(ALPHA, n_bins=512)
    with pytest.raises(SpecError):
        td.LogCollapsingLowestDenseDDSketch(ALPHA, device="cpu")

    class Sub(td.DDSketch):
        pass

    with pytest.raises(NotImplementedError):
        Sub(ALPHA, backend="torch", device="cpu")
    # the collapsing presets on the torch backend
    for preset in (td.LogCollapsingLowestDenseDDSketch, td.LogCollapsingHighestDenseDDSketch):
        sk = preset(ALPHA, bin_limit=1, backend="torch", device="cpu")
        assert isinstance(sk, td.TorchDDSketch) and sk._spec.n_bins == td.DEFAULT_BIN_LIMIT
        assert preset(ALPHA, bin_limit=300, backend="torch", device="cpu")._spec.n_bins == 300


def test_device_tier_reports_why(monkeypatch):
    monkeypatch.setenv("SKETCHES_TPU_NATIVE", "0")
    tn.reset()
    try:
        t = td.DDSketch(ALPHA, backend="torch", device="cpu")
        assert t.flush_tier == "device"
        st = tn.status()
        assert st["tier"] == "python" and "SKETCHES_TPU_NATIVE=0" in st["reason"]
    finally:
        monkeypatch.delenv("SKETCHES_TPU_NATIVE")
        tn.reset()
    assert tn.status()["tier"] == "native"


@pytest.mark.parametrize(
    "mapping,want", [("logarithmic", 5.0028), ("linear_interpolated", 4.9899)]
)
def test_integral_positive_rank_matches_pure_python(mapping, want):
    """q = 0.9 of one stream of eleven values makes ``pos_rank`` exactly 4.0.
    The port's facade (both engines), its plain ``quantile`` and the JAX
    package's eager ``quantile`` answer as the pure-Python DDSketch does.
    JAX's jitted facade answers one bucket lower: XLA:CPU fuses
    ``q * (count - 1) - (zero_count + neg_total)`` into one FMA, so the
    rank comes out one ulp under 4.0."""
    import jax.numpy as jnp

    from sketches_tpu import batched as jb
    from sketches_tpu import mapping as jm
    from sketches_tpu.store import DenseStore
    from sketches_tpu_torch import BatchedDDSketch
    from sketches_tpu_torch import batched as tb

    v = np.asarray([[-1, -2, -3, -4, 0, 1, 2, 3, 4, 5, 6]], np.float32)
    py = jd.BaseDDSketch(
        mapping=jm.mapping_from_name(mapping, ALPHA), store=DenseStore(),
        negative_store=DenseStore(),
    )
    for x in v[0].tolist():
        py.add(x)
    ref = py.get_quantile_value(0.9)
    assert ref == pytest.approx(want, abs=5e-5)
    js = jb.SketchSpec(ALPHA, mapping_name=mapping, n_bins=512)
    eager = float(jb.quantile(js, jb.add(js, jb.init(js, 1), jnp.asarray(v)), jnp.asarray([0.9]))[0, 0])
    for engine in ("plain", "auto"):
        sk = BatchedDDSketch(1, relative_accuracy=ALPHA, mapping=mapping, n_bins=512,
                             engine=engine, device="cpu")
        sk.add(v)
        got = float(sk.get_quantile_value(0.9)[0])
        assert got == pytest.approx(ref, rel=1e-6, abs=0) and got == eager, engine
        assert float(tb.quantile(sk.spec, sk.state, [0.9])[0, 0]) == got
