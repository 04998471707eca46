"""The port's kernel module (``sketches_tpu_torch.kernels``) against the JAX
package's, on the CPU: each wrapper runs its plain version here (a CPU
tensor), and the JAX side runs its Pallas kernels in interpret mode.

Tolerances, with their reasons:

* **Exact** for unit weights: histograms, every packed column but ``sum``,
  folded state leaves, plans (window, tile targets, bitmasks, block lists,
  ``k_tiles``) and engine choices -- integer masses add exactly in any order.
* **rtol 1e-5** for weighted histograms and columns: f32 sums over up to S
  terms, taken in another order.
* **atol 1e-5 * sum|v * w|** for the ``sum`` column and leaf: mixed signs
  cancel, so a relative tolerance would not hold.
* **rtol 1e-6** for decoded quantiles: ``exp`` may differ by one ulp
  between XLA:CPU and torch.

JAX results are waited for (``jax.block_until_ready``) before the port's
side runs, so the two never compute at once in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import kernels as jk
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import convert
from sketches_tpu_torch import kernels as tk
from sketches_tpu_torch.resilience import SketchValueError, SpecError

LEAVES = tb.LEAVES
QS = [0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -0.1, 1.1]
N = 256

REGIMES = {
    "tight_pos": lambda r: r.lognormal(0, 0.05, (N, 256)),
    "mid_pos": lambda r: r.lognormal(0, 0.5, (N, 256)),
    "wide_pos": lambda r: r.lognormal(0, 3.0, (N, 256)),
    "mixed_sign": lambda r: r.lognormal(0, 2.0, (N, 256))
    * np.where(r.rand(N, 256) < 0.4, -1.0, 1.0),
    "with_zeros": lambda r: r.lognormal(0, 1.0, (N, 256)) * (r.rand(N, 256) > 0.3),
    "neg_only": lambda r: -r.lognormal(0, 1.0, (N, 256)),
}


def _specs(n_bins=512, **kw):
    jdt = {"bin_dtype": jnp.int32} if kw.pop("int_bins", False) else {}
    tdt = {"bin_dtype": torch.int32} if jdt else {}
    return (
        jb.SketchSpec(n_bins=n_bins, **kw, **jdt),
        tb.SketchSpec(n_bins=n_bins, **kw, **tdt),
    )


def _port(spec_t, jstate):
    return convert.state_from_numpy(
        spec_t, {f: np.asarray(getattr(jstate, f)) for f in LEAVES}, device="cpu"
    )


def _states(regime, seed=0, empty_every=0):
    """The same state in both packages: centred on the data like the
    facades' first batch, with every ``empty_every``-th stream left empty."""
    js, ts = _specs()
    r = np.random.RandomState(seed)
    v = REGIMES[regime](r).astype(np.float32)
    w = np.ones_like(v)
    if empty_every:
        w[::empty_every] = 0.0
    jst = jb.init(js, N)
    jst = jb.recenter(js, jst, jb.auto_offset(js, jst, jnp.asarray(v), jnp.asarray(w)))
    jst = jax.block_until_ready(jb.add(js, jst, jnp.asarray(v), jnp.asarray(w)))
    return js, ts, jst, _port(ts, jst)


def _mixed_values(n, s, seed):
    r = np.random.RandomState(seed)
    v = r.lognormal(0, 2, (n, s)) * np.where(r.rand(n, s) < 0.4, -1, 1)
    u = r.rand(n, s)
    v[u < 0.05] = 0.0
    v[(u > 0.05) & (u < 0.07)] = np.nan
    v[(u > 0.07) & (u < 0.09)] = 1e-40
    v[(u > 0.09) & (u < 0.11)] = 1e30
    v[(u > 0.11) & (u < 0.13)] = -1e-30
    return v.astype(np.float32)


def _assert_cols(got, ref, v, w, weighted):
    sc = jk._COL["sum"]
    keep = [c for c in range(ref.shape[1]) if c != sc]
    if weighted:
        np.testing.assert_allclose(got[:, keep], ref[:, keep], rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got[:, keep], ref[:, keep])
    with np.errstate(invalid="ignore"):
        scale = np.nansum(np.abs(np.where(w > 0, v * w, 0.0)), axis=1)
    both_nan = np.isnan(got[:, sc]) & np.isnan(ref[:, sc])
    assert np.all(both_nan | (np.abs(got[:, sc] - ref[:, sc]) <= 1e-5 * scale))


# ---------------------------------------------------------------------------
# Ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bins", [512, 2048])
@pytest.mark.parametrize("weighted", [False, True])
def test_ingest_histogram_matches_jax_interpret(n_bins, weighted):
    js, ts = _specs(n_bins=n_bins)
    assert tk._ncols(ts.n_tiles) == jk._ncols(js.n_tiles)
    assert (tk._COL, tk._TILE0) == (jk._COL, jk._TILE0)
    n, s = 128, 256
    v = _mixed_values(n, s, n_bins + weighted)
    r = np.random.RandomState(7)
    w = (r.rand(n, s) * 3.0 - 0.5).astype(np.float32) if weighted else np.ones_like(v)
    koff = r.randint(-n_bins // 2 - 64, -n_bins // 2 + 64, n).astype(np.int32)
    ref = jax.block_until_ready(jk.ingest_histogram(
        js, jnp.asarray(v), jnp.asarray(w), jnp.asarray(koff), weighted=weighted, interpret=True
    ))
    got = tk.ingest_histogram(
        ts, torch.from_numpy(v), torch.from_numpy(w) if weighted else None,
        torch.from_numpy(koff), weighted=weighted,
    )
    for g, rf in zip(got[:2], ref[:2]):
        if weighted:
            np.testing.assert_allclose(g.numpy(), np.asarray(rf), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(rf))
    _assert_cols(got[2].numpy(), np.asarray(ref[2]), v, w, weighted)


@pytest.mark.parametrize(
    "weighted,int_bins",
    # Weighted integer-mode ingest is the plain path in both packages.
    [(False, False), (True, False), (False, True)],
)
def test_kernel_add_matches_jax(weighted, int_bins):
    js, ts = _specs(int_bins=int_bins)
    v = _mixed_values(128, 256, 11)
    r = np.random.RandomState(12)
    w = r.choice([0.0, 1.0, 2.0, 0.5], size=v.shape).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    jst = jk.add(js, jb.init(js, 128), jnp.asarray(v), jw, interpret=True)
    jst = jax.block_until_ready(jk.add(js, jst, jnp.asarray(v), jw, interpret=True))
    tst = tk.add(ts, tb.init(ts, 128, "cpu"), torch.from_numpy(v), tw)
    tst = tk.add(ts, tst, torch.from_numpy(v), tw)
    for f in LEAVES:
        g, rf = getattr(tst, f).numpy(), np.asarray(getattr(jst, f))
        assert g.dtype == rf.dtype, f
        if f == "sum":
            both = np.isnan(g) & np.isnan(rf)
            with np.errstate(invalid="ignore"):
                scale = 2 * np.nansum(np.abs(v * (1 if w is None else w)), axis=1)
            assert np.all(both | (np.abs(g - rf) <= 1e-5 * scale)), f
        else:
            np.testing.assert_array_equal(g, rf, err_msg=f)


def test_integer_kernel_add_guards():
    _, ts = _specs(int_bins=True)
    st = tb.init(ts, 128, "cpu")
    v = torch.ones((128, 128))
    with pytest.raises(NotImplementedError):
        tk.add(ts, st, v, torch.ones_like(v))


# ---------------------------------------------------------------------------
# Plans and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bins", [128, 384, 512, 1024, 2048])
def test_plan_window_matches_jax(n_bins):
    js, ts = _specs(n_bins=n_bins)
    for lo in range(-1, n_bins, 37):
        for hi in (-1, lo, lo + 5, lo + 130, n_bins - 1, n_bins + 40):
            assert tk.plan_window(ts, lo, hi) == jk.plan_window(js, lo, hi)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_plans_and_engine_choice_match_jax(regime):
    js, ts, jst, tst = _states(regime, seed=1, empty_every=17)
    wj = jk.plan_state_window(js, jst)
    wt = tk.plan_state_window(ts, tst)
    assert wt == wj
    for qs in (QS[:4], QS[2:6], [0.5], [0.1 * i for i in range(9)]):
        q = jnp.asarray(qs, jnp.float32)
        qt = torch.tensor(qs, dtype=torch.float32)
        assert tk.tile_query_eligible(ts, len(qs), wt) == jk.tile_query_eligible(js, len(qs), wj)
        if len(qs) > 8:
            continue
        pj, pt = jk.plan_tile_query(js, jst, q), tk.plan_tile_query(ts, tst, qs)
        assert pt == pj
        for ok in (False, True):
            assert tk.choose_query_engine(wt, pt, ok) == jk.choose_query_engine(wj, pj, ok)
        # The plan's inputs, piece by piece.
        uj, thj, zj, rj = jax.block_until_ready(jk._tile_targets(js, jst, q))
        ut, tht, zt, rt = tk._tile_targets(ts, tst, qt)
        for a, b in ((ut, uj), (tht, thj), (zt, zj), (rt, rj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        nan_j = jax.block_until_ready(jk._invalid_mask(jst, q))
        nan_t = tk._invalid_mask(tst, qt)
        np.testing.assert_array_equal(nan_t.numpy(), np.asarray(nan_j))
        bj = jax.block_until_ready(jk._tile_bits(uj, zj, nan_j, js.n_tiles))
        bt = tk._tile_bits(ut, zt, nan_t, ts.n_tiles)
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        for bn in (128, 256):
            k = pt[0]
            lj = jax.block_until_ready(jk._block_tile_lists(*bj, js.n_tiles, bn, k))
            lt = tk._block_tile_lists(*bt, ts.n_tiles, bn, k)
            for a, b in zip(lt, lj):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize(
    "window_plan,tile_plan",
    [
        ((0, 1, 4, False), (4, False)),
        ((0, 1, 4, True), (2, True)),
        ((0, 2, 2, False), (2, False)),
        ((1, 1, 1, False), (1, False)),
        ((0, 4, 1, True), (4, False)),
        ((0, 1, 4, False), None),
    ],
)
def test_choose_query_engine_table(window_plan, tile_plan):
    for ok in (False, True):
        assert tk.choose_query_engine(window_plan, tile_plan, ok) == jk.choose_query_engine(
            window_plan, tile_plan, ok
        )


def test_supports_select_engine_and_variants():
    js, ts = _specs(n_bins=2048)
    for n, b in ((128, None), (128, 256), (100, None), (128, 100)):
        assert tk.supports(ts, n, b) == jk.supports(js, n, b)
    js2, ts2 = _specs(n_bins=100)
    assert tk.supports(ts2, 128) == jk.supports(js2, 128) is False
    for v in tk.INGEST_VARIANTS:
        for weighted in (False, True):
            assert tk.ingest_variant_supported(ts, v, weighted) == jk.ingest_variant_supported(
                js, v, weighted
            )
    assert tk.choose_ingest_engine(ts, False) == "packed"
    assert tk.choose_ingest_engine(ts, True) == "stock"
    with pytest.raises(SpecError):
        tk.choose_ingest_engine(ts, True, "packed")
    with pytest.raises(SpecError):
        tk.ingest_variant_supported(ts, "nope", False)
    cpu = torch.device("cpu")
    assert tk.select_engine(ts, 128, "auto", cpu) is True
    assert tk.select_engine(ts, 100, "auto", cpu) is False
    assert tk.select_engine(ts, 128, "plain", cpu) is False
    with pytest.raises(SpecError):
        tk.select_engine(ts, 128, "pallas", cpu)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_tiles", [1, 2, 4])
@pytest.mark.parametrize("regime", ["mid_pos", "mixed_sign"])
def test_windowed_matches_jax_interpret(w_tiles, regime):
    js, ts, jst, tst = _states(regime, seed=2, empty_every=13)
    glo, ghi = int(tst.occ_lo.amin()), int(tst.occ_hi.amax())
    lo_b = glo // 128 // w_tiles
    nwb = ghi // 128 // w_tiles - lo_b + 1
    q = jnp.asarray(QS, jnp.float32)
    full = tb.quantile(ts, tst, QS).numpy()
    for with_neg in (True, False) if regime == "mid_pos" else (True,):
        ref = np.asarray(jk.fused_quantile_windowed(
            js, jst, q, lo_b, n_wblocks=nwb, w_tiles=w_tiles, with_neg=with_neg, interpret=True
        ))
        got = tk.fused_quantile_windowed(
            ts, tst, QS, lo_b, n_wblocks=nwb, w_tiles=w_tiles, with_neg=with_neg
        ).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
        np.testing.assert_allclose(got, full, rtol=1e-6, equal_nan=True)
    with pytest.raises(SpecError):
        tk.fused_quantile_windowed(ts, tst, QS, 0, n_wblocks=nwb, w_tiles=3)
    with pytest.raises(SpecError):
        tk.fused_quantile_windowed(ts, tst, QS, 0, n_wblocks=5, w_tiles=1)


@pytest.mark.parametrize("regime", ["wide_pos", "mixed_sign", "with_zeros", "neg_only"])
def test_tiles_matches_jax_interpret(regime):
    js, ts, jst, tst = _states(regime, seed=3, empty_every=11)
    q = jnp.asarray(QS, jnp.float32)
    k_tiles, with_neg = tk.plan_tile_query(ts, tst, QS)
    full = tb.quantile(ts, tst, QS).numpy()
    for wn in {with_neg, True}:
        ref = np.asarray(
            jk.fused_quantile_tiles(js, jst, q, k_tiles=k_tiles, with_neg=wn, interpret=True)
        )
        got = tk.fused_quantile_tiles(ts, tst, QS, k_tiles=k_tiles, with_neg=wn).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
        np.testing.assert_allclose(got, full, rtol=1e-6, equal_nan=True)
    assert np.isnan(got[::11]).all()
    with pytest.raises(SpecError):
        tk.fused_quantile_tiles(ts, tst, QS, k_tiles=ts.n_tiles + 1)


def test_quantile_windowed_xla_integer_past_2_24():
    js, ts = _specs(int_bins=True)
    r = np.random.RandomState(5)
    v = (r.lognormal(0, 1, (128, 128)) * np.where(r.rand(128, 128) < 0.3, -1, 1)).astype(
        np.float32
    )
    w = np.ones_like(v)
    w[:, 0] = 2.0**24
    w[:, 1] = 2.0**24 + 6
    jst = jb.add(js, jb.init(js, 128), jnp.asarray(v), jnp.asarray(w))
    jst = jax.block_until_ready(jb.add(js, jst, jnp.asarray(v)))
    tst = _port(ts, jst)
    assert int(tst.count[0]) > 2**25
    lo_w, n_w, w_t, with_neg = tk.plan_state_window(ts, tst)
    qs = [0.0, 0.2, 0.5, 0.51, 0.9, 1.0, 1.5]
    for wn in (with_neg, True):
        ref = np.asarray(jk.quantile_windowed_xla(
            js, jst, jnp.asarray(qs), lo_w * w_t, n_tiles_window=n_w * w_t, with_neg=wn
        ))
        got = tk.quantile_windowed_xla(
            ts, tst, qs, lo_w * w_t, n_tiles_window=n_w * w_t, with_neg=wn
        ).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(
        got, tb.quantile(ts, tst, qs).numpy(), rtol=1e-6, equal_nan=True
    )


# ---------------------------------------------------------------------------
# No hidden fallback
# ---------------------------------------------------------------------------


def test_cpu_runs_launch_no_kernel_and_kernel_engine_needs_cuda():
    tk.reset_launch_counts()
    _, ts, _, tst = _states("mixed_sign", seed=4)
    tk.ingest_histogram(ts, torch.ones((128, 128)), None, tst.key_offset[:128], weighted=False)
    tk.fused_quantile_windowed(ts, tst, QS, 0, n_wblocks=1, w_tiles=4)
    tk.fused_quantile_tiles(ts, tst, QS, k_tiles=4)
    tk.fused_quantile_tiles_overlap(ts, tst, QS, k_tiles=4)
    tk.fused_quantile(ts, tst, QS)
    sk = tb.BatchedDDSketch(256, n_bins=512, device="cpu")
    sk.add(np.ones((256, 128), np.float32))
    sk.add(np.ones((256, 128), np.float32))
    sk.get_quantile_values([0.5])
    assert tk.launch_counts() == {
        "ingest_histogram": 0, "fused_quantile": 0, "fused_quantile_windowed": 0,
        "fused_quantile_tiles": 0, "fused_quantile_tiles_overlap": 0,
    }
    with pytest.raises(SpecError):
        tb.BatchedDDSketch(256, n_bins=512, device="cpu", engine="kernel")
    with pytest.raises(SpecError):
        tk.select_engine(ts, 256, "kernel", "cpu")


def test_wrappers_raise_on_other_devices_and_bad_operands():
    _, ts = _specs()
    meta = torch.empty((128, 128), device="meta")
    koff = torch.zeros(128, dtype=torch.int32, device="meta")
    with pytest.raises(SpecError):
        tk.ingest_histogram(ts, meta, None, koff, weighted=False)
    with pytest.raises(SpecError):
        tk.ingest_histogram(ts, torch.ones(128, 128), None, torch.zeros(128, dtype=torch.int32),
                            weighted=False, variant="nope")
    with pytest.raises(SketchValueError):
        tk._check(torch.ones(4, 4).t(), "x", torch.float32, (4, 4), torch.device("cpu"))
