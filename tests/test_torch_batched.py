"""The port's batched core (``sketches_tpu_torch.batched``) against
``sketches_tpu.batched`` on the same numpy inputs, on the CPU.

Tolerances, with their reasons:

* **Exact** for unit weights: every bin, zero_count, count, min, max,
  collapsed_*, key_offset, pos/neg lo/hi, neg_total and tile_sums (integer
  masses below 2**24 add exactly in any order), and every integer-bin leaf.
* **rtol 1e-5** for weighted bins and counters: f32 sums over up to S
  terms, taken in another order.
* **atol 1e-5 * sum|v * w|** for the ``sum`` leaf: mixed signs cancel, so a
  relative tolerance would not hold.
* **rtol 1e-6** for decoded quantiles: ``exp`` may differ by one ulp
  between XLA:CPU and torch.

JAX dispatches asynchronously: every JAX result is waited for
(``jax.block_until_ready``) before the port's side runs, so the two never
compute at once in one process (overlapping them intermittently gave bins
one count apart; ROADMAP queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import convert
from sketches_tpu_torch.resilience import SpecError
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

LEAVES = tb.LEAVES
QS = [0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -0.1, 1.1]

REGIMES = {
    "tight_pos": lambda r: r.lognormal(0, 0.05, (128, 256)),
    "mid_pos": lambda r: r.lognormal(0, 0.5, (128, 256)),
    "wide_pos": lambda r: r.lognormal(0, 3.0, (128, 256)),
    "mixed_sign": lambda r: r.lognormal(0, 2.0, (128, 256))
    * np.where(r.rand(128, 256) < 0.4, -1.0, 1.0),
    "with_zeros": lambda r: r.lognormal(0, 1.0, (128, 256)) * (r.rand(128, 256) > 0.3),
    "neg_only": lambda r: -r.lognormal(0, 1.0, (128, 256)),
}


def _specs(**kw):
    jdt = {"bin_dtype": jnp.int32} if kw.pop("int_bins", False) else {}
    tdt = {"bin_dtype": torch.int32} if jdt else {}
    return jb.SketchSpec(**kw, **jdt), tb.SketchSpec(**kw, **tdt)


def _to_port(spec_t, jstate):
    return convert.state_from_numpy(
        spec_t, {f: np.asarray(getattr(jstate, f)) for f in LEAVES}, device="cpu"
    )


def assert_state_equal(got, ref, *, abs_scale=None, weighted=False, skip=()):
    """``got`` (port) vs ``ref`` (JAX): exact leaves, or rtol 1e-5 on the
    mass leaves when weighted; the sum leaf within 1e-5 * abs_scale."""
    for f in LEAVES:
        if f in skip:
            continue
        g = getattr(got, f).numpy()
        r = np.asarray(getattr(ref, f))
        assert g.dtype == r.dtype, f
        if f == "sum" and abs_scale is not None:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * abs_scale, err_msg=f)
        elif weighted and g.dtype == np.float32 and f not in ("min", "max"):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def _abs_scale(v, w=None):
    w = np.ones_like(v) if w is None else np.broadcast_to(w, v.shape)
    with np.errstate(invalid="ignore"):
        return np.nansum(np.abs(np.where(w > 0, v * w, 0.0)))


# ---------------------------------------------------------------------------
# SketchSpec / init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {"relative_accuracy": 0.0},
        {"relative_accuracy": 1.0},
        {"n_bins": 1},
        {"backend": "nope"},
        {"backend": "uniform_collapse", "mapping_name": "cubic_interpolated"},
        {"backend": "uniform_collapse", "collapse_threshold": 1.5},
        {"backend": "uniform_collapse", "max_collapses": 0},
        {"backend": "moment", "n_moments": 1},
        {"mapping_name": "nope"},
    ],
)
def test_spec_validation_matches_jax(kw):
    # The JAX spec resolves its mapping lazily; the port at construction.
    with pytest.raises(jb.SpecError):
        jb.SketchSpec(**kw).mapping
    with pytest.raises(SpecError):
        tb.SketchSpec(**kw)


def test_spec_fields_hash_and_dtypes():
    js, ts = _specs(relative_accuracy=0.02, n_bins=1024, mapping_name="cubic_interpolated")
    assert ts.key_offset == js.key_offset == -512
    assert ts.bin_dtype == torch.float32 and not ts.bins_integer
    assert hash(ts) == hash(js)  # same fields, same dtype names
    assert (ts.n_tiles, ts.gamma, ts.min_value, ts.max_value) == (
        js.n_tiles, js.gamma, js.min_value, js.max_value,
    )
    ji, ti = _specs(n_bins=512, int_bins=True)
    assert ti.bins_integer and hash(ti) == hash(ji)
    assert convert.spec_from_fields(**dataclasses.asdict(ji)) == ti
    with pytest.raises(SpecError):
        tb.SketchSpec(dtype=torch.float64)
    with pytest.raises(SpecError):
        tb.SketchSpec(bin_dtype=torch.int64)


@pytest.mark.parametrize("int_bins", [False, True])
def test_init_leaves_match_jax(int_bins):
    js, ts = _specs(n_bins=640, int_bins=int_bins)  # ragged last tile
    assert_state_equal(tb.init(ts, 256, "cpu"), jb.init(js, 256))


# ---------------------------------------------------------------------------
# add / quantile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_add_and_quantile_match_jax(regime):
    js, ts = _specs(n_bins=512)
    v = REGIMES[regime](np.random.RandomState(1)).astype(np.float32)
    ref = jax.block_until_ready(jb.add(js, jb.init(js, 128), jnp.asarray(v)))
    got = tb.add(ts, tb.init(ts, 128, "cpu"), torch.from_numpy(v))
    assert_state_equal(got, ref, abs_scale=_abs_scale(v))
    qj = np.asarray(jb.quantile(js, ref, jnp.asarray(QS)))
    qt = tb.quantile(ts, got, QS).numpy()
    np.testing.assert_allclose(qt, qj, rtol=1e-6, equal_nan=True)


def test_add_nan_padding_and_per_stream_offsets():
    """NaN values, weight <= 0 padding (with NaN/inf under it) and
    per-stream windows (some values collapse at both edges)."""
    js, ts = _specs(n_bins=512, mapping_name="linear_interpolated")
    r = np.random.RandomState(2)
    v = (r.lognormal(0, 3, (128, 256)) * np.where(r.rand(128, 256) < 0.3, -1, 1)).astype(
        np.float32
    )
    v[:, 0] = np.nan
    v[:, 1] = np.inf
    v[:, 2] = -1e-40
    w = r.choice([0.0, -1.0, 1.0, 2.5], size=(128, 256)).astype(np.float32)
    w[:, :2] = 0.0  # the NaN/inf lanes are padding
    w[5] = 1.0
    w[5, 0] = 1.0  # one live NaN: poisons that stream's sum
    offs = r.randint(-400, -100, 128).astype(np.int32)
    jst = jb.recenter(js, jb.init(js, 128), jnp.asarray(offs))
    tst = tb.recenter(ts, tb.init(ts, 128, "cpu"), torch.from_numpy(offs))
    ref = jax.block_until_ready(jb.add(js, jst, jnp.asarray(v), jnp.asarray(w)))
    got = tb.add(ts, tst, torch.from_numpy(v), torch.from_numpy(w))
    assert np.isnan(got.sum[5].item()) and np.isnan(float(ref.sum[5]))
    keep = np.arange(128) != 5
    np.testing.assert_allclose(
        got.sum.numpy()[keep], np.asarray(ref.sum)[keep], rtol=0,
        atol=1e-5 * _abs_scale(v[keep], w[keep]),
    )
    assert_state_equal(got, ref, weighted=True, skip=("sum",))


@pytest.mark.parametrize("live_share", [0.25, 0.5, 1.0])
def test_padded_ragged_batches_through_the_facade_match_jax(live_share):
    """Ragged batches padded to a fixed width, the public way to send them:
    ``BatchedDDSketch.add(values, weights)`` with each row's first L values
    live (L drawn so the live share is about ``live_share``; some rows
    empty) and weight 0 over NaN and +-inf after them.  The weights are
    dyadic (0.5, 1, 2, 3), so every mass sums exactly in any order: each
    leaf but ``sum`` equals the JAX facade's, the sum within 1e-5 *
    sum|v * w|, the quantiles rtol 1e-6 (NaN for an empty stream) against
    the un-jitted ``jb.quantile`` of the JAX facade's state: dyadic masses
    put ranks on integers, where XLA:CPU's fused multiply-add in the jitted
    tiers drops an answer a bucket (ROADMAP, "FMA in jitted ranks")."""
    n, s = 128, 256
    r = np.random.RandomState(14)
    j = jb.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512)
    t = tb.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device="cpu")
    scale = 0.0
    for _ in range(2):
        v = r.lognormal(0, 2, (n, s)) * np.where(r.rand(n, s) < 0.4, -1, 1)
        w = r.choice([0.5, 1.0, 2.0, 3.0], size=(n, s))
        if live_share < 1.0:
            live = r.randint(0, int(2 * live_share * s) + 1, n)
            live[:2] = 0
        else:
            live = np.full(n, s)
        pad = np.arange(s)[None, :] >= live[:, None]
        v[pad] = r.choice([np.nan, np.inf, -np.inf], int(pad.sum()))
        w[pad] = 0.0
        v, w = v.astype(np.float32), w.astype(np.float32)
        jax.block_until_ready(j.add(v, w).state)
        t.add(v, w)
        scale += _abs_scale(v, w)
    assert_state_equal(t.state, j.state, abs_scale=scale)
    qj = np.asarray(jax.block_until_ready(jb.quantile(j.spec, j.state, jnp.asarray(QS))))
    qt = t.get_quantile_values(QS).numpy()
    assert np.isnan(qt[0]).all() == (live_share < 1.0)
    np.testing.assert_allclose(qt, qj, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("int_bins", [False, True])
def test_merge_merge_axis_and_merge_aligned_match_jax(int_bins):
    js, ts = _specs(n_bins=512, int_bins=int_bins)
    r = np.random.RandomState(3)
    va = r.lognormal(0, 1, (128, 128)).astype(np.float32)
    vb = (-r.lognormal(2, 1, (128, 128))).astype(np.float32)
    ja, jb_ = jax.block_until_ready(
        [jb.add(js, jb.init(js, 128), jnp.asarray(x)) for x in (va, vb)]
    )
    ta, tb_ = (tb.add(ts, tb.init(ts, 128, "cpu"), torch.from_numpy(x)) for x in (va, vb))
    scale = _abs_scale(va) + _abs_scale(vb)
    assert_state_equal(tb.merge(ts, ta, tb_), jb.merge(js, ja, jb_), abs_scale=scale)
    stacked_j = jb.SketchState(*[jnp.stack([getattr(ja, f), getattr(jb_, f)]) for f in LEAVES])
    stacked_t = tb.SketchState(*[torch.stack([getattr(ta, f), getattr(tb_, f)]) for f in LEAVES])
    assert_state_equal(
        tb.merge_axis(ts, stacked_t), jb.merge_axis(js, stacked_j), abs_scale=scale
    )
    # Drifted windows: b recentred elsewhere first.
    offs = np.full(128, -150, np.int32)
    jb2 = jb.recenter(js, jb_, jnp.asarray(offs))
    tb2 = tb.recenter(ts, tb_, torch.from_numpy(offs))
    assert_state_equal(
        tb.merge_aligned(ts, ta, tb2), jb.merge_aligned(js, ja, jb2), abs_scale=scale
    )


def test_recenter_auto_offset_and_recenter_to_data_match_jax():
    js, ts = _specs(n_bins=512)
    r = np.random.RandomState(4)
    v = (r.lognormal(3, 1.5, (128, 256)) * np.where(r.rand(128, 256) < 0.2, -1, 1)).astype(
        np.float32
    )
    w = (r.rand(128, 256) > 0.1).astype(np.float32)
    v[7] = 0.0  # no live nonzero value: keeps its offset
    ji, ti = jb.init(js, 128), tb.init(ts, 128, "cpu")
    oj = np.asarray(jb.auto_offset(js, ji, jnp.asarray(v), jnp.asarray(w)))
    ot = tb.auto_offset(ts, ti, torch.from_numpy(v), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(ot, oj)
    # Ingest on the default window (collapses), then recenter both ways.
    ref = jax.block_until_ready(jb.add(js, ji, jnp.asarray(v)))
    got = tb.add(ts, ti, torch.from_numpy(v))
    scale = _abs_scale(v)
    for shift in (oj, np.int32(-300), oj + 37):
        assert_state_equal(
            tb.recenter(ts, got, torch.as_tensor(np.array(shift))),
            jb.recenter(js, ref, jnp.asarray(shift)),
            abs_scale=scale,
        )
    np.testing.assert_array_equal(
        tb.data_center_offsets(ts, got).numpy(), np.asarray(jb.data_center_offsets(js, ref))
    )
    assert_state_equal(
        tb.recenter_to_data(ts, got), jb.recenter_to_data(js, ref), abs_scale=scale
    )
    for a, b in zip(tb.overflow_risk(ts, got), jb.overflow_risk(js, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int32_bins_stay_exact_past_2_24():
    """A bin driven past f32's 2**24 ceiling by a weight, then unit adds:
    integer bins, counters and quantiles agree exactly with the JAX
    package's integer mode."""
    js, ts = _specs(n_bins=512, int_bins=True)
    v = np.full((128, 128), 3.0, np.float32)
    v[:, 64:] = -0.5
    w = np.zeros((128, 128), np.float32)
    w[:, 0] = 2.0**24
    w[:, 64] = 2.0**24 + 2.0
    ref = jax.block_until_ready(jb.add(js, jb.init(js, 128), jnp.asarray(v), jnp.asarray(w)))
    got = tb.add(ts, tb.init(ts, 128, "cpu"), torch.from_numpy(v), torch.from_numpy(w))
    for _ in range(3):
        ref = jax.block_until_ready(jb.add(js, ref, jnp.asarray(v)))
        got = tb.add(ts, got, torch.from_numpy(v))
    assert int(got.count[0]) > 2**25 and got.bins_pos.dtype == torch.int32
    assert_state_equal(got, ref, abs_scale=_abs_scale(v, w) * 4)
    qs = [0.0, 0.3, 0.5, 0.500001, 0.9, 1.0]
    np.testing.assert_allclose(
        tb.quantile(ts, got, qs).numpy(), np.asarray(jb.quantile(js, ref, jnp.asarray(qs))),
        rtol=1e-6,
    )
    for a, b in zip(tb.overflow_risk(ts, got), jb.overflow_risk(js, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_convert_round_trip_of_a_jax_state():
    js, ts = _specs(n_bins=512)
    v = REGIMES["mixed_sign"](np.random.RandomState(5)).astype(np.float32)
    jstate = jb.add(js, jb.init(js, 128), jnp.asarray(v))
    port = _to_port(ts, jstate)
    back = convert.state_to_numpy(port)
    for f in LEAVES:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jstate, f)), err_msg=f)
    np.testing.assert_allclose(
        tb.quantile(ts, port, QS).numpy(),
        np.asarray(jb.quantile(js, jstate, jnp.asarray(QS))),
        rtol=1e-6, equal_nan=True,
    )
    with pytest.raises(SpecError):
        convert.state_from_numpy(ts, {f: back[f] for f in LEAVES if f != "sum"}, "cpu")
    bad = dict(back, bins_pos=back["bins_pos"].astype(np.int32))
    with pytest.raises(SpecError):
        convert.state_from_numpy(ts, bad, "cpu")


# The smallest weighted rank boundary: the JAX package (eager and jitted) and
# the pure-Python DDSketch answer 2.6642716 at q = 1.  The third prefix sum,
# accumulated in f32, equals rank = count - 1 exactly; accumulated in f64 and
# rounded once it lands one ulp above, and the answer drops to 0.4403.
BOUNDARY_FIRST = ([0.43233886, 0.20904201], [1.0375978, 0.97834975])
BOUNDARY_SECOND = [2.7012644, 0.36471483]


def _boundary_state(n, engine):
    v1, w1 = (np.tile(np.asarray(x, np.float32), (n, 1)) for x in BOUNDARY_FIRST)
    v2 = np.tile(np.asarray(BOUNDARY_SECOND, np.float32), (n, 1))
    j = jb.BatchedDDSketch(n, relative_accuracy=0.02, n_bins=256, engine="xla")
    jax.block_until_ready(j.add(v1, w1).add(v2).state)
    t = tb.BatchedDDSketch(n, relative_accuracy=0.02, n_bins=256, engine=engine, device="cpu")
    t.add(v1, w1).add(v2)
    return j, t


def test_weighted_rank_boundary_matches_jax():
    """Every plain rank walk accumulates its f32 prefix sums in f32 on the
    CPU, as JAX does (``batched.cumsum_f32``): the pinned weighted input
    answers 2.6642716 through the facade on ``engine="plain"`` and through
    each kernel's plain version."""
    from sketches_tpu_torch import kernels

    j, t = _boundary_state(128, "plain")
    want = np.asarray(jb.quantile(j.spec, j.state, jnp.asarray([1.0, 0.5])))
    assert want[0, 0] == np.float32(2.6642716)
    assert_state_equal(t.state, j.state, weighted=True, abs_scale=600.0)
    np.testing.assert_array_equal(t.get_quantile_values([1.0, 0.5]).numpy(), want)
    st, spec = t.state, t.spec
    qs = torch.tensor([1.0, 0.5])
    lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, st)
    k_tiles, with_neg_t = kernels.plan_tile_query(spec, st, qs)
    answers = {
        "quantile": tb.quantile(spec, st, qs),
        "fused_quantile": kernels.fused_quantile(spec, st, qs),
        "windowed": kernels.fused_quantile_windowed(
            spec, st, qs, lo_w, n_wblocks=n_w, w_tiles=w_t, with_neg=with_neg),
        "wxla": kernels.quantile_windowed_xla(
            spec, st, qs, lo_w * w_t, n_tiles_window=n_w * w_t, with_neg=with_neg),
        "tiles": kernels.fused_quantile_tiles(
            spec, st, qs, k_tiles=k_tiles, with_neg=with_neg_t),
        "overlap": kernels.fused_quantile_tiles_overlap(
            spec, st, qs, k_tiles=k_tiles, with_neg=with_neg_t),
        "data_center_offsets": tb.data_center_offsets(spec, st),
    }
    centre = answers.pop("data_center_offsets")
    np.testing.assert_array_equal(
        centre.numpy(), np.asarray(jb.data_center_offsets(j.spec, j.state)))
    for name, got in answers.items():
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_cumsum_f32_accumulates_in_f32():
    x = torch.tensor([[0.97834975, 1.0, 1.0375978, 1.0]])
    got = tb.cumsum_f32(x)
    acc = np.float32(0.0)
    for i, xi in enumerate(x[0].numpy()):
        acc = np.float32(acc + xi)
        assert got[0, i].item() == acc
    ints = torch.tensor([[3, 0, 2**24, 1]], dtype=torch.int32)
    assert tb.cumsum_f32(ints).tolist() == [[3, 3, 2**24 + 3, 2**24 + 4]]


@pytest.mark.parametrize("engine", ["auto", "plain"])
@pytest.mark.parametrize("n", [128, 100])
def test_xla_tier_routes_through_the_floor_router(engine, n, monkeypatch):
    """Both facades' ``xla`` tier answers through ``kernels.floor_quantile``
    (K2 on the card) at any stream count; only the ``plain`` engine calls
    ``batched.quantile`` itself.  The answers equal ``batched.quantile``."""
    from sketches_tpu_torch import kernels, parallel

    routed = []
    real = kernels.floor_quantile

    def spy(spec, state, qs):
        routed.append(state.n_streams)
        return real(spec, state, qs)

    monkeypatch.setattr(kernels, "floor_quantile", spy)
    qs = [0.5, 0.99]
    v = np.random.RandomState(5).lognormal(0.0, 1.0, (n, 128)).astype(np.float32)
    b = tb.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=256, engine=engine, device="cpu")
    d = parallel.DistributedDDSketch(n, mesh=parallel.SketchMesh(devices=["cpu", "cpu"]),
                                     relative_accuracy=0.01, n_bins=256, engine=engine)
    b.add(v)
    d.add(np.concatenate([v, v], axis=1))
    floor = ("overlap", "tiles", "windowed", "wxla")
    for facade, state in ((b, b.state), (d, d.merged_state())):
        tier, got = facade.get_quantile_values_resolved(qs, disabled_tiers=floor)
        assert tier == "xla"
        np.testing.assert_array_equal(got.numpy(), tb.quantile(facade.spec, state, qs).numpy())
    assert routed == ([] if engine == "plain" else [n, n])
