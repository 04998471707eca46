"""The port's distributed tier (``sketches_tpu_torch.parallel``) against the
JAX package's, on the CPU.

The port's meshes are ``["cpu"] * k`` (one process drives every cell, the
kernels run their plain versions); the JAX meshes are the first ``k`` of the
8 virtual CPU devices ``tests/conftest.py`` sets up, with
``engine="pallas"`` (its kernels in interpret mode) against the port's
``engine="auto"``, which resolves to the kernel path.  Both ingest the same
batches, made from a seed with numpy.

Tolerances, with their reasons:

* **Exact** for every partial and merged leaf but ``sum`` under unit
  weights (integer masses add exactly in any order), for offsets, and for
  the resolved tiers (identical plans).
* **atol 1e-5 * sum|v|** for ``sum`` (f32 sums in another order; mixed
  signs cancel) and **rtol 1e-5** for weighted bins and counters.
* **rtol 1e-6** for quantiles: the same bucket, whose decoded value may
  differ by an ulp of ``exp`` between XLA:CPU and torch.

JAX results are waited for before the port's side runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu import parallel as jp
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import convert
from sketches_tpu_torch import parallel as tp
from sketches_tpu_torch.resilience import (
    ShardLossError,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

QS = [0.5, 0.9, 0.99, 0.999]
ALPHA = 0.01
RUNGS = [((), "overlap"), (("overlap",), "tiles"), (("tiles",), "windowed"),
         (("windowed",), "wxla"), (("windowed", "wxla"), "xla")]


def _meshes(layout):
    """(n_streams, batch width, JAX SketchMesh, port SketchMesh)."""
    jd, td = jax.devices(), ["cpu"] * 8
    if layout.startswith("v"):
        k = int(layout[1:])
        return 256, 128 * k, jp.SketchMesh(k, devices=jd[:k]), tp.SketchMesh(k, devices=td[:k])
    if layout == "s4":
        kw = dict(value_axis=None, stream_axis="streams", stream_shards=4)
        return 512, 128, jp.SketchMesh(4, devices=jd[:4], **kw), tp.SketchMesh(4, devices=td[:4], **kw)
    if layout == "s2v4":
        kw = dict(stream_axis="streams", stream_shards=2)
        return 256, 512, jp.SketchMesh(8, devices=jd, **kw), tp.SketchMesh(8, devices=td, **kw)
    assert layout == "h2x2"
    return (256, 512, jp.make_hierarchical_mesh(n_hosts=2, devices=jd[:4]),
            tp.make_hierarchical_mesh(n_hosts=2, devices=td[:4]))


def _facades(layout, **kw):
    n, width, jm, tm = _meshes(layout)
    j = jp.DistributedDDSketch(
        n, mesh=jm, value_axis=jm.value_axis, stream_axis=jm.stream_axis,
        relative_accuracy=ALPHA, n_bins=512, engine="pallas", **kw,
    )
    t = tp.DistributedDDSketch(n, mesh=tm, relative_accuracy=ALPHA, n_bins=512, **kw)
    return n, width, j, t


GAMMA = (1 + ALPHA) / (1 - ALPHA)


def _mid_bucket(v):
    """Each value moved to the middle of its bucket in log space: XLA:CPU's
    f32 ``log`` is not correctly rounded, so a value within an ulp of a
    bucket edge can key one bucket apart in the two packages (a reference
    platform difference, not a fault); half a bucket away, keys agree."""
    a = np.abs(v).astype(np.float64)
    k = np.ceil(np.log(a) / np.log(GAMMA))
    return (np.sign(v) * GAMMA ** (k - 0.5)).astype(np.float32)


def _batches(n, width, seed, n_batches=2, mixed=True):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        v = r.lognormal(0, 2, (n, width))
        if mixed:
            v = v * np.where(r.rand(n, width) < 0.4, -1, 1)
        out.append(_mid_bucket(v))
    return out


def _feed(j, t, batches, weights=None):
    for i, v in enumerate(batches):
        w = None if weights is None else weights[i]
        jax.block_until_ready(j.add(v, w).partials)
        t.add(v, w)


def _assert_state(port, ref, scale, weighted=False):
    for f in tb.LEAVES:
        g = getattr(port, f).numpy()
        r = np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        if f == "sum":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * scale, err_msg=f)
        elif weighted and g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("layout", ["v2", "v4", "v8", "s4", "s2v4", "h2x2"])
def test_mesh_matches_jax(layout):
    n, width, j, t = _facades(layout)
    assert t.engine == "kernel" and j.engine == "pallas"
    assert t.n_value_shards == j.n_value_shards
    batches = _batches(n, width, seed=len(layout))
    _feed(j, t, batches)
    scale = sum(np.abs(v).sum() for v in batches)
    _assert_state(t.partials, j.partials, scale)
    _assert_state(t.merged_state(), j.merged_state(), scale)
    # Equal offsets on every partial: the fold's invariant.
    offs = t.partials.key_offset.numpy()
    assert (offs == offs[:1]).all()
    # The tier the JAX facade resolves, and the answer every engine gives
    # (the JAX floor, on its folded state).
    tier_j = j._query_choice(tuple(QS))[0]
    tier_t, got = t.get_quantile_values_resolved(QS)
    assert tier_t == tier_j == "overlap"
    ref = np.asarray(jb.quantile(j.spec, j.merged_state(), jnp.asarray(QS)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("mixed", [True, False])
def test_every_rung_matches_jax(mixed):
    n, width, j, t = _facades("v4")
    _feed(j, t, _batches(n, width, seed=40 + mixed, mixed=mixed))
    tiers = []
    for off, _ in RUNGS:
        tier_j, vj = j.get_quantile_values_resolved(QS, disabled_tiers=off)
        vj = np.asarray(jax.block_until_ready(vj))
        tier_t, vt = t.get_quantile_values_resolved(QS, disabled_tiers=off)
        assert tier_t == tier_j
        np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-6, equal_nan=True)
        tiers.append(tier_t)
    ladder = "tiles" if mixed else "windowed"
    assert tiers == ["overlap", ladder, "windowed", "wxla", "xla"]
    assert float(t.get_quantile_value(0.5)[0]) == float(vt[0, 0])


def test_plain_engine_and_weighted_partials_match_jax():
    n, width, jm, tm = _meshes("v2")
    j = jp.DistributedDDSketch(n, mesh=jm, relative_accuracy=ALPHA, n_bins=512, engine="xla")
    t = tp.DistributedDDSketch(n, mesh=tm, relative_accuracy=ALPHA, n_bins=512, engine="plain")
    assert t.engine == "plain"
    batches = _batches(n, width, seed=9)
    r = np.random.RandomState(10)
    weights = [r.uniform(0.0, 3.0, v.shape).astype(np.float32) for v in batches]
    _feed(j, t, batches, weights)
    scale = 3 * sum(np.abs(v).sum() for v in batches)
    _assert_state(t.partials, j.partials, scale, weighted=True)
    tier_j, vj = j.get_quantile_values_resolved(QS, disabled_tiers=("wxla",))
    tier_t, vt = t.get_quantile_values_resolved(QS, disabled_tiers=("wxla",))
    assert tier_t == tier_j == "xla"
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, equal_nan=True)


def test_first_batch_autocenter_12_decades():
    """Per-stream scales over 12 decades: every stream gets its own window
    (the max over value shards of their batch-median offsets), identical on
    every partial, and the answers keep the alpha contract."""
    n = 256
    scales = (10.0 ** np.linspace(-6.0, 6.0, n))[:, None]
    data = _mid_bucket(np.random.RandomState(0).lognormal(0, 0.3, (n, 512)) * scales)
    _, _, jm, tm = _meshes("s2v4")
    j = jp.DistributedDDSketch(n, mesh=jm, value_axis="values", stream_axis="streams",
                               relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tp.DistributedDDSketch(n, mesh=tm, relative_accuracy=ALPHA, n_bins=512)
    _feed(j, t, [data])
    np.testing.assert_array_equal(t.partials.key_offset.numpy(), np.asarray(j.partials.key_offset))
    qs = [0.25, 0.5, 0.9, 0.99]
    got = t.get_quantile_values(qs).numpy()
    exact = np.quantile(data, qs, axis=1, method="lower").T
    assert np.all(np.abs(got - exact) <= 0.0101 * np.abs(exact) + 1e-30)
    assert float(t.collapsed_fraction().max()) == 0.0


def test_merge_recenter_and_policy_match_jax():
    n, width, j, t = _facades("v2")
    _, _, j2, t2 = _facades("v2")
    a, b = _batches(n, width, seed=21)
    _feed(j, t, [a])
    b = _mid_bucket(b * 40)
    _feed(j2, t2, [b])
    j.merge(j2)
    t.merge(t2)
    scale = np.abs(a).sum() + np.abs(b).sum()
    _assert_state(t.partials, j.partials, scale)
    with pytest.raises(UnequalSketchParametersError):
        t.merge(tp.DistributedDDSketch(n, mesh=t.mesh, n_bins=1024))
    with pytest.raises(SpecError):
        t.merge(tp.DistributedDDSketch(n, mesh=tp.SketchMesh(4, devices=["cpu"] * 4), n_bins=512))
    drift = _mid_bucket(b * 5e3)
    _feed(j, t, [drift, drift])
    assert t.maybe_recenter() == j.maybe_recenter() is True
    _feed(j, t, [drift])
    scale += 3 * np.abs(drift).sum()
    _assert_state(t.partials, j.partials, scale)
    np.testing.assert_array_equal(t.collapsed_fraction().numpy(), np.asarray(j.collapsed_fraction()))
    jax.block_until_ready(j.recenter_to_data().partials)
    t.recenter_to_data()
    _assert_state(t.partials, j.partials, scale)
    jax.block_until_ready(j.recenter(-300).partials)
    t.recenter(-300)
    _assert_state(t.partials, j.partials, scale)
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))


def test_fold_live_partials_merge_partial_and_reshard():
    n, width, j, t = _facades("v4")
    batches = _batches(n, width, seed=31)
    _feed(j, t, batches)
    scale = sum(np.abs(v).sum() for v in batches)
    live = np.array([True, False, True, True])
    _assert_state(
        tp.fold_live_partials(t.spec, t.partials, live),
        jp.fold_live_partials(j.spec, j.partials, live), scale,
    )
    st_t, rep_t = t.merge_partial(live)
    st_j, rep_j = j.merge_partial(live)
    _assert_state(st_t, st_j, scale)
    assert rep_t.dead_shards == rep_j.dead_shards == [1]
    np.testing.assert_array_equal(rep_t.dropped_count, rep_j.dropped_count)
    assert rep_t.total_dropped_fraction == rep_j.total_dropped_fraction
    with pytest.raises(ShardLossError):
        t.merge_partial([False] * 4)
    with pytest.raises(SketchValueError):
        t.merge_partial([True] * 3)
    new_t, rr_t = t.reshard(n_devices=2, live_mask=live)
    new_j, rr_j = j.reshard(n_devices=2, live_mask=live)
    assert rr_t.exact and rr_j.exact
    assert (rr_t.from_devices, rr_t.to_devices) == (4, 2) == (rr_j.from_devices, rr_j.to_devices)
    np.testing.assert_array_equal(rr_t.dropped_count, rr_j.dropped_count)
    assert rr_t.total_dropped == rr_j.total_dropped
    _assert_state(new_t.merged_state(), new_j.merged_state(), scale)
    _assert_state(new_t.partials, new_j.partials, scale)
    np.testing.assert_array_equal(  # the original fleet is untouched
        t.merged_state().count.numpy(), np.asarray(j.merged_state().count)
    )
    with pytest.raises(SpecError):
        t.reshard()


def test_fold_hosts_and_psum_merge_match_jax():
    js, ts = jb.SketchSpec(n_bins=512), tb.SketchSpec(n_bins=512)
    r = np.random.RandomState(5)
    va = _mid_bucket(r.lognormal(0, 1, (128, 256)))
    vb = _mid_bucket(r.lognormal(0, 1, (128, 256)) * 300)
    ja, jb_ = jb.BatchedDDSketch(128, spec=js, auto_recenter=True), \
        jb.BatchedDDSketch(128, spec=js, auto_recenter=True)
    ta, tb_ = tb.BatchedDDSketch(128, spec=ts, device="cpu", auto_recenter=True), \
        tb.BatchedDDSketch(128, spec=ts, device="cpu", auto_recenter=True)
    jax.block_until_ready([ja.add(va).state, jb_.add(vb).state])
    ta.add(va)
    tb_.add(vb)
    scale = np.abs(va).sum() + np.abs(vb).sum()
    for reach in (None, [True, False]):
        f_j, rep_j = jp.fold_hosts(js, [ja.state, jb_.state], reachable=reach)
        f_t, rep_t = tp.fold_hosts(ts, [ta.state, tb_.state], reachable=reach)
        _assert_state(f_t, f_j, scale)
        np.testing.assert_array_equal(rep_t.dropped_count, rep_j.dropped_count)
    with pytest.raises(ShardLossError):
        tp.fold_hosts(ts, [ta.state, tb_.state], reachable=[False, False])
    with pytest.raises(SketchValueError):
        tp.fold_hosts(ts, [])
    # The hierarchical fold equals the flat one for integer masses.
    parts = [ta.state] * 4
    flat = tp.psum_merge(parts)
    tree = tp.psum_merge(parts, n_hosts=2)
    for f in tb.LEAVES:
        assert torch.equal(getattr(flat, f), getattr(tree, f)), f
    assert torch.equal(flat.count, 4 * ta.state.count)


def test_partials_carried_across_by_convert():
    n, width, j, t = _facades("v4")
    _feed(j, t, _batches(n, width, seed=51))
    leaves = {f: np.asarray(getattr(j.partials, f)) for f in tb.LEAVES}
    fresh = tp.DistributedDDSketch(n, mesh=t.mesh, spec=t.spec)
    fresh.partials = convert.partials_from_numpy(t.spec, leaves, device="cpu")
    back = convert.partials_to_numpy(fresh.partials)
    for f in tb.LEAVES:
        np.testing.assert_array_equal(back[f], leaves[f], err_msg=f)
    assert torch.equal(fresh.get_quantile_values(QS), t.get_quantile_values(QS))
    restored = tp.DistributedDDSketch.from_merged_state(fresh.partials, t.spec, mesh=t.mesh)
    assert torch.equal(restored.merged_state().count, t.merged_state().count)
    batched = restored.to_batched()
    assert torch.equal(batched.get_quantile_values(QS), t.get_quantile_values(QS))
    with pytest.raises(SpecError):
        convert.partials_from_numpy(t.spec, {f: v[0] for f, v in leaves.items()}, device="cpu")


def test_mesh_layouts_validate_like_jax():
    cpus = ["cpu"] * 8
    with pytest.raises(SpecError):
        tp.SketchMesh(9, devices=cpus)
    with pytest.raises(SpecError):
        tp.SketchMesh(4, value_axis=None, devices=cpus)
    with pytest.raises(SpecError):
        tp.SketchMesh(6, stream_axis="streams", stream_shards=4, devices=cpus)
    with pytest.raises(SpecError):
        tp.make_hierarchical_mesh(n_hosts=3, devices=cpus[:4])
    m = tp.SketchMesh(8, stream_axis="streams", stream_shards=2, devices=cpus)
    assert (m.n_value_shards, m.stream_shards) == (4, 2)
    assert [len(r) for r in m.grid()] == [4, 4]
    assert m.resized(4).n_value_shards == 2
    states = tp.shard_streams(tb.init(tb.SketchSpec(n_bins=512), 10, "cpu"), m)
    assert [s.n_streams for s in states] == [5, 5]
    dm = tp.default_mesh(("streams", "values"), (2, 2), devices=cpus[:4])
    assert (dm.stream_shards, dm.n_value_shards) == (2, 2)
    with pytest.raises(SketchValueError):
        tp.DistributedDDSketch(4, mesh=tp.SketchMesh(2, devices=cpus[:2]), n_bins=512).add(
            np.ones((4, 5), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(SpecError):
            tp.SketchMesh()
        with pytest.raises(SpecError):
            tp.DistributedDDSketch(4, n_bins=512)
    with pytest.raises(SpecError):
        tp.DistributedDDSketch(256, mesh=tp.SketchMesh(2, devices=cpus[:2]), engine="kernel")
