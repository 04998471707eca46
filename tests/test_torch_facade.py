"""The port's ``BatchedDDSketch`` end to end against the JAX facade, on the CPU.

The port runs with ``device="cpu"`` (each kernel's plain version); the JAX
facade runs ``engine="pallas"`` (its kernels in interpret mode).  Both
ingest the same three batches of 256 streams x 256 values at 512 bins.
Most tests switch the overlap engine off on both sides
(``SKETCHES_TPU_OVERLAP=0``) to hold the windowed/tiles ladder; the
overlap tests run both with it on, its default.

Tolerances, with their reasons:

* **Exact**: first-batch window offsets, every state leaf but ``sum``, the
  resolved query tier (unit weights: integer masses, identical plans).
* **atol 1e-5 * sum|v|** for the ``sum`` leaf (f32 sums in another order,
  mixed signs cancel).
* **rtol 1e-6** for the quantiles (``exp`` may differ by an ulp between
  XLA:CPU and torch), and the DDSketch contract -- within alpha of the
  exact lower quantile -- wherever that quantile keys inside its stream's
  window (collapse only moves mass into the two edge buckets).

JAX results are waited for before the port's side runs, so the two never
compute at once in one process.
"""

import jax
import numpy as np
import pytest
import torch

from sketches_tpu import batched as jb
from sketches_tpu_torch import batched as tb
from sketches_tpu_torch import convert
from sketches_tpu_torch.resilience import (
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

QS = [0.5, 0.9, 0.99, 0.999]
ALPHA = 0.01
N, S = 256, 256

MIXES = {
    "lognormal2": (lambda r: r.lognormal(0, 2, (N, S)), "windowed"),
    "tight": (lambda r: r.lognormal(0, 0.05, (N, S)), "windowed"),
    "mixed40": (
        lambda r: r.lognormal(0, 2, (N, S)) * np.where(r.rand(N, S) < 0.4, -1.0, 1.0),
        "tiles",
    ),
}


@pytest.fixture
def overlap_off(monkeypatch):
    monkeypatch.setenv("SKETCHES_TPU_OVERLAP", "0")


def _batches(mix, seed=0, n=3):
    r = np.random.RandomState(seed)
    return [MIXES[mix][0](r).astype(np.float32) for _ in range(n)]


def _assert_leaves(port, jax_state, abs_scale):
    for f in tb.LEAVES:
        g = getattr(port, f).numpy()
        r = np.asarray(getattr(jax_state, f))
        if f == "sum":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * abs_scale, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_facade_matches_jax(overlap_off, mix):
    batches = _batches(mix)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    assert t.engine == "kernel" and t.device == torch.device("cpu")
    for i, v in enumerate(batches):
        jax.block_until_ready(j.add(v).state)
        t.add(v)
        if i == 0:
            np.testing.assert_array_equal(
                t.state.key_offset.numpy(), np.asarray(j.state.key_offset)
            )
    _assert_leaves(t.state, j.state, sum(np.abs(v).sum() for v in batches))
    tier_j, vj = j.get_quantile_values_resolved(QS)
    vj = np.asarray(jax.block_until_ready(vj))
    tier_t, vt = t.get_quantile_values_resolved(QS)
    assert tier_t == tier_j == MIXES[mix][1]
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-6)
    # The sketch's own contract against exact lower quantiles.
    data = np.concatenate(batches, axis=1).astype(np.float64)
    exact = np.quantile(data, QS, axis=1, method="lower").T
    # Collapse only touches a window's two edge buckets: every quantile
    # whose exact value keys strictly inside its stream's window is held
    # to alpha.
    koff = t.state.key_offset.numpy()[:, None]
    keys = np.vectorize(lambda x: t.spec.mapping.key(abs(x)))(exact)
    inside = (keys > koff) & (keys < koff + t.spec.n_bins - 1)
    assert inside.mean() > 0.9
    err = np.abs(vt.numpy()[inside] - exact[inside])
    assert np.all(err <= ALPHA * np.abs(exact[inside]) * (1 + 1e-6))


@pytest.mark.parametrize("mix,ladder_tier", [("lognormal2", "windowed"), ("mixed40", "tiles")])
def test_overlap_is_the_default_route_like_jax(monkeypatch, mix, ladder_tier):
    monkeypatch.delenv("SKETCHES_TPU_OVERLAP", raising=False)
    batches = _batches(mix, seed=7)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    for v in batches:
        jax.block_until_ready(j.add(v).state)
        t.add(v)
    answers = []
    for off in ((), ("overlap",)):
        tier_j, vj = j.get_quantile_values_resolved(QS, disabled_tiers=off)
        vj = np.asarray(jax.block_until_ready(vj))
        tier_t, vt = t.get_quantile_values_resolved(QS, disabled_tiers=off)
        assert tier_t == tier_j == ("overlap" if not off else ladder_tier)
        np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-6)
        answers.append(vt)
    # The engines answer identically; the switch sends both facades down
    # the ladder.
    assert torch.equal(answers[0], answers[1])
    monkeypatch.setenv("SKETCHES_TPU_OVERLAP", "0")
    tier_j, vj = j.get_quantile_values_resolved(QS)
    tier_t, vt = t.get_quantile_values_resolved(QS)
    assert tier_t == tier_j == ladder_tier
    assert torch.equal(vt, answers[0])


def test_disabled_tiers_and_plain_engine_route_like_jax(overlap_off):
    batches = _batches("mixed40", seed=1)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
    jx = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="xla")
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    tp = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                            engine="plain")
    assert tp.engine == "plain"
    for v in batches:
        jax.block_until_ready([j.add(v).state, jx.add(v).state])
        t.add(v)
        tp.add(v)
    cases = [(j, t, ()), (j, t, ("tiles",)), (j, t, ("windowed",)),
             (j, t, ("windowed", "wxla")), (jx, tp, ())]
    tiers = []
    for jf, tf, off in cases:
        tier_j, vj = jf.get_quantile_values_resolved(QS, disabled_tiers=off)
        vj = np.asarray(jax.block_until_ready(vj))
        tier_t, vt = tf.get_quantile_values_resolved(QS, disabled_tiers=off)
        assert tier_t == tier_j
        np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-6)
        tiers.append(tier_t)
    assert tiers == ["tiles", "windowed", "wxla", "xla", "wxla"]


def test_merge_recenter_and_policy_match_jax(overlap_off):
    a_vals, b_vals = _batches("lognormal2", seed=2, n=2)
    drift = (_batches("lognormal2", seed=3, n=1)[0] * 5e3).astype(np.float32)
    js = [jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas")
          for _ in range(2)]
    ts = [tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
          for _ in range(2)]
    for jf, tf, v in zip(js, ts, (a_vals, b_vals * 30)):
        jax.block_until_ready(jf.add(v).state)
        tf.add(v)
    js[0].merge(js[1])
    ts[0].merge(ts[1])
    jax.block_until_ready(js[0].state)
    scale = np.abs(a_vals).sum() + np.abs(b_vals * 30).sum()
    _assert_leaves(ts[0].state, js[0].state, scale)
    with pytest.raises(UnequalSketchParametersError):
        ts[0].merge(tb.BatchedDDSketch(N, n_bins=1024, device="cpu"))
    # Drift past the high edge, then the policy: arm, recenter on the next
    # batch, and the explicit recenters.
    for _ in range(2):
        jax.block_until_ready(js[0].add(drift).state)
        ts[0].add(drift)
    assert ts[0].maybe_recenter() == js[0].maybe_recenter() is True
    jax.block_until_ready(js[0].add(drift).state)
    ts[0].add(drift)
    scale += 3 * np.abs(drift).sum()
    _assert_leaves(ts[0].state, js[0].state, scale)
    np.testing.assert_array_equal(
        ts[0].collapsed_fraction().numpy(), np.asarray(js[0].collapsed_fraction())
    )
    jax.block_until_ready(js[0].recenter_to_data().state)
    ts[0].recenter_to_data()
    _assert_leaves(ts[0].state, js[0].state, scale)
    jax.block_until_ready(js[0].recenter(-300).state)
    ts[0].recenter(-300)
    _assert_leaves(ts[0].state, js[0].state, scale)
    for a, b in zip(ts[0].overflow_risk(), js[0].overflow_risk()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_copy_state_setter_and_accessors():
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu")
    v = _batches("lognormal2", seed=4, n=1)[0]
    c0 = t.copy()  # taken before the first add: still auto-centres
    t.add(v)
    c0.add(v)
    c = t.copy()
    c.add(v)
    assert int(t.count[0]) == S and int(c.count[0]) == 2 * S
    np.testing.assert_array_equal(c0.state.key_offset.numpy(), t.state.key_offset.numpy())
    before = t.get_quantile_values(QS)
    t.state = c.state  # the setter drops the cached plans
    np.testing.assert_array_equal(
        t.get_quantile_values(QS).numpy(), tb.quantile(t.spec, c.state, QS).numpy()
    )
    assert not torch.equal(before, t.get_quantile_values(QS))
    assert float(t.get_quantile_value(0.5)[0]) == float(t.get_quantile_values([0.5])[0, 0])
    assert torch.equal(t.num_values, t.count) and t.relative_accuracy == ALPHA
    torch.testing.assert_close(t.avg, t.sum / t.count)
    with pytest.raises(SketchValueError):
        t.add_validated(v, -np.ones_like(v))


def test_int32_bins_route_and_answer_like_jax(overlap_off):
    batches = _batches("mixed40", seed=5, n=2)
    w = np.full((N, S), 3.0, np.float32)
    j = jb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, engine="pallas",
                           bin_dtype=jax.numpy.int32)
    t = tb.BatchedDDSketch(N, relative_accuracy=ALPHA, n_bins=512, device="cpu",
                           bin_dtype=torch.int32)
    jax.block_until_ready(j.add(batches[0], w).state)
    t.add(batches[0], w)
    jax.block_until_ready(j.add(batches[1]).state)
    t.add(batches[1])
    _assert_leaves(t.state, j.state, 4 * sum(np.abs(v).sum() for v in batches))
    tier_j, vj = j.get_quantile_values_resolved(QS)
    vj = np.asarray(jax.block_until_ready(vj))
    tier_t, vt = t.get_quantile_values_resolved(QS)
    assert tier_t == tier_j == "wxla"
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-6)


def test_chunked_stream_ops_match_one_pass(monkeypatch):
    """Large facades apply ingest and merge chunk by chunk, in place; the
    result equals the single-pass one (384 streams in 128-stream chunks)."""
    r = np.random.RandomState(6)
    batches = [
        (r.lognormal(0, 2, (384, 128)) * np.where(r.rand(384, 128) < 0.4, -1, 1)).astype(
            np.float32
        )
        for _ in range(3)
    ]
    spec = tb.SketchSpec(ALPHA, n_bins=256)
    one = tb.BatchedDDSketch(384, spec=spec, device="cpu", auto_recenter=True)
    chunked = tb.BatchedDDSketch(384, spec=spec, device="cpu", auto_recenter=True)
    for v in batches:
        one.add(v)
        monkeypatch.setattr(tb, "_CHUNK_ELEMS", 1 << 14)
        assert tb._stream_chunk(384, 256) == 128
        chunked.add(v)
        monkeypatch.undo()
    for f in tb.LEAVES:
        torch.testing.assert_close(getattr(chunked.state, f), getattr(one.state, f),
                                   rtol=0, atol=0, equal_nan=True)
    monkeypatch.setattr(tb, "_CHUNK_ELEMS", 1 << 14)
    chunked.merge(one)
    assert torch.equal(chunked.count, 2 * one.count)


def test_default_device_is_the_card():
    state = tb.init(tb.SketchSpec(n_bins=512), N, device="cpu")
    sk = tb.BatchedDDSketch(N, spec=tb.SketchSpec(n_bins=512), state=state)
    assert sk.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert tb.BatchedDDSketch(N, n_bins=512).device.type == "cuda"
        assert tb.init(tb.SketchSpec(n_bins=512), N).device.type == "cuda"
    else:
        with pytest.raises(SpecError):
            tb.BatchedDDSketch(N, n_bins=512)
        with pytest.raises(SpecError):
            tb.init(tb.SketchSpec(n_bins=512), N)
        with pytest.raises(SpecError):
            convert.state_from_numpy(tb.SketchSpec(n_bins=512), convert.state_to_numpy(state))
        with pytest.raises(SpecError):
            tb.BatchedDDSketch(N, n_bins=512, device="cuda")
