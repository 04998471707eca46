"""The port's full-window query (``kernels.fused_quantile``) against the JAX
package's, on the CPU.

The port runs the plain version (a CPU tensor); JAX runs its Pallas kernel
with ``interpret=True``.  Inputs are made from a seed with numpy and carried
across with ``convert``.

Tolerances, with their reasons:

* **rtol 1e-6, NaN positions equal** for unit weights: integer masses scan
  exactly on both sides, so the bucket is the same and only the ``exp`` of
  the decode may differ by an ulp between XLA:CPU and torch.  An ulp of the
  exp's argument is itself a relative error of up to 2**-23 * |argument|,
  so the data keep |log v| below 8 (wider data would need a looser rtol).
* **rtol 1e-5** for weighted data: the running sums are f32 sums taken in
  another order (JAX splits them into three bf16 terms), which can move a
  rank by one bucket only where it sits on a bucket edge to within that.

JAX results are waited for before the port's side runs.  The hand-built
edge rows (``tests/torch_edge_rows.py``) are the ones the card tests hold
the CUDA kernel to.
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
from torch_edge_rows import EDGE_QS, edge_leaves, edge_names
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

QS = [0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0, -0.1, 1.1]
N = 256

REGIMES = {
    "mixed_sign": lambda r, n: r.lognormal(0, 2.0, (n, 256))
    * np.where(r.rand(n, 256) < 0.4, -1.0, 1.0),
    # Ranks that land in the zero bucket.
    "with_zeros": lambda r, n: r.lognormal(0, 1.0, (n, 256)) * (r.rand(n, 256) > 0.45),
    "neg_only": lambda r, n: -r.lognormal(0, 1.0, (n, 256)),
    "wide_pos": lambda r, n: r.lognormal(0, 1.5, (n, 256)),
}


def _states(regime, n_bins, weighted, seed):
    js, ts = jb.SketchSpec(n_bins=n_bins), tb.SketchSpec(n_bins=n_bins)
    r = np.random.RandomState(seed)
    v = REGIMES[regime](r, N).astype(np.float32)
    w = r.uniform(0.25, 3.0, v.shape).astype(np.float32) if weighted else np.ones_like(v)
    w[::9] = 0.0  # empty streams answer NaN
    jst = jb.init(js, N)
    jst = jb.recenter(js, jst, jb.auto_offset(js, jst, jnp.asarray(v), jnp.asarray(w)))
    jst = jax.block_until_ready(jb.add(js, jst, jnp.asarray(v), jnp.asarray(w)))
    tst = convert.state_from_numpy(
        ts, {f: np.asarray(getattr(jst, f)) for f in tb.LEAVES}, device="cpu"
    )
    return js, ts, jst, tst


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("n_bins", [512, 2048])
def test_fused_quantile_matches_jax_interpret(regime, n_bins):
    js, ts, jst, tst = _states(regime, n_bins, False, seed=n_bins % 7)
    ref = np.asarray(jax.block_until_ready(
        jk.fused_quantile(js, jst, jnp.asarray(QS, jnp.float32), interpret=True)
    ))
    got = tk.fused_quantile(ts, tst, QS).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got, tb.quantile(ts, tst, QS).numpy(), rtol=1e-6, equal_nan=True)
    assert np.isnan(got[::9]).all() and np.isnan(got[:, -2:]).all()
    if regime == "neg_only":
        assert (got[1::9, :-2] < 0).all()
    if regime == "with_zeros":
        assert (got[1:9, 1] == 0.0).any()


@pytest.mark.parametrize("regime", ["mixed_sign", "with_zeros"])
def test_fused_quantile_weighted_matches_jax_interpret(regime):
    js, ts, jst, tst = _states(regime, 512, True, seed=4)
    ref = np.asarray(jax.block_until_ready(
        jk.fused_quantile(js, jst, jnp.asarray(QS, jnp.float32), interpret=True)
    ))
    got = tk.fused_quantile(ts, tst, QS).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, equal_nan=True)


def test_fused_quantile_bounds_come_from_the_bins():
    """The occupied bounds are the bins' own, not the state's pos_lo /
    pos_hi: widening the state's bounds changes nothing."""
    js, ts, jst, tst = _states("mixed_sign", 512, False, seed=6)
    want = tk.fused_quantile(ts, tst, QS).numpy()
    loose = tst.map(torch.clone)
    loose.pos_lo.fill_(0)
    loose.pos_hi.fill_(511)
    np.testing.assert_array_equal(tk.fused_quantile(ts, loose, QS).numpy(), want)


def test_fused_quantile_edges():
    ts = tb.SketchSpec(n_bins=512)
    st = tb.init(ts, 128, "cpu")
    assert np.isnan(tk.fused_quantile(ts, st, QS).numpy()).all()
    assert tk.fused_quantile(ts, st, []).shape == (128, 0)
    ints = tb.SketchSpec(n_bins=512, bin_dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tk.fused_quantile(ints, tb.init(ints, 128, "cpu"), QS)


@pytest.mark.parametrize("mapping", ["logarithmic", "linear_interpolated",
                                     "quadratic_interpolated", "cubic_interpolated"])
@pytest.mark.parametrize("n_q", [4, len(EDGE_QS)])
def test_fused_quantile_edge_rows_match_jax_interpret(mapping, n_q):
    """Hand-built rows (empty, zero-only, one-sign, all mass in the first or
    last bin, count 0 over mass, integer sums near 2**24, ranks landing on
    running sums) through JAX's Pallas kernel in interpret mode and the
    port's plain version, on the same numpy leaves."""
    leaves = edge_leaves(512, 128)  # the Pallas kernel takes blocks of 128 streams
    js = jb.SketchSpec(n_bins=512, mapping_name=mapping)
    ts = tb.SketchSpec(n_bins=512, mapping_name=mapping)
    jst = jb.SketchState(**{f: jnp.asarray(leaves[f]) for f in tb.LEAVES})
    tst = convert.state_from_numpy(ts, leaves, device="cpu")
    qs = EDGE_QS[:n_q]
    ref = np.asarray(jax.block_until_ready(
        jk.fused_quantile(js, jst, jnp.asarray(qs, jnp.float32), interpret=True)
    ))
    got = tk.fused_quantile(ts, tst, qs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got, tb.quantile(ts, tst, qs).numpy(), rtol=1e-6, equal_nan=True)
    rows = {name: got[i] for i, name in enumerate(edge_names())}
    valid = [0.0 <= q <= 1.0 for q in qs]
    assert np.isnan(rows["empty"]).all() and np.isnan(rows["count_zero"]).all()
    assert (rows["zero_only"][valid] == 0.0).all()
    assert (rows["neg_only"][valid] < 0.0).all() and (rows["pos_only"][valid] > 0.0).all()
    assert len(set(rows["pos_bin0"][valid])) == 1 and len(set(rows["neg_last"][valid])) == 1
