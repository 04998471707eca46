"""The port's overlap query engine against the JAX package's, on the CPU.

``fused_quantile_tiles_overlap`` runs its plain version here (a CPU tensor);
the JAX side runs its Pallas kernel with ``interpret=True``.  Both take the
same state, made from a seed with numpy and carried across with
``convert``.

Tolerances, with their reasons:

* **Exact** for the per-block needed-tile lists and the packed operand
  (integer masses, identical plans), and between the port's overlap and
  tile engines (the same tiles, scans and decode).
* **rtol 1e-6, NaN positions equal** against JAX: the same bucket, whose
  decoded value may differ by an ulp of ``exp`` between XLA:CPU and torch.

JAX results are waited for before the port's side runs.
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

QS = [0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -0.1]


def _values(regime, n, seed):
    r = np.random.RandomState(seed)
    if regime == "positive":
        v = r.lognormal(0, 2, (n, 256))
    elif regime == "mixed":
        v = r.lognormal(0, 2, (n, 256)) * np.where(r.rand(n, 256) < 0.4, -1, 1)
    else:
        # "pads": the first half of the streams is tight (one tile per
        # store), the rest wide and mixed, so some blocks need fewer tiles
        # than k_tiles and their lists end in repeated pad entries.
        v = r.lognormal(0, 2, (n, 256)) * np.where(r.rand(n, 256) < 0.4, -1, 1)
        v[: n // 2] = r.lognormal(0, 0.02, (n // 2, 256))
    return v.astype(np.float32)


def _states(regime, n, seed, empty_every=7):
    js, ts = jb.SketchSpec(n_bins=512), tb.SketchSpec(n_bins=512)
    v = _values(regime, n, seed)
    w = np.ones_like(v)
    w[::empty_every] = 0.0  # empty streams answer NaN
    jst = jb.init(js, n)
    jst = jb.recenter(js, jst, jb.auto_offset(js, jst, jnp.asarray(v), jnp.asarray(w)))
    jst = jax.block_until_ready(jb.add(js, jst, jnp.asarray(v), jnp.asarray(w)))
    tst = convert.state_from_numpy(
        ts, {f: np.asarray(getattr(jst, f)) for f in tb.LEAVES}, device="cpu"
    )
    return js, ts, jst, tst


# (regime, streams, lookahead, block_streams, k_tiles, with_neg); None
# takes the plan's value.
CASES = [
    ("positive", 512, 8, 0, None, None),
    ("positive", 256, 1, 128, None, True),
    ("mixed", 512, 2, 128, None, None),
    ("mixed", 256, 8, 0, 4, None),
    ("pads", 512, 8, 128, None, None),
    ("pads", 1024, 8, 256, None, False),
]


@pytest.mark.parametrize("regime,n,lookahead,block_streams,k_fixed,wn_fixed", CASES)
def test_overlap_matches_jax_interpret(regime, n, lookahead, block_streams, k_fixed, wn_fixed):
    js, ts, jst, tst = _states(regime, n, seed=n + lookahead)
    bn = block_streams or tk._stream_block(n)
    k_plan, with_neg = tk.plan_tile_query(ts, tst, QS, bn=bn)
    assert (k_plan, with_neg) == jk.plan_tile_query(js, jst, jnp.asarray(QS), bn=bn)
    k_tiles = k_fixed or k_plan
    wn = with_neg if wn_fixed is None else wn_fixed
    ref = np.asarray(jax.block_until_ready(jk.fused_quantile_tiles_overlap(
        js, jst, jnp.asarray(QS), k_tiles=k_tiles, with_neg=wn,
        block_streams=block_streams, lookahead=lookahead, interpret=True,
    )))
    got = tk.fused_quantile_tiles_overlap(
        ts, tst, QS, k_tiles=k_tiles, with_neg=wn, block_streams=block_streams,
        lookahead=lookahead,
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    tiles = tk.fused_quantile_tiles(ts, tst, QS, k_tiles=k_tiles, with_neg=wn).numpy()
    np.testing.assert_array_equal(got, tiles)
    assert np.isnan(got[::7]).all() and np.isnan(got[:, -1]).all()


@pytest.mark.parametrize("bn", [128, 256])
def test_tile_query_operands_match_jax(bn):
    js, ts, jst, tst = _states("pads", 512, seed=3)
    k_tiles, _ = tk.plan_tile_query(ts, tst, QS, bn=bn)
    for k in (k_tiles, ts.n_tiles):
        got = tk._tile_query_operands(ts, tst, torch.tensor(QS), bn, k)
        ref = jk._tile_query_operands(js, jst, jnp.asarray(QS), bn, k)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    lists_pos = got[0].numpy()
    # Blocks of the tight half need one tile: their lists are padded by
    # repeating it.
    assert (lists_pos[0] == lists_pos[0, 0]).all()


def test_short_lists_fold_zero_tiles_like_jax():
    """k_tiles below a block's needed-tile union: unlisted ranks fold a
    zero tile on both sides (the kernel's contract, not the tile
    engine's)."""
    js, ts, jst, tst = _states("mixed", 256, seed=11)
    ref = np.asarray(jax.block_until_ready(jk.fused_quantile_tiles_overlap(
        js, jst, jnp.asarray(QS), k_tiles=1, lookahead=2, interpret=True
    )))
    got = tk.fused_quantile_tiles_overlap(ts, tst, QS, k_tiles=1, lookahead=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("n_steps,requested", [(4, 8), (8, 8), (16, 8), (6, 8), (8, 3), (2, 1)])
def test_overlap_depth_matches_jax(n_steps, requested):
    assert tk._overlap_depth(n_steps, requested) == jk._overlap_depth(n_steps, requested)


def test_overlap_validates_like_jax():
    _, ts, _, tst = _states("mixed", 256, seed=5)
    with pytest.raises(SpecError):
        tk.fused_quantile_tiles_overlap(ts, tst, QS, k_tiles=ts.n_tiles + 1)
    with pytest.raises(SpecError):
        tk.fused_quantile_tiles_overlap(ts, tst, QS, k_tiles=2, lookahead=0)
    with pytest.raises(SketchValueError):
        tk.fused_quantile_tiles_overlap(ts, tst, QS, k_tiles=2, block_streams=96)
    assert tk.fused_quantile_tiles_overlap(ts, tst, [], k_tiles=2).shape == (256, 0)
    ints = tb.SketchSpec(n_bins=512, bin_dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tk.fused_quantile_tiles_overlap(ints, tb.init(ints, 128, "cpu"), QS, k_tiles=1)


@pytest.mark.parametrize("value,on", [(None, True), ("1", True), ("", True), ("0", False),
                                      ("off", True)])
def test_overlap_switch_reads_like_jax(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv(tk.OVERLAP_ENV, raising=False)
    else:
        monkeypatch.setenv(tk.OVERLAP_ENV, value)
    assert tk.OVERLAP_ENV == jk.OVERLAP_ENV
    assert tk.overlap_enabled() is jk.overlap_enabled() is on
