"""Property-based differential tests (hypothesis): the port on arbitrary streams.

The port's counterparts of ``tests/test_property.py``.  Each test makes two
kinds of assertion on every draw:

(a) the JAX test's own contract, with its tolerance unchanged, applied to
    the port on the raw draw: the alpha contract on arbitrary streams,
    merge equals concatenation, the port's engines against the pure-Python
    ``DDSketch`` oracle, and the windowed and tile-list queries against the
    port's full-window query (its XLA-tier counterpart) and ``wxla``;
(b) the JAX package on the same draw moved to the middle of each value's
    bucket (``torch_property_common.mid_bucket``): host sketches equal
    exactly (both are pure Python over f64); device states bit-equal on
    every leaf but ``sum`` (NaN-aware within 1e-5 of the sum of |v|);
    answers within rtol 1e-6 of the JAX package's eager ``quantile`` (the
    same bucket; an ulp of ``exp`` apart at most; eager, so no fused
    multiply-add moves an integral rank, ROADMAP queue C).

The JAX file's ``max_examples`` (50, 50, 25, 25, 25).  Settings differ
from it only where a steady tier-1 count asks: ``derandomize=True`` and no
database (the same examples every run), and device-tier draws padded to
one fixed width with zero weights (each JAX reference compiles once).
Torch runs on one intra-op thread here (``one_torch_thread``).
"""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given

import jax.numpy as jnp
import torch

from sketches_tpu import DDSketch as JDDSketch
from sketches_tpu import batched as jb
from sketches_tpu_torch import DDSketch, kernels
from sketches_tpu_torch import batched as tb
from torch_property_common import (
    ALPHA,
    SEEDS,
    STREAMS,
    WINDOW_STREAMS,
    assert_contract,
    assert_same_state,
    finite_f32,
    padded_block,
    steady,
    with_mid,
)
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

QS5 = (0.0, 0.25, 0.5, 0.9, 1.0)
pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")


def _host_equal(port, ref):
    """Two host sketches fed the same values answer alike, exactly."""
    assert port.count == ref.count
    for q in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert port.get_quantile_value(q) == ref.get_quantile_value(q), q


@steady(50)
@given(with_mid(STREAMS))
def test_accuracy_contract_any_stream(pair):
    raw, mid = pair
    sk = DDSketch(ALPHA)
    for v in raw:
        sk.add(v)
    assert_contract(sk, raw)
    assert sk.num_values == pytest.approx(len(raw))
    assert np.isfinite(sk.sum)
    port, ref = DDSketch(ALPHA), JDDSketch(ALPHA)
    for v in mid:
        port.add(v)
        ref.add(v)
    _host_equal(port, ref)
    assert port.sum == ref.sum


@steady(50)
@given(with_mid(STREAMS), SEEDS)
def test_merge_equals_concatenation(pair, seed):
    raw, mid = pair
    parts = np.random.RandomState(seed).randint(0, 3, size=len(raw))
    for values, cls in ((raw, None), (mid, JDDSketch)):
        sketches = [DDSketch(ALPHA) for _ in range(3)]
        for part, v in zip(parts, values):
            sketches[part].add(v)
        merged = sketches[0]
        merged.merge(sketches[1])
        merged.merge(sketches[2])
        assert_contract(merged, values)
        assert merged.num_values == pytest.approx(len(values))
        if cls is not None:
            refs = [cls(ALPHA) for _ in range(3)]
            for part, v in zip(parts, values):
                refs[part].add(v)
            refs[0].merge(refs[1])
            refs[0].merge(refs[2])
            _host_equal(merged, refs[0])


def _jax_block(spec_kw, vals32):
    padded, w = padded_block(vals32)
    spec = jb.SketchSpec(**spec_kw)
    return spec, jb.add(spec, jb.init(spec, 128), jnp.asarray(padded), jnp.asarray(w))


def _port_block(spec_kw, vals32):
    padded, w = padded_block(vals32)
    spec = tb.SketchSpec(**spec_kw)
    # The fused ingest's route (its plain version on the CPU).
    state = kernels.add(spec, tb.init(spec, 128, "cpu"), torch.from_numpy(padded),
                        torch.from_numpy(w))
    return spec, state


@steady(25)
@given(with_mid(WINDOW_STREAMS))
def test_torch_engine_matches_python_oracle(pair):
    raw, mid = pair
    vals32 = finite_f32(raw)
    if len(vals32) == 0:
        return
    # (a) Both engines -- the plain batched add and the fused ingest's
    # route -- against the pure-Python oracle through the f32 lens (the
    # device classifies f32-subnormal values as zero by design).
    spec = tb.SketchSpec(relative_accuracy=ALPHA, n_bins=2048)
    plain = tb.add(spec, tb.init(spec, 1, "cpu"), torch.from_numpy(vals32[None, :]))
    _, fused = _port_block(dict(relative_accuracy=ALPHA, n_bins=2048), vals32)
    py = DDSketch(ALPHA)
    tiny = float(np.finfo(np.float32).tiny)
    for v in vals32:
        py.add(0.0 if abs(float(v)) < tiny else float(v))
    gamma = (1.0 + ALPHA) / (1.0 - ALPHA)
    for q in QS5:
        ora = py.get_quantile_value(q)
        # f32 against f64 key arithmetic may land one bucket apart on each
        # side: adjacent bucket representatives differ by a factor of gamma.
        tol = (gamma**2 - 1.0) * abs(ora) + 1e-12
        for state in (plain, fused):
            dev = float(tb.get_quantile_value(spec, state, q)[0])
            assert abs(dev - ora) <= tol, (q, dev, ora)
    # (b) The JAX engine on the mid-bucket draw.
    mid32 = finite_f32(mid)
    kw = dict(relative_accuracy=ALPHA, n_bins=2048)
    jspec, jstate = _jax_block(kw, mid32)
    tspec, tstate = _port_block(kw, mid32)
    assert_same_state(tstate, jstate, float(np.abs(mid32).sum()))
    ref = np.asarray(jb.quantile(jspec, jstate, jnp.asarray(QS5, jnp.float32)))
    got = tb.quantile(tspec, tstate, list(QS5)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)


def _drifted(spec, state, recenter, seed):
    """Half the draws move the window (the JAX test's drifted position)."""
    rng = np.random.RandomState(seed)
    if rng.rand() < 0.5:
        return recenter(spec, state, state.key_offset + int(rng.randint(-200, 200)))
    return state


def _pair_states(mid32, seed):
    """The mid-bucket draw in both packages, drifted alike."""
    kw = dict(relative_accuracy=ALPHA, n_bins=512)
    jspec, jstate = _jax_block(kw, mid32)
    tspec, tstate = _port_block(kw, mid32)
    return (jspec, _drifted(jspec, jstate, jb.recenter, seed),
            tspec, _drifted(tspec, tstate, tb.recenter, seed))


def _query_parity(mid, seed, port_query):
    """(b): the port's query of the mid-bucket draw against the JAX
    package's eager full-window query of its own state."""
    mid32 = finite_f32(mid)
    jspec, jstate, tspec, tstate = _pair_states(mid32, seed)
    assert_same_state(tstate, jstate, float(np.abs(mid32).sum()))
    ref = np.asarray(jb.quantile(jspec, jstate, jnp.asarray(QS5, jnp.float32)))
    np.testing.assert_allclose(port_query(tspec, tstate), ref, rtol=1e-6, equal_nan=True)


def _windowed(spec, state):
    lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, state)
    return kernels.fused_quantile_windowed(
        spec, state, list(QS5), lo_w, n_wblocks=n_w, w_tiles=w_t, with_neg=with_neg
    ).numpy()


def _wxla(spec, state):
    lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, state)
    return kernels.quantile_windowed_xla(
        spec, state, list(QS5), lo_w * w_t, n_tiles_window=n_w * w_t, with_neg=with_neg
    ).numpy()


def _tiles(spec, state):
    k_tiles, with_neg = kernels.plan_tile_query(spec, state, list(QS5))
    return kernels.fused_quantile_tiles(
        spec, state, list(QS5), k_tiles=k_tiles, with_neg=with_neg).numpy()


def _overlap(spec, state):
    k_tiles, with_neg = kernels.plan_tile_query(spec, state, list(QS5))
    return kernels.fused_quantile_tiles_overlap(
        spec, state, list(QS5), k_tiles=k_tiles, with_neg=with_neg).numpy()


@steady(25)
@given(with_mid(WINDOW_STREAMS), SEEDS)
def test_windowed_query_matches_xla(pair, seed):
    """The occupancy-windowed query (K3's route) and ``wxla`` agree with
    the full-window query on adversarial streams, drifted windows and the
    positive-only store skip included."""
    raw, mid = pair
    vals32 = finite_f32(raw)
    if len(vals32) == 0:
        return
    spec, state = _port_block(dict(relative_accuracy=ALPHA, n_bins=512), vals32)
    state = _drifted(spec, state, tb.recenter, seed)
    ref = tb.quantile(spec, state, list(QS5)).numpy()
    np.testing.assert_allclose(_windowed(spec, state), ref, rtol=1e-5, equal_nan=True)
    np.testing.assert_allclose(_wxla(spec, state), ref, rtol=1e-5, equal_nan=True)
    _query_parity(mid, seed, _windowed)


@steady(25)
@given(with_mid(WINDOW_STREAMS), SEEDS)
def test_tile_list_query_matches_xla(pair, seed):
    """The tile-list query (K4's route) and its copy-ring walk (K5's)
    agree with the full-window query on adversarial streams: drifted
    windows, sparse and edge occupancy, empty padding streams."""
    raw, mid = pair
    vals32 = finite_f32(raw)
    if len(vals32) == 0:
        return
    spec, state = _port_block(dict(relative_accuracy=ALPHA, n_bins=512), vals32)
    state = _drifted(spec, state, tb.recenter, seed)
    ref = tb.quantile(spec, state, list(QS5)).numpy()
    np.testing.assert_allclose(_tiles(spec, state), ref, rtol=1e-5, equal_nan=True)
    np.testing.assert_allclose(_overlap(spec, state), ref, rtol=1e-5, equal_nan=True)
    _query_parity(mid, seed, _tiles)
