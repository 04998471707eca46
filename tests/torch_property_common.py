"""Shared strategies and helpers of the port's property-based suites.

``tests/test_torch_property.py`` and ``tests/test_torch_property_stateful.py``
(the port against the JAX package on the CPU) and the card half in
``tests/test_torch_cuda.py`` (each kernel against its plain version) draw
from the same strategies.  Imports no JAX.

Every drawn value list also comes moved to the middle of its bucket
(:func:`mid_bucket`): XLA:CPU's f32 ``log`` is not correctly rounded, so a
value within an ulp of a bucket edge can key one bucket apart in the two
packages (ROADMAP queue C, reference platform differences).  Raw draws
serve only the contracts the JAX tests assert; comparisons with the JAX
package use the moved values.

The settings are steady by construction: ``derandomize=True`` and no
example database, so a run draws the same examples every time.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, settings, strategies as st

ALPHA = 0.02
GAMMA = (1.0 + ALPHA) / (1.0 - ALPHA)
#: The fixed width every device-tier draw is padded to (weights 0 past the
#: drawn values), so each jitted JAX reference compiles once.
WIDTH = 384


def steady(max_examples: int):
    """The suites' settings: derandomized, no database, no deadline."""
    return settings(
        max_examples=max_examples,
        derandomize=True,
        database=None,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large,
                               HealthCheck.function_scoped_fixture],
    )


def mid_bucket(values, dtype=np.float64):
    """Each value moved to the middle of its logarithmic bucket at
    :data:`ALPHA` (zeros stay zero)."""
    v = np.asarray(values, np.float64)
    a = np.abs(v)
    out = np.zeros_like(v)
    nz = a > 0
    k = np.ceil(np.log(a[nz]) / math.log(GAMMA))
    out[nz] = np.sign(v[nz]) * GAMMA ** (k - 0.5)
    return out.astype(dtype)


def with_mid(strategy):
    """``strategy``'s value lists as ``(raw, moved to mid-bucket)`` pairs."""
    return strategy.map(lambda vs: (vs, [float(x) for x in mid_bucket(vs)]))


# Finite, non-degenerate magnitudes: within the mappings' representable
# window and away from f32 subnormals (which classify as zero by design).
VALUES = st.one_of(
    st.floats(min_value=1e-30, max_value=1e30, allow_nan=False, width=64),
    st.floats(min_value=-1e30, max_value=-1e-30, allow_nan=False, width=64),
    st.just(0.0),
    st.integers(min_value=-1000, max_value=1000).map(float),
)
STREAMS = st.lists(VALUES, min_size=1, max_size=300)

# The device tier's static window at ALPHA with 2048 bins spans about
# exp(+-41); magnitudes beyond it collapse into the edge bin by design, so
# oracle parity holds only inside the window.
WINDOW_VALUES = st.one_of(
    st.floats(min_value=1e-15, max_value=1e15, allow_nan=False, width=64),
    st.floats(min_value=-1e15, max_value=-1e-15, allow_nan=False, width=64),
    st.just(0.0),
    st.integers(min_value=-1000, max_value=1000).map(float),
)
WINDOW_STREAMS = st.lists(WINDOW_VALUES, min_size=1, max_size=300)
SEEDS = st.integers(min_value=0, max_value=2**32 - 1)


def exact_quantile(sorted_vals, q):
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


def assert_contract(sketch, values, qs=(0.0, 0.25, 0.5, 0.75, 0.99, 1.0)):
    """Every quantile within ALPHA of the exact lower quantile."""
    s = sorted(values)
    for q in qs:
        exact = exact_quantile(s, q)
        got = sketch.get_quantile_value(q)
        assert got is not None
        assert abs(got - exact) <= ALPHA * abs(exact) + 1e-12, (q, exact, got)


def finite_f32(values):
    """The values as f32, infinities (f64 values past f32's range) dropped."""
    v = np.asarray(values, np.float32)
    return v[np.isfinite(v)]


def padded_block(vals32, n_streams=128, width=WIDTH):
    """One drawn stream as row 0 of an ``[n_streams, width]`` batch with
    unit weights on the drawn values and zero weights elsewhere (inert)."""
    padded = np.zeros((n_streams, width), np.float32)
    padded[0, : len(vals32)] = vals32
    w = np.zeros_like(padded)
    w[0, : len(vals32)] = 1.0
    return padded, w


# ---------------------------------------------------------------------------
# Stateful machines: the ops, the batches and the model
# ---------------------------------------------------------------------------

N_STREAMS = 8
BATCH = 12
N_BINS = 256
QS = (0.0, 0.25, 0.5, 0.9, 1.0)
CROSS_ALPHA_BOUND = 2.5 * ALPHA


def gen_values(seed: int, scale: float) -> np.ndarray:
    """Deterministic mixed batch: positives, negatives, zeros, repeats --
    magnitudes within about 2.6 decades, so a 256-bin window holds them
    without collapse as long as it is sanely centred."""
    rng = np.random.RandomState(seed)
    v = scale * rng.lognormal(0.0, 0.8, (N_STREAMS, BATCH))
    v = np.clip(v, 0.05, 20.0)
    sign = np.where(rng.rand(N_STREAMS, BATCH) < 0.3, -1.0, 1.0)
    return (v * sign * (rng.rand(N_STREAMS, BATCH) > 0.15)).astype(np.float32)


OPS = st.lists(
    st.one_of(
        st.tuples(st.just("add"), st.integers(0, 10_000), st.sampled_from([0.3, 1.0, 3.0])),
        st.tuples(st.just("merge"), st.integers(0, 10_000)),
        st.tuples(st.just("recenter_shift"), st.integers(-20, 20)),
        st.just(("recenter_data",)),
        st.just(("maybe_recenter",)),
        st.just(("checkpoint",)),
    ),
    min_size=1,
    max_size=7,
)

CROSS_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("add"), st.integers(0, 10_000), st.sampled_from([0.3, 1.0, 3.0])),
        st.tuples(st.just("merge_tier"), st.integers(0, 3), st.integers(0, 10_000)),
        st.tuples(st.just("roundtrip"), st.integers(0, 3)),
        st.just(("wire_fault",)),
        st.just(("ckpt_fault",)),
    ),
    min_size=1,
    max_size=7,
)


class Model:
    """Ground truth: raw per-stream value lists."""

    def __init__(self):
        self.values = [[] for _ in range(N_STREAMS)]

    def add(self, batch: np.ndarray) -> None:
        for i in range(N_STREAMS):
            self.values[i].extend(float(x) for x in batch[i])

    def check(self, count, zero_count, bins_mass, quantile_fn, collapsed):
        """Count parity, mass conservation, and the alpha contract unless
        mass collapsed at a window edge."""
        for i in range(N_STREAMS):
            vals = self.values[i]
            assert count[i] == pytest.approx(len(vals)), i
            # Binned + zero == count, exactly (integer unit masses).
            assert bins_mass[i] + zero_count[i] == pytest.approx(len(vals)), i
        if collapsed.sum() > 0:
            return  # resolution legitimately lost at a window edge
        got = np.asarray(quantile_fn(list(QS)))
        for i in range(N_STREAMS):
            vals = sorted(self.values[i])
            if not vals:
                assert np.isnan(got[i]).all()
                continue
            for j, q in enumerate(QS):
                exact = vals[int(q * (len(vals) - 1))]
                assert abs(got[i, j] - exact) <= ALPHA * abs(exact) + 1e-9, (i, q, exact, got[i, j])


def state_arrays(state) -> dict:
    """A state's leaves as numpy arrays (either package's)."""
    out = {}
    for f in ("bins_pos", "bins_neg", "zero_count", "count", "sum", "min", "max",
              "collapsed_low", "collapsed_high", "key_offset", "pos_lo", "pos_hi", "neg_lo",
              "neg_hi", "neg_total", "tile_sums"):
        x = getattr(state, f)
        out[f] = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def model_check(model, state, quantile_fn):
    """:meth:`Model.check` on a state of either package."""
    a = state_arrays(state)
    model.check(
        a["count"].astype(np.float64),
        a["zero_count"].astype(np.float64),
        (a["bins_pos"].sum(-1) + a["bins_neg"].sum(-1)).astype(np.float64),
        quantile_fn,
        (a["collapsed_low"] + a["collapsed_high"]).astype(np.float64),
    )


#: Leaves that must agree bit for bit across packages (all but ``sum``).
EXACT_LEAVES = ("bins_pos", "bins_neg", "zero_count", "count", "min", "max", "collapsed_low",
                "collapsed_high", "key_offset", "pos_lo", "pos_hi", "neg_lo", "neg_hi",
                "neg_total", "tile_sums")


def assert_same_state(port, ref, scale):
    """Two states (either package's) equal: every leaf but ``sum`` bit for
    bit, ``sum`` NaN-aware within ``1e-5 * scale`` (f32 sums in another
    order)."""
    a, b = state_arrays(port), state_arrays(ref)
    for f in EXACT_LEAVES:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["sum"], b["sum"], rtol=0, atol=1e-5 * scale + 1e-30,
                               equal_nan=True, err_msg="sum")
