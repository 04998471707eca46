"""The plain reference against sketches-py's published formulas, written
out here as scalar Python (``ddsketch/mapping.py``, ``ddsketch.py``)."""

import math

import numpy as np
import pytest
import torch

from sketchbench.reference import ddsketch_ref as ref

A, B, C = 6.0 / 35.0, -3.0 / 5.0, 10.0 / 7.0


def upstream(name, alpha):
    """(key, value) of sketches-py's mapping ``name`` at ``alpha``."""
    gm = 2.0 * alpha / (1.0 - alpha)
    gamma = 1.0 + gm
    mult = 1.0 / math.log1p(gm)
    if name == "cubic_interpolated":
        mult /= C

    def log_gamma(v):
        if name == "logarithmic":
            return math.log(v) * mult
        m, e = math.frexp(v)
        s = 2 * m - 1
        return (((A * s + B) * s + C) * s + (e - 1)) * mult

    def pow_gamma(x):
        x = x / mult
        if name == "logarithmic":
            return math.exp(x)
        e = math.floor(x)
        d0 = B * B - 3 * A * C
        d1 = 2 * B ** 3 - 9 * A * B * C - 27 * A * A * (x - e)
        card = float(np.cbrt((d1 - math.sqrt(d1 * d1 - 4 * d0 ** 3)) / 2))
        plus_one = -(B + card + d0 / card) / (3 * A) + 1
        return math.ldexp(plus_one / 2, e + 1)

    def key(v):
        return int(math.ceil(log_gamma(v)))

    def value(k):
        return pow_gamma(k) * (2.0 / (1.0 + gamma))

    return key, value, log_gamma


MAPPINGS = ("logarithmic", "cubic_interpolated")


@pytest.mark.parametrize("name", MAPPINGS)
def test_keys_match_upstream(name):
    key, _, log_gamma = upstream(name, 0.01)
    rng = np.random.RandomState(0)
    v = np.exp(rng.uniform(-30, 30, 20000)).astype(np.float32)
    kb = ref.key_batch(ref.Mapping(name, 0.01), torch.from_numpy(v)[None, :], None)
    exact = np.array([key(float(x)) for x in v])
    sure = (kb.k_lo == kb.k_hi)[0].numpy()
    assert sure.mean() > 0.99
    assert (kb.k_lo[0].numpy()[sure] == exact[sure]).all()
    # An ambiguous value's two candidates straddle upstream's key.
    lo, hi = kb.k_lo[0].numpy(), kb.k_hi[0].numpy()
    assert ((lo <= exact) & (exact <= hi) & (hi - lo <= 1)).all()


@pytest.mark.parametrize("name", MAPPINGS)
def test_values_match_upstream(name):
    _, value, log_gamma = upstream(name, 0.01)
    m = ref.Mapping(name, 0.01)
    keys = torch.arange(-1500, 1500, 7, dtype=torch.int64)
    got = m.value(keys).numpy()
    want = np.array([value(int(k)) for k in keys])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # A representative decodes back to its key.
    np.testing.assert_allclose(m.key_of_value(torch.from_numpy(want)).numpy(),
                               keys.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", MAPPINGS)
def test_relative_accuracy_holds(name):
    """Upstream's guarantee for its own mapping: value(key(v)) is within
    alpha of v."""
    key, value, _ = upstream(name, 0.01)
    for v in np.exp(np.linspace(-20, 20, 997)):
        assert abs(value(key(v)) - v) <= 0.01 * v * (1 + 1e-9)


def upstream_quantile(name, values, q):
    """``DDSketch.get_quantile_value`` over positive values (dense store)."""
    key, value, _ = upstream(name, 0.01)
    counts = {}
    for v in values:
        counts[key(float(v))] = counts.get(key(float(v)), 0) + 1
    rank = q * (len(values) - 1)
    running = 0.0
    for k in sorted(counts):
        running += counts[k]
        if running > rank:
            return value(k)
    raise AssertionError("rank beyond the count")


@pytest.mark.parametrize("name", MAPPINGS)
def test_answer_interval_holds_upstream_answer(name):
    rng = np.random.RandomState(1)
    n_bins, width = 2048, 300
    v = np.exp(rng.normal(2.0, 2.0, (6, width))).astype(np.float32)
    m = ref.Mapping(name, 0.01)
    kb = ref.key_batch(m, torch.from_numpy(v), None)
    lo, _ = ref.offset_interval(kb, n_bins)
    st = ref.batch_state(kb, lo, n_bins)
    qs = (0.0, 0.5, 0.9, 0.99, 1.0)
    up = torch.tensor([[upstream_quantile(name, row, q) for q in qs] for row in v])
    assert ref.answer_ok(m, st, qs, up).all()
    # The next bucket up is a wrong answer.
    assert not ref.answer_ok(m, st, qs, up * m.gamma).any()
    exact = np.quantile(v.astype(np.float64), qs, axis=1, method="lower").T
    assert (np.abs(up.numpy() - exact) <= 0.01 * exact * (1 + 1e-9)).all()


def test_median_rule_centres_the_window():
    m = ref.Mapping("logarithmic", 0.01)
    v = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0], [7.0, 7.0, 7.0, 0.0, 0.0]])
    w = torch.tensor([[1.0] * 5, [1.0, 1.0, 1.0, 0.0, 0.0]])
    kb = ref.key_batch(m, v, w)
    lo, hi = ref.offset_interval(kb, 2048)
    key, _, _ = upstream("logarithmic", 0.01)
    assert lo.tolist() == [key(3.0) - 960, key(7.0) - 960] == hi.tolist()


def test_leaves_interval_rejects_moved_mass():
    m = ref.Mapping("logarithmic", 0.01)
    rng = np.random.RandomState(2)
    v = torch.from_numpy(np.exp(rng.normal(0, 1, (4, 64))).astype(np.float32))
    kb = ref.key_batch(m, v, None)
    off, _ = ref.offset_interval(kb, 512)
    st = ref.batch_state(kb, off, 512)
    st.offset_lo, st.offset_hi = off, off
    idx = torch.clamp(kb.k_lo - off[:, None], 0, 511)
    bins = torch.zeros(4, 512).scatter_add_(1, idx, torch.ones(4, 64))
    prog = {
        "bins_pos": bins, "bins_neg": torch.zeros(4, 512),
        "tile_sums": torch.cat([bins.reshape(4, 4, 128).sum(-1), torch.zeros(4, 4)], 1),
        "key_offset": off, "count": torch.full((4,), 64.0), "zero_count": torch.zeros(4),
        "neg_total": torch.zeros(4), "min": v.amin(-1), "max": v.amax(-1),
        "collapsed_low": torch.zeros(4), "collapsed_high": torch.zeros(4),
        "pos_lo": idx.amin(-1), "pos_hi": idx.amax(-1),
        "neg_lo": torch.full((4,), 512), "neg_hi": torch.full((4,), -1),
    }
    assert all(bool(ok.all()) for ok in ref.leaves_ok(st, prog, 512).values())
    moved = dict(prog, bins_pos=torch.roll(bins, 1, dims=1))
    assert not ref.leaves_ok(st, moved, 512)["bins_pos"].any()
