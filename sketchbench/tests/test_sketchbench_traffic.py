"""The generators: the ragged flush's live share, the gauges' one tile,
and the same inputs from the same seed."""

import json
from pathlib import Path

import pytest
import torch

from sketchbench import gen
from sketchbench.gen import ragged_zipf
from sketchbench.reference import ddsketch_ref as ref

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"


def traffic(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def test_ragged_live_share_is_half_at_full_size():
    p = traffic("latency_ragged")["flush"]
    n = 1 << 20
    counts = ragged_zipf.counts_by_rank(p, n, "cpu")
    assert int(counts.sum()) == n * p["width"] // 2
    assert int(counts.min()) >= 1 and int(counts.max()) == p["width"]
    assert bool((counts[:-1] >= counts[1:]).all())  # heavier ranks, more slots


def test_ragged_seeds_permute_one_set_of_counts():
    p = traffic("latency_ragged")["flush"]
    a, ra = ragged_zipf.live_counts(p, 4096, gen.generator(1, "flush", "cpu"))
    b, rb = ragged_zipf.live_counts(p, 4096, gen.generator(2, "flush", "cpu"))
    assert torch.equal(torch.sort(a).values, torch.sort(b).values)
    assert not torch.equal(a, b)
    assert abs(float(a.sum()) / (4096 * p["width"]) - 0.5) < 1e-3


@pytest.mark.parametrize("mapping", ["cubic_interpolated", "logarithmic"])
@pytest.mark.parametrize("name", ["gauge_dash", "gauge_dense"])
def test_narrow_gauges_stay_in_one_tile(name, mapping):
    """After the median rule centres each stream on its first batch, every
    value of every pool batch keys into the tile around bin 960."""
    t = traffic(name)
    n, n_bins = 4096, 2048
    inputs = gen.build(t, 11, n, "cpu")
    m = ref.Mapping(mapping, 0.01)
    first = ref.key_batch(m, inputs.batch(0), inputs.weights)
    off_lo, off_hi = ref.offset_interval(first, n_bins)
    for k in range(inputs.pool_size):
        kb = ref.key_batch(m, inputs.batch(k), inputs.weights)
        assert int((kb.k_lo - off_hi[:, None]).min()) >= 896
        assert int((kb.k_hi - off_lo[:, None]).max()) <= 1023


def test_same_seed_same_inputs():
    t = traffic("latency_ragged")
    a, b = gen.build(t, 2 ** 33 + 5, 512, "cpu"), gen.build(t, 2 ** 33 + 5, 512, "cpu")
    c = gen.build(t, 2 ** 33 + 6, 512, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.batches, b.batches))
    assert torch.equal(a.weights, b.weights)
    assert not torch.equal(a.batches[0], c.batches[0])
    rows = torch.tensor([0, 7, 300])
    v, w = a.rows_of_batch(2, rows)
    assert torch.equal(v, a.batches[2][rows]) and torch.equal(w, a.weights[rows])
    # Padding is zero and weighs nothing.
    pad = a.weights == 0
    assert bool((a.batches[0][pad] == 0).all()) and bool(pad.any())


def test_sampled_rows_hold_the_heaviest():
    inputs = gen.build(traffic("latency_ragged"), 3, 2048, "cpu")
    rows = gen.sample_rows(inputs, 256, 16)
    assert rows.numel() == 256 and torch.equal(rows, torch.unique(rows))
    heaviest = set(torch.argsort(inputs.ranks)[:16].tolist())
    assert heaviest <= set(rows.tolist())
