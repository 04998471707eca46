"""The port's host stores (``sketches_tpu_torch.store``) against
``sketches_tpu.store`` on the same seeded operation sequences.

Tolerance: **exact**.  Both are the same pure-Python code on Python floats,
so every bin list, offset, key range, count, collapse flag and
``key_at_rank`` answer must be equal, not close.
"""

import numpy as np
import pytest

from sketches_tpu import store as js
from sketches_tpu_torch import store as ts

KINDS = {
    "dense": lambda m: m.DenseStore(),
    "dense_chunk_16": lambda m: m.DenseStore(chunk_size=16),
    "collapsing_lowest": lambda m: m.CollapsingLowestDenseStore(64),
    "collapsing_highest": lambda m: m.CollapsingHighestDenseStore(64),
    "collapsing_lowest_tiny": lambda m: m.CollapsingLowestDenseStore(3),
    "collapsing_highest_tiny": lambda m: m.CollapsingHighestDenseStore(3),
}


def _fields(s):
    out = {
        "bins": list(s.bins),
        "count": s.count,
        "offset": s.offset,
        "min_key": s.min_key,
        "max_key": s.max_key,
        "chunk_size": s.chunk_size,
    }
    for extra in ("bin_limit", "is_collapsed"):
        if hasattr(s, extra):
            out[extra] = getattr(s, extra)
    return out


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert _fields(a) == _fields(b)
    assert a.is_empty == b.is_empty
    assert list(a.keys()) == list(b.keys())


def _ops(seed, n=300):
    r = np.random.RandomState(seed)
    spread = r.choice([5, 50, 400])
    centre = int(r.randint(-300, 300))
    keys = (centre + r.randint(-spread, spread + 1, n)).tolist()
    weights = np.round(r.exponential(2.0, n), 3).clip(0.001).tolist()
    return keys, weights


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_add_sequence_and_key_at_rank(kind, seed):
    a, b = KINDS[kind](js), KINDS[kind](ts)
    keys, weights = _ops(seed)
    for k, w in zip(keys, weights):
        a.add(k, w)
        b.add(k, w)
    _assert_same(a, b)
    ranks = np.linspace(0, a.count - 1e-9, 37).tolist() + [0.0, a.count - 1]
    for rank in ranks:
        for lower in (True, False):
            assert a.key_at_rank(rank, lower=lower) == b.key_at_rank(rank, lower=lower)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("other", ["dense", "collapsing_lowest", "collapsing_highest_tiny"])
def test_merge_sequences(kind, other):
    pairs = []
    for mod in (js, ts):
        base, op = KINDS[kind](mod), KINDS[other](mod)
        for i, (k, w) in enumerate(zip(*_ops(11))):
            (base if i % 2 else op).add(k, w)
        empty = KINDS[kind](mod)
        empty.merge(op)  # an empty store merging in
        base.merge(op)
        base.merge(KINDS[other](mod))  # an empty operand is a no-op
        pairs.append((base, empty, base.copy()))
    for a, b in zip(*pairs):
        _assert_same(a, b)


@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_rejects_non_dense_store_alike(kind):
    class Other(ts.Store):
        count = 0.0

        def add(self, key, weight=1.0):
            pass

        def key_at_rank(self, rank, lower=True):
            return 0

        def merge(self, store):
            pass

        def copy(self):
            return self

        @property
        def is_empty(self):
            return True

    with pytest.raises(TypeError):
        KINDS[kind](ts).merge(Other())


def test_chunk_size_constant_matches():
    assert ts.CHUNK_SIZE == js.CHUNK_SIZE == 128
    for lo, hi in [(0, 0), (-5, 200), (10, 137), (-1000, 1000)]:
        assert ts.DenseStore()._get_new_length(lo, hi) == js.DenseStore()._get_new_length(lo, hi)
