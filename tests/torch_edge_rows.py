"""Hand-built sketch rows for the full-window query's edge cases.

Plain numpy, no framework: the same leaves feed the JAX package, the port's
plain version (CPU tests) and the port's CUDA kernel (card tests).  Small
integer counts put ``rank = q * (count - 1)`` on whole numbers for the
quantiles of ``EDGE_QS``, so a running sum lands exactly on a threshold and
the strict ``<`` of the negative store and the ``<=`` of the positive one
decide the bucket.
"""

import numpy as np

EDGE_QS = (0.0, 0.2, 0.25, 0.4, 0.5, 0.6, 0.75, 0.8, 1.0, -0.1, 1.1)

LEAF_NAMES = (
    "bins_pos", "bins_neg", "zero_count", "count", "sum", "min", "max",
    "collapsed_low", "collapsed_high", "key_offset", "pos_lo", "pos_hi",
    "neg_lo", "neg_hi", "neg_total", "tile_sums",
)


def _rows(n_bins):
    """(name, negative bins, zero count, positive bins, count override)."""
    last = n_bins - 1
    full = float((2**24 - 1) // n_bins)  # one store's sums reach 2**24 - n_bins
    half = float(((2**24 - 1) // 2) // n_bins)  # each store's sums reach ~2**23
    return [
        ("empty", {}, 0.0, {}, None),
        ("zero_only", {}, 4.0, {}, None),
        ("neg_only", {0: 1.0, 3: 2.0, 4: 1.0, last: 1.0}, 0.0, {}, None),
        ("pos_only", {}, 0.0, {1: 2.0, 5: 1.0, last: 2.0}, None),
        ("pos_bin0", {}, 0.0, {0: 9.0}, None),
        ("pos_last", {}, 0.0, {last: 9.0}, None),
        ("neg_bin0", {0: 9.0}, 0.0, {}, None),
        ("neg_last", {last: 9.0}, 0.0, {}, None),
        ("count_zero", {2: 3.0}, 1.0, {7: 4.0}, 0.0),
        ("mixed_small", {3: 1.0, 4: 1.0}, 2.0, {0: 1.0, last: 1.0}, None),
        ("ints_2p24_pos", {}, 0.0, np.full(n_bins, full), None),
        ("ints_2p23_mixed", np.full(n_bins, half), 1.0, np.full(n_bins, half), None),
    ]


def edge_names(n_bins=512):
    return [r[0] for r in _rows(n_bins)]


def _store(spec, n_bins):
    out = np.zeros(n_bins, np.float64)
    if isinstance(spec, dict):
        for b, m in spec.items():
            out[b % n_bins] += m
    else:
        out[:] = spec
    return out


def _bounds(bins):
    occ = bins > 0
    iota = np.arange(bins.shape[1])
    lo = np.where(occ, iota, bins.shape[1]).min(1)
    hi = np.where(occ, iota, -1).max(1)
    return lo.astype(np.int32), hi.astype(np.int32)


def edge_leaves(n_bins, n_streams):
    """The sixteen leaves of ``n_streams`` rows at ``n_bins`` (f32 bins, the
    default key offset): stream i is edge row i % len(edge_names())."""
    pos, neg, zero, count = [], [], [], []
    for _, n_spec, z, p_spec, c in _rows(n_bins):
        p, q = _store(p_spec, n_bins), _store(n_spec, n_bins)
        pos.append(p)
        neg.append(q)
        zero.append(z)
        count.append(p.sum() + q.sum() + z if c is None else c)
    f32 = np.float32
    n = n_streams
    pick = np.arange(n) % len(pos)
    pos = np.asarray(pos, f32)[pick]
    neg = np.asarray(neg, f32)[pick]
    t = -(-n_bins // 128)
    pad = t * 128 - n_bins

    def tiles(x):
        return np.pad(x, ((0, 0), (0, pad))).reshape(n, t, 128).sum(-1, dtype=f32)

    pos_lo, pos_hi = _bounds(pos)
    neg_lo, neg_hi = _bounds(neg)
    return {
        "bins_pos": pos,
        "bins_neg": neg,
        "zero_count": np.asarray(zero, f32)[pick],
        "count": np.asarray(count, f32)[pick],
        "sum": np.zeros(n, f32),
        "min": np.full(n, np.inf, f32),
        "max": np.full(n, -np.inf, f32),
        "collapsed_low": np.zeros(n, f32),
        "collapsed_high": np.zeros(n, f32),
        "key_offset": np.full(n, -(n_bins // 2), np.int32),
        "pos_lo": pos_lo,
        "pos_hi": pos_hi,
        "neg_lo": neg_lo,
        "neg_hi": neg_hi,
        "neg_total": neg.sum(1, dtype=f32),
        "tile_sums": np.concatenate([tiles(pos), tiles(neg)], axis=1),
    }
