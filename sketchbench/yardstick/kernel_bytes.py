"""Bytes that the kernels' inputs need, each input byte read once and each
output byte written once (the chip smoke's counts, frozen here).

* K1, ``csrc/ingest.cu``: the values, the weights when weighted and the
  window offsets read; two ``[n, n_bins]`` histograms and the column block
  (16 scalar columns and the tile masses, to a multiple of 8) written.
* K3, ``csrc/windowed.cu``: the occupied window of each store it reads,
  the per-stream operand (2 Q ranks and 5 bounds) and the answers.
* K5, ``csrc/overlap.cu``: one 128-bin tile for each distinct crossing
  tile of a stream's ranks, the per-stream operand (4 Q entries and 5
  bounds) and the answers.
"""

from __future__ import annotations

import torch

TILE = 128
F32 = 4


def k1_bytes(n: int, width: int, n_bins: int, weighted: bool) -> float:
    n_tiles = -(-n_bins // TILE)
    ncols = 16 + ((2 * n_tiles + 7) // 8) * 8
    read = n * width * F32 * (2 if weighted else 1) + n * 4
    return float(read + 2 * n * n_bins * F32 + n * ncols * F32)


def plan_window(n_bins: int, lo: int, hi: int) -> int:
    """Tiles the windowed query reads a store: the block width of 4, 2 or
    1 tiles that reads fewest, over the occupied span [lo, hi]."""
    total = n_bins // TILE
    if hi < 0:
        return 1
    lo_t, hi_t = max(0, min(lo, hi)) // TILE, min(hi // TILE, total - 1)
    best = None
    for w in (4, 2, 1):
        if total % w:
            continue
        tiles = (hi_t // w - lo_t // w + 1) * w
        if best is None or tiles < best:
            best = tiles
    return best


def k3_bytes(state, n_bins: int, q: int) -> float:
    n = state.count.shape[0]
    lo = int(torch.minimum(state.pos_lo, state.neg_lo).amin())
    hi = int(torch.maximum(state.pos_hi, state.neg_hi).amax())
    stores = 2 if bool((state.neg_total > 0).any()) else 1
    return float(F32 * (stores * n * plan_window(n_bins, lo, hi) * TILE + n * (2 * q + 5) + n * q))


def crossing_tiles(state, qs) -> int:
    """Distinct (stream, store tile) pairs holding the rank of some live
    quantile: the tiles the answers need."""
    t = state.tile_sums.shape[1] // 2
    tiles = state.tile_sums.to(torch.float64)
    count = state.count.to(torch.float64)[:, None]
    zero = state.zero_count.to(torch.float64)[:, None]
    neg = state.neg_total.to(torch.float64)[:, None]
    q = torch.tensor(qs, dtype=torch.float64, device=tiles.device)[None, :]
    rank = q * (count - 1.0)
    cum_pos = torch.cumsum(tiles[:, :t], dim=-1)
    cum_neg = torch.cumsum(tiles[:, t:], dim=-1)
    g_pos = torch.searchsorted(cum_pos.contiguous(), (rank - zero - neg).contiguous(), right=True)
    g_neg = torch.searchsorted(cum_neg.contiguous(), (neg - rank).contiguous(), right=False)
    in_neg = rank < neg
    in_zero = ~in_neg & (rank < neg + zero)
    tile = torch.where(in_neg, t + torch.clamp(g_neg, max=t - 1), torch.clamp(g_pos, max=t - 1))
    tile = torch.where(in_zero | (count <= 0), -1, tile)
    tile = torch.sort(tile, dim=-1).values
    fresh = torch.ones_like(tile, dtype=torch.bool)
    fresh[:, 1:] = tile[:, 1:] != tile[:, :-1]
    return int((fresh & (tile >= 0)).sum())


def k5_bytes(state, qs) -> float:
    n, q = state.count.shape[0], len(qs)
    return float(F32 * (crossing_tiles(state, qs) * TILE + n * (4 * q + 5) + n * q))
