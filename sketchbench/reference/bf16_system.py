"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the float32 state the configurations state.

It keeps the program's state leaves (bins, counters, bounds, tile sums)
in bfloat16, keys values in bfloat16 arithmetic and answers quantiles
from bfloat16 running sums.  The check must find it wrong.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from sketchbench.reference.ddsketch_ref import TILE, Mapping, key_batch, offset_interval

DT = torch.bfloat16
CHUNK = 1 << 15  # streams a pass, to bound temporaries


class Bf16System:
    name = "control"

    def __init__(self, config: dict, n_streams: int, device):
        self.mapping = Mapping(config["mapping"], config["relative_accuracy"])
        self.n_bins = b = int(config["bin_limit"])
        n = n_streams
        dev = torch.device(device)

        def zeros(*shape, dtype=DT):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.st = {
            "bins_pos": zeros(n, b), "bins_neg": zeros(n, b), "zero_count": zeros(n),
            "count": zeros(n), "sum": zeros(n), "neg_total": zeros(n),
            "min": torch.full((n,), math.inf, dtype=DT, device=dev),
            "max": torch.full((n,), -math.inf, dtype=DT, device=dev),
            "collapsed_low": zeros(n), "collapsed_high": zeros(n),
            "key_offset": torch.full((n,), -(b // 2), dtype=torch.int64, device=dev),
            "pos_lo": torch.full((n,), b, dtype=torch.int64, device=dev),
            "pos_hi": torch.full((n,), -1, dtype=torch.int64, device=dev),
            "neg_lo": torch.full((n,), b, dtype=torch.int64, device=dev),
            "neg_hi": torch.full((n,), -1, dtype=torch.int64, device=dev),
            "tile_sums": zeros(n, 2 * (b // TILE)),
        }
        self.first = True

    def add(self, values: torch.Tensor, weights=None) -> None:
        n = values.shape[0]
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            w = None if weights is None else weights[lo:hi]
            self._add_rows(slice(lo, hi), values[lo:hi], w)
        self.first = False

    def _add_rows(self, rows: slice, values, weights) -> None:
        s, b = self.st, self.n_bins
        kb = key_batch(self.mapping, values, weights, dtype=DT, delta=0.0)
        if self.first:
            s["key_offset"][rows] = offset_interval(kb, b)[0]
        off = s["key_offset"][rows][:, None]
        k = kb.k_lo - off
        idx = torch.clamp(k, 0, b - 1)
        w = torch.where(kb.live, kb.weights, torch.zeros_like(kb.weights))
        w_pos = torch.where(kb.is_pos, w, torch.zeros_like(w))
        w_neg = torch.where(kb.is_neg, w, torch.zeros_like(w))
        s["bins_pos"][rows] = s["bins_pos"][rows].scatter_add(1, idx, w_pos)
        s["bins_neg"][rows] = s["bins_neg"][rows].scatter_add(1, idx, w_neg)
        t = b // TILE
        tile = idx // TILE
        ts = s["tile_sums"][rows]
        ts = ts.scatter_add(1, tile, w_pos).scatter_add(1, tile + t, w_neg)
        s["tile_sums"][rows] = ts
        zero = torch.zeros((), dtype=DT, device=w.device)

        def rsum(x):
            return x.sum(-1, dtype=DT)

        s["count"][rows] += rsum(w)
        s["zero_count"][rows] += rsum(torch.where(kb.is_zero, w, zero))
        s["neg_total"][rows] += rsum(w_neg)
        s["sum"][rows] += rsum(torch.where(kb.live, kb.values, zero) * w)
        fin = kb.live & ~torch.isnan(kb.values)
        lo = torch.where(fin, kb.values, math.inf).amin(-1)
        hi = torch.where(fin, kb.values, -math.inf).amax(-1)
        s["min"][rows] = torch.minimum(s["min"][rows], lo)
        s["max"][rows] = torch.maximum(s["max"][rows], hi)
        sig = w_pos + w_neg
        s["collapsed_low"][rows] += rsum(torch.where(k < 0, sig, zero))
        s["collapsed_high"][rows] += rsum(torch.where(k > b - 1, sig, zero))
        for store, hits in (("pos", kb.live & kb.is_pos), ("neg", kb.live & kb.is_neg)):
            s[f"{store}_lo"][rows] = torch.minimum(
                s[f"{store}_lo"][rows], torch.where(hits, idx, b).amin(-1))
            s[f"{store}_hi"][rows] = torch.maximum(
                s[f"{store}_hi"][rows], torch.where(hits, idx, -1).amax(-1))

    def query(self, qs) -> tuple:
        s = self.st
        n = s["count"].shape[0]
        out = []
        for lo in range(0, n, CHUNK):
            out.append(self._query_rows(slice(lo, min(lo + CHUNK, n)), qs))
        return "control", torch.cat(out)

    def _query_rows(self, rows: slice, qs) -> torch.Tensor:
        s = self.st
        q = torch.tensor(qs, dtype=DT, device=s["count"].device)[None, :]
        count, neg = s["count"][rows, None], s["neg_total"][rows, None]
        zero = s["zero_count"][rows, None]
        rank = q * (count - 1)
        cum_pos = torch.cumsum(s["bins_pos"][rows], dim=-1, dtype=DT)
        cum_neg = torch.cumsum(s["bins_neg"][rows], dim=-1, dtype=DT)
        off = s["key_offset"][rows, None]
        pos_rank = rank - zero - neg
        idx_pos = (cum_pos[:, None, :] <= pos_rank[:, :, None]).sum(-1)
        idx_neg = (cum_neg[:, None, :] < (neg - rank)[:, :, None]).sum(-1)
        b = self.n_bins - 1

        def decode(idx):
            return self.mapping.value((torch.clamp(idx, 0, b) + off).to(DT)).to(DT)

        out = torch.where(rank < neg, -decode(idx_neg),
                          torch.where(rank < neg + zero, torch.zeros_like(rank), decode(idx_pos)))
        return torch.where(count > 0, out, float("nan")).float()

    def state(self):
        return None

    def leaves(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {f: t.index_select(0, rows).float() if t.is_floating_point()
                else t.index_select(0, rows) for f, t in self.st.items()}

    def counters(self) -> Dict[str, int]:
        return {}

    def describe(self) -> dict:
        return {"engine": "bf16 reference", "n_bins": self.n_bins, "mapping": self.mapping.name}

    def close(self) -> None:
        self.st = {}
