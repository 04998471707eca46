"""Traffic generation: one general builder driven by a traffic file.

A traffic file (``traffic/<name>.json``) names a value kind and a flush
kind, each a module of this package (``gen/<kind>.py``), with their
parameters.  A value kind gives each stream a level (``levels``) and draws
a batch of values around it (``values``); a flush kind says how many slots
of each stream's row are live (``live_counts``).  Everything is drawn on
the run's device from ``--seed``: the same seed gives the same inputs, and
every seed gives the same set of sizes (the flush kinds permute one fixed
set of live counts over the streams).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
from typing import List, Optional

import torch


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A device generator for one named draw of one seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def kind(name: str):
    """The generator module of a kind (``gen/<name>.py``)."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad generator kind {name!r}")
    return importlib.import_module(f"sketchbench.gen.{name}")


@dataclasses.dataclass
class Inputs:
    """A cell's inputs: ``pool`` batches ``[n, width]`` that the loops add
    in turn, the flush's weights (None for a dense flush: unit weights),
    and what the check needs to draw any batch's rows again."""

    traffic: dict
    seed: int
    n: int
    width: int
    levels: torch.Tensor  # [n, 1] float32
    live: torch.Tensor  # [n] int64 live slots a row
    ranks: torch.Tensor  # [n] int64 popularity rank (0 = heaviest)
    weights: Optional[torch.Tensor]
    batches: List[torch.Tensor]

    @property
    def pool_size(self) -> int:
        return int(self.traffic["pool"])

    @property
    def live_values(self) -> int:
        """Live values in one batch."""
        return int(self.live.sum())

    def batch(self, i: int) -> torch.Tensor:
        return self.batches[i % self.pool_size]

    def free(self) -> None:
        self.batches = []
        self.weights = None

    def rows_of_batch(self, k: int, rows: torch.Tensor):
        """Batch ``k`` drawn again from the seed, rows ``rows`` only ->
        ``(values [R, width], weights [R, width] or None)``."""
        v = draw_batch(self.traffic, self.seed, k, self.levels, self.live, self.width)
        w = flush_weights(self.live[rows], self.width)
        return v[rows], w


def flush_weights(live: torch.Tensor, width: int) -> Optional[torch.Tensor]:
    """Weight 1 on each row's first ``live`` slots and 0 on the padding;
    None when every slot is live (the unit path)."""
    if bool((live == width).all()):
        return None
    slot = torch.arange(width, device=live.device)[None, :]
    return (slot < live[:, None]).to(torch.float32)


def draw_batch(traffic: dict, seed: int, k: int, levels: torch.Tensor, live: torch.Tensor,
               width: int) -> torch.Tensor:
    """Pool batch ``k``: values around each stream's level, padding 0."""
    spec = traffic["values"]
    g = generator(seed, f"batch{k}", levels.device)
    v = kind(spec["kind"]).values(spec, levels, width, g)
    if bool((live < width).any()):
        slot = torch.arange(width, device=v.device)[None, :]
        v = torch.where(slot < live[:, None], v, torch.zeros((), device=v.device))
    return v.contiguous()


def build(traffic: dict, seed: int, n: int, device) -> Inputs:
    """Every input of a run, on ``device``."""
    vspec, fspec = traffic["values"], traffic["flush"]
    width = int(fspec["width"])
    levels = kind(vspec["kind"]).levels(vspec, n, generator(seed, "levels", device))
    live, ranks = kind(fspec["kind"]).live_counts(fspec, n, generator(seed, "flush", device))
    weights = flush_weights(live, width)
    batches = [draw_batch(traffic, seed, k, levels, live, width)
               for k in range(int(traffic["pool"]))]
    return Inputs(traffic, seed, n, width, levels, live, ranks, weights, batches)


def sample_rows(inputs: Inputs, n_rows: int, heaviest: int) -> torch.Tensor:
    """The rows the check compares: the ``heaviest`` most popular streams
    and the rest drawn from the seed, sorted."""
    n = inputs.n
    if n_rows >= n:
        return torch.arange(n, device=inputs.levels.device)
    heavy = torch.argsort(inputs.ranks)[:heaviest]
    g = generator(inputs.seed, "rows", inputs.levels.device)
    others = torch.randperm(n, generator=g, device=inputs.levels.device)
    taken = torch.zeros(n, dtype=torch.bool, device=others.device)
    taken[heavy] = True
    rest = others[~taken[others]][: n_rows - heavy.numel()]
    return torch.sort(torch.cat([heavy, rest])).values
