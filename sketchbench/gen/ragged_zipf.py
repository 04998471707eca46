"""Ragged flush: the stream of popularity rank r (1 = most popular; the
ranks a permutation drawn from the seed) gets min(width, ceil(c / r**s))
live slots at the front of its row, weight 1, and the rest is padding of
weight 0 (the ingest kernel's weighted path).  ``s`` = 0.99 is YCSB's
zipfian constant; c is the least constant at which the live slots reach
``live_share`` of all slots, so every seed has the same live counts,
permuted.

Parameters: ``width``, ``exponent``, ``live_share``.
"""

import torch


def counts_by_rank(p: dict, n: int, device) -> torch.Tensor:
    """[n] int64 live slots of the ranks 1..n."""
    width = int(p["width"])
    target = p["live_share"] * n * width
    base = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** -p["exponent"]

    def total(c):
        return float(torch.clamp(torch.ceil(c * base), max=width).sum())

    lo, hi = 0.0, float(width) * float(n) ** p["exponent"]
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if total(mid) >= target:
            hi = mid
        else:
            lo = mid
    return torch.clamp(torch.ceil(hi * base), max=width).to(torch.int64)


def live_counts(p: dict, n: int, g: torch.Generator):
    ranks = torch.randperm(n, generator=g, device=g.device)
    return counts_by_rank(p, n, g.device)[ranks], ranks
