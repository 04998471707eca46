"""Gauges: c_s * exp(u) with u spread over (-spread, spread) around a
level ln c_s ~ U(level_low, level_high) drawn per stream.

Each row samples its band evenly: one value in each 1/width of it,
jittered inside that stratum and shuffled along the row.  So the median of
every batch lies within one stratum of the level, and at ``spread`` = 1.1
(divide or multiply by 3) every stream's keys stay inside the 128-bin tile
that the median rule centres it on (about 111 keys at 50-52 keys a unit of
ln).

Parameters: ``level_low``, ``level_high``, ``spread`` (natural-log units).
"""

import torch


def levels(p: dict, n: int, g: torch.Generator) -> torch.Tensor:
    u = torch.rand((n, 1), generator=g, device=g.device)
    return p["level_low"] + (p["level_high"] - p["level_low"]) * u


def values(p: dict, levels: torch.Tensor, width: int, g: torch.Generator) -> torch.Tensor:
    n = levels.shape[0]
    stratum = torch.argsort(torch.rand((n, width), generator=g, device=g.device), dim=1)
    jitter = torch.rand((n, width), generator=g, device=g.device)
    u = (stratum.to(torch.float32) + jitter) * (2.0 / width) - 1.0
    return torch.exp(levels + p["spread"] * u)
