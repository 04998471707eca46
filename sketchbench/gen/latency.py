"""Latencies: lognormal(mu_s, sigma) around a level mu_s drawn per stream,
mu_s ~ U(mu_low, mu_high), the heavy-tailed span-duration shape of the
DDSketch paper's evaluation (Masson, Rim and Lee, VLDB 2019).

Parameters: ``mu_low``, ``mu_high``, ``sigma`` (natural-log units).
"""

import torch


def levels(p: dict, n: int, g: torch.Generator) -> torch.Tensor:
    u = torch.rand((n, 1), generator=g, device=g.device)
    return p["mu_low"] + (p["mu_high"] - p["mu_low"]) * u


def values(p: dict, levels: torch.Tensor, width: int, g: torch.Generator) -> torch.Tensor:
    z = torch.randn((levels.shape[0], width), generator=g, device=g.device)
    return torch.exp(levels + p["sigma"] * z)
