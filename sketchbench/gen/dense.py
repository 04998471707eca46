"""Dense flush: every slot of every row is live, unit weights (the ingest
kernel's unit path).  Parameters: ``width``."""

import torch


def live_counts(p: dict, n: int, g: torch.Generator):
    width = int(p["width"])
    live = torch.full((n,), width, dtype=torch.int64, device=g.device)
    return live, torch.arange(n, device=g.device)
