"""The batched system: ``sketches_tpu_torch.BatchedDDSketch`` on its
default engine (``auto``: the kernel path on the card), built from a
configuration file.  It takes the facade, its state leaves and its launch
counters, and nothing else; ``check.judge`` holds it to
``reference/ddsketch_ref.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from sketchbench import check
from sketchbench.yardstick import kernel_bytes

#: The state leaves the check reads (the facade's ``SketchState`` fields).
LEAVES = (
    "bins_pos", "bins_neg", "zero_count", "count", "sum", "min", "max",
    "collapsed_low", "collapsed_high", "key_offset", "pos_lo", "pos_hi",
    "neg_lo", "neg_hi", "neg_total", "tile_sums",
)


class Program:
    name = "program"

    def __init__(self, config: dict, n_streams: int, device):
        from sketches_tpu_torch import BatchedDDSketch, kernels

        self._kernels = kernels
        self.facade = BatchedDDSketch(
            n_streams,
            relative_accuracy=config["relative_accuracy"],
            mapping=config["mapping"],
            n_bins=config["bin_limit"],
            device=device,
        )
        kernels.reset_launch_counts()

    def add(self, values: torch.Tensor, weights=None) -> None:
        self.facade.add(values, weights)

    def query(self, qs) -> tuple:
        """``(tier, answers [n, Q])``."""
        return self.facade.get_quantile_values_resolved(qs)

    def state(self):
        return self.facade.state

    def leaves(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.facade.state
        return {f: getattr(st, f).index_select(0, rows).clone() for f in LEAVES}

    def counters(self) -> Dict[str, int]:
        """Kernel launches since the facade was built (``launch_counts``),
        K1's weighted ones apart."""
        c = dict(self._kernels.launch_counts())
        c["ingest_histogram.weighted"] = self._kernels.ingest_histogram.weighted_launches
        return c

    def describe(self) -> dict:
        return {"engine": self.facade.engine, "n_bins": self.facade.spec.n_bins,
                "mapping": self.facade.spec.mapping_name}

    def close(self) -> None:
        self.facade = None


#: The state and answers against ``reference/ddsketch_ref.py``.
judge = check.judge


def facts(sut, inputs, config: dict, qs) -> dict:
    """K1's bytes an ``add``, and K3's and K5's a query of the final state."""
    n_bins = int(config["bin_limit"])
    st = sut.state()
    f = {"k1_bytes_per_add": kernel_bytes.k1_bytes(
        inputs.n, inputs.width, n_bins, weighted=inputs.weights is not None)}
    if qs and st is not None:
        f["k3_bytes"] = kernel_bytes.k3_bytes(st, n_bins, len(qs))
        f["k5_bytes"] = kernel_bytes.k5_bytes(st, qs)
    return f
