"""Runnable examples of the PyTorch port, one module per scenario.

The counterparts of the JAX package's ``examples/`` scripts, with the same
scenarios, sizes, printed lines and asserts::

    python -m sketches_tpu_torch.examples.chaos_drill [--device cpu]
    python -m sketches_tpu_torch.examples.latency_monitoring
    python -m sketches_tpu_torch.examples.wire_interop
    python -m sketches_tpu_torch.examples.distributed_mesh
    python -m sketches_tpu_torch.examples.heterogeneous_fleet
    python -m sketches_tpu_torch.examples.serve_load
    python -m sketches_tpu_torch.examples.windowed_dashboard
    python -m sketches_tpu_torch.examples.fleet_dashboard

Each runs on the card unless ``--device`` names another torch device; the
mesh examples put their eight value shards on that one device.
"""

import argparse

import numpy as np
import torch

__all__ = ["parser", "host", "protobuf_available"]


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser with the ``--device`` flag."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: the card; 'cpu' runs every"
        " kernel's plain version)",
    )
    return p


def host(x, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor on any device (or of an array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def protobuf_available() -> bool:
    """Whether ``google.protobuf`` imports (the object-bridge paths need it)."""
    try:
        import google.protobuf  # noqa: F401
    except ImportError:
        return False
    return True
