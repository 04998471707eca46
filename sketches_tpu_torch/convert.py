"""Carry sketch specs and states between the JAX package and the port.

The port never imports the JAX package, so the hand-over is plain data: a
spec as its dataclass fields, a state as one numpy array per leaf (for a
JAX state, e.g. ``{f: np.asarray(getattr(state, f)) for f in LEAVES}``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from sketches_tpu_torch.batched import LEAVES, SketchSpec, SketchState
from sketches_tpu_torch.resilience import SpecError

__all__ = ["spec_from_fields", "state_from_numpy", "state_to_numpy"]

_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32}


def _torch_dtype(dt) -> torch.dtype:
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    name = np.dtype(dt).name
    if name not in _TORCH_DTYPES:
        raise SpecError(f"dtype {name} has no counterpart in the port")
    return _TORCH_DTYPES[name]


def spec_from_fields(**fields) -> SketchSpec:
    """A port ``SketchSpec`` from another spec's fields (e.g.
    ``dataclasses.asdict`` of a JAX spec); numpy-style dtypes become torch
    dtypes."""
    for key in ("dtype", "bin_dtype"):
        if key in fields:
            fields[key] = _torch_dtype(fields[key])
    return SketchSpec(**fields)


def state_from_numpy(
    spec: SketchSpec, leaves: Mapping[str, np.ndarray], device="cpu"
) -> SketchState:
    """A port ``SketchState`` on ``device`` from one array per leaf.

    Every one of the sixteen leaves must be present; dtypes are checked
    against the spec (bins and counters in ``bin_dtype``, sum/min/max in
    ``dtype``, offsets and bounds int32).
    """
    missing = [f for f in LEAVES if f not in leaves]
    if missing:
        raise SpecError(f"state is missing leaves {missing}")
    value_leaves = {"sum", "min", "max"}
    index_leaves = {"key_offset", "pos_lo", "pos_hi", "neg_lo", "neg_hi"}
    out = {}
    for f in LEAVES:
        arr = np.asarray(leaves[f])
        want = (
            torch.int32 if f in index_leaves
            else spec.dtype if f in value_leaves
            else spec.bin_dtype
        )
        if _torch_dtype(arr.dtype) != want:
            raise SpecError(f"leaf {f} has dtype {arr.dtype}, expected {want}")
        out[f] = torch.from_numpy(np.array(arr, order="C")).to(device)
    return SketchState(**out)


def state_to_numpy(state: SketchState) -> Dict[str, np.ndarray]:
    """One numpy array per leaf (a host copy)."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in LEAVES}
