"""Carry sketch specs, states and partials between the JAX package and the port.

The port never imports the JAX package, so the hand-over is plain data: a
spec as its dataclass fields, a state as one numpy array per leaf (for a
JAX state, e.g. ``{f: np.asarray(getattr(state, f)) for f in LEAVES}``),
and the value-sharded partials of a distributed facade the same way, each
leaf with a leading ``[n_value_shards]`` axis (``np.asarray`` of a JAX
facade's ``partials`` leaves gathers them so).  The accuracy backends'
states go the same way: an ``AdaptiveState`` as the sixteen dense leaves
plus ``level``, a ``MomentState`` as its eight leaves
(``backends.moment.FIELDS``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from sketches_tpu_torch.batched import LEAVES, SketchSpec, SketchState, resolve_device
from sketches_tpu_torch.resilience import SpecError

__all__ = [
    "spec_from_fields",
    "state_from_numpy",
    "state_to_numpy",
    "partials_from_numpy",
    "partials_to_numpy",
    "adaptive_from_numpy",
    "adaptive_to_numpy",
    "moment_from_numpy",
    "moment_to_numpy",
]

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
    spec: SketchSpec, leaves: Mapping[str, np.ndarray], device=None
) -> SketchState:
    """A port ``SketchState`` on ``device`` from one array per leaf.

    ``device`` defaults to the card (``SpecError`` without one); pass
    ``device="cpu"`` for the CPU.  Every one of the sixteen leaves must be
    present; dtypes are checked against the spec (bins and counters in
    ``bin_dtype``, sum/min/max in ``dtype``, offsets and bounds int32).
    """
    device = resolve_device(device)
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


def partials_from_numpy(
    spec: SketchSpec, leaves: Mapping[str, np.ndarray], device=None
) -> SketchState:
    """Stacked partials ``[n_value_shards, n_streams, ...]`` on ``device``
    (the card by default) from one array per leaf, each with the leading
    value-shard axis -- what ``DistributedDDSketch.partials`` takes and
    gives."""
    st = state_from_numpy(spec, leaves, device)
    k = st.bins_pos.shape[0]
    bad = [
        f for f in LEAVES
        if getattr(st, f).ndim != (3 if f in ("bins_pos", "bins_neg", "tile_sums") else 2)
        or getattr(st, f).shape[0] != k
    ]
    if bad:
        raise SpecError(f"partials leaves {bad} lack the leading [{k}] value-shard axis")
    return st


def partials_to_numpy(partials: SketchState) -> Dict[str, np.ndarray]:
    """One numpy array per leaf of stacked partials (a host copy)."""
    if partials.bins_pos.ndim != 3:
        raise SpecError("partials are stacked [n_value_shards, n_streams, ...]")
    return state_to_numpy(partials)


def adaptive_from_numpy(spec: SketchSpec, leaves: Mapping[str, np.ndarray], device=None):
    """A port ``AdaptiveState`` on ``device`` (the card by default) from the
    sixteen dense leaves plus an int32 ``level``."""
    from sketches_tpu_torch.backends.uniform import AdaptiveState

    if "level" not in leaves:
        raise SpecError("adaptive state is missing its level leaf")
    level = np.asarray(leaves["level"])
    if level.dtype != np.int32:
        raise SpecError(f"leaf level has dtype {level.dtype}, expected int32")
    base = state_from_numpy(spec, leaves, device)
    if level.shape != (base.n_streams,):
        raise SpecError(f"leaf level has shape {level.shape}, expected ({base.n_streams},)")
    return AdaptiveState(base, torch.from_numpy(np.array(level, order="C")).to(base.device))


def adaptive_to_numpy(astate) -> Dict[str, np.ndarray]:
    """One numpy array per leaf of an ``AdaptiveState`` (a host copy)."""
    out = state_to_numpy(astate.base)
    out["level"] = astate.level.detach().cpu().numpy()
    return out


def moment_from_numpy(spec: SketchSpec, leaves: Mapping[str, np.ndarray], device=None):
    """A port ``MomentState`` on ``device`` (the card by default) from its
    eight f32 leaves; ``powers`` and ``log_powers`` are ``[n_streams,
    spec.n_moments]``."""
    from sketches_tpu_torch.backends.moment import FIELDS, MomentState

    device = resolve_device(device)
    missing = [f for f in FIELDS if f not in leaves]
    if missing:
        raise SpecError(f"moment state is missing leaves {missing}")
    out = {}
    for f in FIELDS:
        arr = np.asarray(leaves[f])
        if _torch_dtype(arr.dtype) != spec.dtype:
            raise SpecError(f"leaf {f} has dtype {arr.dtype}, expected {spec.dtype}")
        out[f] = torch.from_numpy(np.array(arr, order="C")).to(device)
    n = out["count"].shape[0]
    bad = [f for f in ("powers", "log_powers") if tuple(out[f].shape) != (n, spec.n_moments)]
    if bad:
        raise SpecError(f"leaves {bad} are not [{n}, {spec.n_moments}]")
    return MomentState(**out)


def moment_to_numpy(mstate) -> Dict[str, np.ndarray]:
    """One numpy array per leaf of a ``MomentState`` (a host copy)."""
    from sketches_tpu_torch.backends.moment import FIELDS

    return {f: getattr(mstate, f).detach().cpu().numpy() for f in FIELDS}
