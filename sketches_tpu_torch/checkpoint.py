"""Checkpoint / resume for batched sketch states (PyTorch port).

Counterpart of ``sketches_tpu/checkpoint.py`` for the batched states of
every backend (dense ``SketchState``, uniform-collapse ``AdaptiveState``,
``MomentState``): one host copy of the state into a compressed npz of the
raw state arrays plus the spec, and a copy back onto a device on restore.
The file format is the JAX package's own (the same npz member names, spec
JSON and sha256 digest), so a checkpoint written by either package
verifies and restores in the other bit for bit.

Durability contract:

* **Atomic writes.**  ``save_state`` serializes to memory, writes a
  same-directory temp file, fsyncs, and ``os.replace``s it into place: a
  crash mid-write leaves the previous checkpoint intact, never a torn file
  at ``path``.
* **Validated restores.**  The npz carries a content checksum (sha256 over
  the spec JSON + every state array's name, dtype, shape and bytes).
  ``restore_state`` turns any restore failure (truncated or corrupted
  archive, checksum mismatch, missing fields) into a
  :class:`~sketches_tpu_torch.resilience.CheckpointCorrupt` naming the path
  and the cause.  Checkpoints without a checksum member still restore;
  they skip the content check.

* **Verified content (integrity armed).**  ``save_state`` refuses a state
  that fails ``integrity.verify_state`` and stores the per-stream content
  fingerprint as a ``__fingerprint__`` member; an armed ``restore_state``
  checks the restored state and compares its fingerprint with that member
  (``IntegrityError`` on a mismatch, distinct from ``CheckpointCorrupt``,
  which covers the archive's own validation).  The member is the JAX
  package's, so an armed checkpoint of either package verifies in the
  other.
* **Fault site.**  An armed ``checkpoint.write`` fault truncates the bytes
  (a torn write reaching ``path``) or raises before the rename (the
  previous checkpoint survives).

Windowed rings (``save_windowed`` / ``restore_windowed``) keep ring,
ladder and exact mass ledger in one atomically renamed npz under the same
contract, in the JAX package's ``windowed-v1`` format.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Tuple, Union

import numpy as np
import torch

from sketches_tpu_torch import faults, integrity, telemetry
from sketches_tpu_torch.backends.moment import FIELDS as MOMENT_FIELDS
from sketches_tpu_torch.backends.moment import MomentState
from sketches_tpu_torch.batched import (
    LEAVES,
    BatchedDDSketch,
    SketchSpec,
    SketchState,
    _dtype_name,
    occupied_bounds_np,
    resolve_device,
    tile_sums_np,
)
from sketches_tpu_torch.convert import _torch_dtype
from sketches_tpu_torch.resilience import CheckpointCorrupt, SpecError

__all__ = [
    "save", "restore", "restore_distributed", "save_state",
    "restore_state", "save_windowed", "restore_windowed",
]

_FIELDS = list(LEAVES)

#: zlib level of the archive's members.  Any level inflates alike, so the
#: JAX package (``np.savez_compressed``, zlib's default level 6) reads
#: these files and the port reads its files.  On a 1M x 512 state of
#: small integer counts level 1 deflated about 5x faster than
#: ``np.savez_compressed`` for a 44% larger file (PERF.md, section 6).
_ZLIB_LEVEL = 1


def _fields_of(spec: SketchSpec) -> list:
    """The npz state members of the spec's backend."""
    if spec.backend == "moment":
        return list(MOMENT_FIELDS)
    if spec.backend == "uniform_collapse":
        return _FIELDS + ["level"]
    return list(_FIELDS)


def _state_arrays(spec: SketchSpec, state) -> dict:
    """The npz array dict of any backend's state: one host copy per leaf.
    Raises ``SpecError`` when the state type disagrees with
    ``spec.backend``."""
    if spec.backend == "uniform_collapse":
        if not hasattr(state, "base"):
            raise SpecError(
                f"uniform_collapse checkpoint needs an AdaptiveState; got {type(state).__name__}"
            )
        arrays = {name: getattr(state.base, name).cpu().numpy() for name in _FIELDS}
        arrays["level"] = state.level.cpu().numpy()
        return arrays
    if spec.backend == "moment":
        if not hasattr(state, "powers"):
            raise SpecError(
                f"moment checkpoint needs a MomentState; got {type(state).__name__}"
            )
        return {name: getattr(state, name).cpu().numpy() for name in MOMENT_FIELDS}
    return {name: getattr(state, name).cpu().numpy() for name in _FIELDS}


def _arrays_to_backend_state(spec: SketchSpec, arrays: dict, device):
    """npz arrays -> the spec's backend state on ``device`` (the
    restore-side twin of :func:`_state_arrays`)."""
    t = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for name, a in arrays.items()}
    if spec.backend == "uniform_collapse":
        from sketches_tpu_torch.backends.uniform import AdaptiveState

        level = t.pop("level").to(torch.int32)
        return AdaptiveState(SketchState(**t), level)
    if spec.backend == "moment":
        return MomentState(**t)
    return SketchState(**t)


def _spec_json(spec: SketchSpec) -> str:
    """The spec's canonical checkpoint-metadata JSON, the JAX package's
    byte for byte (dtypes by name)."""
    return json.dumps(
        {
            "relative_accuracy": spec.relative_accuracy,
            "mapping_name": spec.mapping_name,
            "n_bins": spec.n_bins,
            "key_offset": spec.key_offset,
            "dtype": _dtype_name(spec.dtype),
            "bin_dtype": _dtype_name(spec.bin_dtype),
            "backend": spec.backend,
            "collapse_threshold": spec.collapse_threshold,
            "max_collapses": spec.max_collapses,
            "n_moments": spec.n_moments,
        }
    )


def _spec_from_meta(meta: dict) -> SketchSpec:
    """Rebuild a spec from checkpoint metadata (missing fields of older
    checkpoints take their historical defaults).  Invalid field values
    raise ``SpecError`` through the ``SketchSpec`` constructor."""
    return SketchSpec(
        relative_accuracy=meta["relative_accuracy"],
        mapping_name=meta["mapping_name"],
        n_bins=meta["n_bins"],
        key_offset=meta["key_offset"],
        dtype=_torch_dtype(meta["dtype"]),
        # Older checkpoints carry no bin_dtype: bins followed dtype.
        bin_dtype=_torch_dtype(meta.get("bin_dtype", meta["dtype"])),
        # Older checkpoints carry no backend: every state was dense.
        backend=meta.get("backend", "dense"),
        collapse_threshold=meta.get("collapse_threshold", 0.01),
        max_collapses=meta.get("max_collapses", 10),
        n_moments=meta.get("n_moments", 12),
    )


def _digest(spec_json: str, arrays: dict) -> str:
    """Content checksum over the spec + every array's identity and bytes."""
    h = hashlib.sha256()
    h.update(spec_json.encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _npz_bytes(members: dict) -> bytes:
    """An npz archive of ``members`` in memory: what ``np.savez_compressed``
    writes (one ``<name>.npy`` a member, deflated), at ``_ZLIB_LEVEL``."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED, allowZip64=True,
                         compresslevel=_ZLIB_LEVEL) as zf:
        for name, a in members.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)
    return buf.getvalue()


def save_state(path: str, spec: SketchSpec, state: SketchState) -> None:
    """Write spec + state to ``path`` (npz; compressed, checksummed,
    atomically renamed into place).  A state whose type disagrees with
    ``spec.backend`` raises ``SpecError``; with the integrity layer armed a
    corrupted state is refused (``IntegrityError``) and the content
    fingerprint rides along as ``__fingerprint__``."""
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    if integrity._ACTIVE:
        integrity.verify_state(spec, state, seam="checkpoint.save")
    arrays = _state_arrays(spec, state)
    spec_json = _spec_json(spec)
    extra = {}
    if integrity._ACTIVE:
        # Per-stream content fingerprint (sha256 covers the bytes, this
        # the content), dispatched per backend state type.
        extra["__fingerprint__"] = integrity.fingerprint(spec, state)
    # Serialize to memory first so the bytes reach disk in one write; the
    # temp file + rename below closes the torn-write window.
    data = _npz_bytes(
        {
            "__spec__": np.frombuffer(spec_json.encode(), np.uint8),
            "__checksum__": np.frombuffer(_digest(spec_json, arrays).encode(), np.uint8),
            **extra,
            **arrays,
        }
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        if faults._ACTIVE:
            # "truncate" models a torn write reaching the final path;
            # "raise" a crash before the rename (the previous checkpoint
            # survives either way).
            data = faults.inject(faults.CHECKPOINT_WRITE, payload=data)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if _t0 is not None:
            telemetry.finish_span("checkpoint.save_s", _t0)
            telemetry.gauge_set("checkpoint.bytes", float(len(data)))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_state(path: str, device=None) -> Tuple[SketchSpec, SketchState]:
    """Load (spec, state) written by ``save_state`` (of either package)
    onto ``device`` (the card by default; ``device="cpu"`` for the CPU).

    Returns the spec's backend state (``SketchState``, ``AdaptiveState``
    or ``MomentState``).  Raises :class:`CheckpointCorrupt` on any
    integrity failure (torn file, bad archive, checksum mismatch, missing
    members); a missing file stays ``FileNotFoundError``.  With the
    integrity layer armed the restored state is checked, and compared with
    the ``__fingerprint__`` member when the file has one (``IntegrityError``
    or a report, per the mode).
    """
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    dev = resolve_device(device)
    try:
        spec, state, stored_fp = _restore_state_inner(path, dev)
    except (FileNotFoundError, CheckpointCorrupt, SpecError):
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} failed to restore ({type(e).__name__}: {e})"
        ) from e
    if integrity._ACTIVE:
        integrity.verify_restore(spec, state, stored_fp, seam="checkpoint.restore")
    if _t0 is not None:
        telemetry.finish_span("checkpoint.restore_s", _t0)
    return spec, state


def _restore_state_inner(path: str, device):
    with np.load(path) as data:
        stored_fp = (
            np.asarray(data["__fingerprint__"]) if "__fingerprint__" in data.files else None
        )
        meta_json = bytes(data["__spec__"]).decode()
        spec = _spec_from_meta(json.loads(meta_json))
        fields = _fields_of(spec)
        # Each member once: npz decompresses again on every access.
        arrays = {name: np.asarray(data[name]) for name in fields if name in data.files}
        if "__checksum__" in data.files:
            stored = bytes(data["__checksum__"]).decode()
            got = _digest(meta_json, arrays)
            if got != stored:
                raise CheckpointCorrupt(
                    f"checkpoint {path!r} checksum mismatch"
                    f" (stored {stored[:12]}..., recomputed {got[:12]}...):"
                    " content corrupted after write"
                )
    if spec.backend != "dense":
        missing = [n for n in fields if n not in arrays]
        if missing:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} ({spec.backend} backend) is missing state"
                f" members {missing}"
            )
        return spec, _arrays_to_backend_state(spec, arrays, device), stored_fp
    # Checkpoints from before per-stream windows carry no offsets: every
    # stream was on the spec default.
    if "key_offset" not in arrays:
        arrays["key_offset"] = np.full(arrays["count"].shape, spec.key_offset, np.int32)
    # Checkpoints from before the occupied bounds or the tile sums: derive
    # them from the bins (exact).
    bp, bn = arrays["bins_pos"], arrays["bins_neg"]
    if "pos_lo" not in arrays:
        for name, bins in (("pos", bp), ("neg", bn)):
            arrays[f"{name}_lo"], arrays[f"{name}_hi"] = occupied_bounds_np(bins)
        arrays["neg_total"] = bn.sum(axis=-1).astype(bn.dtype)
    if "tile_sums" not in arrays:
        arrays["tile_sums"] = tile_sums_np(bp, bn).astype(bp.dtype)
    return spec, _arrays_to_backend_state(spec, arrays, device), stored_fp


def save(
    path: str,
    sketch: Union[BatchedDDSketch, "DistributedDDSketch"],  # noqa: F821
    partials: bool = False,
) -> None:
    """Checkpoint a sketch facade: batched, adaptive, moment, or
    distributed (folded first).

    ``partials=True`` (distributed facades only; ``SpecError`` otherwise)
    saves the stacked ``[K, n_streams, ...]`` partials instead of the fold:
    ``restore_distributed(..., live_mask=...)`` can then drop dead shards
    at restore time, which a folded checkpoint cannot.
    """
    from sketches_tpu_torch.parallel import DistributedDDSketch

    if isinstance(sketch, DistributedDDSketch):
        state = sketch.partials if partials else sketch.merged_state()
        save_state(path, sketch.spec, state)
    else:
        if partials:
            raise SpecError(
                "partials=True needs a DistributedDDSketch (a batched"
                " facade has no shard axis)"
            )
        save_state(path, sketch.spec, sketch.state)


def restore(path: str, engine: str = "auto", device=None):
    """Resume a checkpoint as the facade of its backend on ``device`` (the
    card by default), with its engine selected here: a ``BatchedDDSketch``
    (dense), an ``AdaptiveDDSketch`` (uniform_collapse, levels intact) or a
    ``MomentDDSketch``.  Corrupt archives raise ``CheckpointCorrupt`` via
    :func:`restore_state`."""
    spec, state = restore_state(path, device)
    if spec.backend != "dense":
        from sketches_tpu_torch.backends import facade_for

        return facade_for(
            state.n_streams, spec=spec, state=state, engine=engine, device=state.device
        )
    return BatchedDDSketch(
        state.n_streams, spec=spec, state=state, engine=engine, device=state.device
    )


def restore_distributed(
    path: str,
    mesh=None,
    value_axis="values",
    stream_axis=None,
    engine: str = "auto",
    live_mask=None,
    n_hosts=None,
):
    """Resume a checkpoint as a mesh-sharded ``DistributedDDSketch``.

    A folded checkpoint (``save`` of a distributed facade) loads into value
    shard 0's partials (``DistributedDDSketch.from_merged_state``); the
    other shards hold the fold's identities, so the fold reproduces the
    saved totals exactly.  The mesh may differ, in size too, from the one
    the checkpoint was written under: state carries no topology.

    A ``save(..., partials=True)`` checkpoint restores the stacked
    partials; ``live_mask`` (a ``[K]`` bool) then drops dead shards at
    restore time, and a mask over a folded checkpoint raises
    ``SketchValueError``.  The state is read onto the mesh's first device
    (every CUDA device's mesh without ``mesh``).  A torn or corrupted file
    raises ``CheckpointCorrupt``.
    """
    from sketches_tpu_torch.parallel import DistributedDDSketch

    device = mesh.devices[0] if mesh is not None else None
    spec, state = restore_state(path, device)
    return DistributedDDSketch.from_merged_state(
        state,
        spec,
        mesh=mesh,
        value_axis=value_axis,
        stream_axis=stream_axis,
        engine=engine,
        live_mask=live_mask,
        n_hosts=n_hosts,
    )


# ---------------------------------------------------------------------------
# Windowed ring checkpoints (ring + ladder + ledger, atomically)
# ---------------------------------------------------------------------------


def _windowed_buckets(wsk):
    """``(rung, id, state, mass, live)`` for every bucket of a ring, frozen
    buckets first (rung, then id order), the live bucket last: the member
    order ``b{k}`` of a windowed checkpoint."""
    out = [
        (rung, bid, wsk._rungs[rung][bid].state, wsk._rungs[rung][bid].mass, False)
        for rung in range(wsk.config.n_rungs)
        for bid in sorted(wsk._rungs[rung])
    ]
    if wsk._live_id is not None:
        out.append((0, wsk._live_id, wsk._snapshot_state(wsk._live.state), wsk._live_mass, True))
    return out


def _windowed_doc(wsk) -> Tuple[str, dict]:
    """Flatten a WindowedSketch to (meta json, array dict): bucket ``k``'s
    state arrays under ``b{k}.<field>``; the meta carries the spec, the
    ladder, the per-bucket ledger entries (the live bucket flagged) and the
    retired and total mass."""
    spec = wsk.spec
    buckets_meta = []
    arrays: dict = {}
    for k, (rung, bid, state, mass, live) in enumerate(_windowed_buckets(wsk)):
        for name, arr in _state_arrays(spec, state).items():
            arrays[f"b{k}.{name}"] = arr
        buckets_meta.append({"rung": rung, "id": bid, "mass": mass, "live": live})
    meta = {
        "format": "windowed-v1",
        "spec": json.loads(_spec_json(spec)),
        "config": {
            "slices_s": list(wsk.config.slices_s),
            "lengths": list(wsk.config.lengths),
            "collapse_levels": (
                None if wsk.config.collapse_levels is None
                else list(wsk.config.collapse_levels)
            ),
        },
        "n_streams": wsk.n_streams,
        "buckets": buckets_meta,
        "total": wsk._total,
        "retired": wsk._retired,
        "rotations": wsk._rotations,
        "ladder_collapses": wsk._ladder_collapses,
        "cur": wsk._cur,
    }
    return json.dumps(meta, sort_keys=True), arrays


def save_windowed(path: str, wsk) -> None:
    """Checkpoint a ``WindowedSketch``: ring, ladder and exact mass ledger in
    ONE atomically renamed npz, so a crash mid-write never tears the ring
    from its ledger.

    Same durability contract as :func:`save_state`: serialize to memory,
    temp file + fsync + ``os.replace``, a sha256 checksum over the meta and
    every bucket array.  The armed integrity layer verifies every bucket
    state before anything reaches disk and embeds per-bucket fingerprints
    (``__fp_b{k}__``) for the restore side; the armed ``checkpoint.write``
    site tears or aborts as for batched states.  Raises ``SpecError`` for a
    non-windowed argument.
    """
    from sketches_tpu_torch.windows import WindowedSketch

    if not isinstance(wsk, WindowedSketch):
        raise SpecError(
            f"save_windowed needs a WindowedSketch; got"
            f" {type(wsk).__name__} (use save() for plain facades)"
        )
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    meta_json, arrays = _windowed_doc(wsk)
    extra = {}
    if integrity._ACTIVE:
        for k, (_rung, _bid, state, _mass, _live) in enumerate(_windowed_buckets(wsk)):
            integrity.verify_state(wsk.spec, state, seam="checkpoint.save_windowed")
            extra[f"__fp_b{k}__"] = integrity.fingerprint(wsk.spec, state)
    data = _npz_bytes(
        {
            "__window__": np.frombuffer(meta_json.encode(), np.uint8),
            "__checksum__": np.frombuffer(_digest(meta_json, arrays).encode(), np.uint8),
            **extra,
            **arrays,
        }
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        if faults._ACTIVE:
            data = faults.inject(faults.CHECKPOINT_WRITE, payload=data)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if _t0 is not None:
            telemetry.finish_span("checkpoint.save_s", _t0)
            telemetry.gauge_set("checkpoint.bytes", float(len(data)))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_windowed(
    path: str,
    *,
    clock=None,
    mesh=None,
    value_axis=None,
    stream_axis=None,
    engine: str = "auto",
    device=None,
):
    """Resume a :func:`save_windowed` checkpoint (of either package) -> a
    ``WindowedSketch`` on ``device`` (the card by default) with its ring,
    ladder positions and exact mass ledger intact.

    ``clock`` must agree with the timeline the ring was saved under (a
    virtual clock restores deterministically).  ``mesh``/``value_axis``
    re-home the live bucket on a mesh-sharded fleet (frozen buckets are
    topology-free).  A torn or corrupted archive raises
    :class:`CheckpointCorrupt`; an armed integrity layer re-verifies every
    bucket against its embedded fingerprint; a missing file stays
    ``FileNotFoundError``; ``SKETCHES_TPU_WINDOWED=0`` refuses through the
    ``WindowedSketch`` constructor.
    """
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    try:
        wsk = _restore_windowed_inner(
            path, clock=clock, mesh=mesh, value_axis=value_axis,
            stream_axis=stream_axis, engine=engine, device=device,
        )
    except (FileNotFoundError, CheckpointCorrupt):
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"windowed checkpoint {path!r} failed to restore ({type(e).__name__}: {e})"
        ) from e
    if _t0 is not None:
        telemetry.finish_span("checkpoint.restore_s", _t0)
    return wsk


def _restore_windowed_inner(path, *, clock, mesh, value_axis, stream_axis, engine, device):
    from sketches_tpu_torch.windows import WindowConfig, WindowedSketch, _Bucket

    with np.load(path) as data:
        if "__window__" not in data.files:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} is not a windowed checkpoint"
                " (no __window__ member); use restore() instead"
            )
        meta_json = bytes(data["__window__"]).decode()
        meta = json.loads(meta_json)
        spec = _spec_from_meta(meta["spec"])
        cfg = meta["config"]
        config = WindowConfig(
            slices_s=tuple(cfg["slices_s"]),
            lengths=tuple(cfg["lengths"]),
            collapse_levels=(
                None if cfg["collapse_levels"] is None else tuple(cfg["collapse_levels"])
            ),
        )
        fields = _fields_of(spec)
        arrays_np = {}
        for k in range(len(meta["buckets"])):
            for name in fields:
                key = f"b{k}.{name}"
                if key not in data.files:
                    raise CheckpointCorrupt(
                        f"windowed checkpoint {path!r} is missing bucket array {key!r}"
                    )
                arrays_np[key] = np.asarray(data[key])
        if "__checksum__" in data.files:
            stored = bytes(data["__checksum__"]).decode()
            got = _digest(meta_json, arrays_np)
            if got != stored:
                raise CheckpointCorrupt(
                    f"windowed checkpoint {path!r} checksum mismatch"
                    f" (stored {stored[:12]}..., recomputed {got[:12]}...):"
                    " content corrupted after write"
                )
        stored_fps = {
            k: np.asarray(data[f"__fp_b{k}__"])
            for k in range(len(meta["buckets"]))
            if f"__fp_b{k}__" in data.files
        }
    wsk = WindowedSketch(
        int(meta["n_streams"]), spec=spec, config=config, clock=clock, mesh=mesh,
        value_axis=value_axis, stream_axis=stream_axis, engine=engine, device=device,
    )
    for k, bm in enumerate(meta["buckets"]):
        state = _arrays_to_backend_state(
            spec, {name: arrays_np[f"b{k}.{name}"] for name in fields}, wsk.device
        )
        if integrity._ACTIVE and k in stored_fps:
            integrity.verify_restore(
                spec, state, stored_fps[k], seam="checkpoint.restore_windowed"
            )
        if bm["live"]:
            wsk._set_live_state(state)
            wsk._live_id = int(bm["id"])
            wsk._live_mass = float(bm["mass"])
        else:
            wsk._rungs[int(bm["rung"])][int(bm["id"])] = _Bucket(
                rung=int(bm["rung"]), id=int(bm["id"]), state=state, mass=float(bm["mass"]),
            )
    wsk._total = float(meta["total"])
    wsk._retired = float(meta["retired"])
    wsk._rotations = int(meta.get("rotations", 0))
    wsk._ladder_collapses = int(meta.get("ladder_collapses", 0))
    wsk._cur = None if meta["cur"] is None else int(meta["cur"])
    # The two-stacks aggregates are derived state, never serialized, and
    # the rungs above were assigned behind the constructor's back: drop the
    # fresh stacks so the first plan rebuilds them (counted as a rebuild).
    wsk._agg_invalidate()
    return wsk
