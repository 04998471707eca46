"""Distributed tier: a mesh of devices, sharded ingest and the merge fold
(counterpart of ``sketches_tpu/parallel.py``).

The JAX package drives every device of a mesh from one process (jit plus
``shard_map``); the port does the same, eagerly.  A :class:`SketchMesh` is
a grid of ``torch.device`` s, ``[stream shards, value shards]``, and each
(stream shard, value shard) cell of a :class:`DistributedDDSketch` owns
one ``SketchState`` on its device:

* **Stream parallelism**: stream shard ``s`` holds a contiguous block of
  rows; nothing crosses shards.
* **Value parallelism**: the value batch ``[N, S]`` splits into contiguous
  column blocks of ``S / V``, one per value shard (JAX's
  ``P(stream_axis, value_axis)``), each ingested into that shard's partial.
  A query folds the partials (:func:`psum_merge`: bins, counts and sums
  add; extrema and occupied bounds take min/max) onto the stream shard's
  first device with explicit copies, then answers per stream shard.

A device may appear more than once in a grid: the tests run meshes of
``["cpu"] * 8``, and two value shards can share one card.  Without an
explicit device list a mesh takes every CUDA device and raises
``SpecError`` where there is none.  Failures raise; the JAX package's
fault sites, integrity fingerprints and telemetry are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from sketches_tpu_torch import kernels
from sketches_tpu_torch.batched import (
    LEAVES,
    BatchedDDSketch,
    SketchSpec,
    SketchState,
    _windowed_call,
    _wxla_call,
    add,
    auto_offset,
    data_center_offsets,
    init,
    quantile,
    recenter,
)
from sketches_tpu_torch.resilience import (
    ReshardReport,
    ShardLossError,
    ShardLossReport,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

__all__ = [
    "default_mesh",
    "make_hierarchical_mesh",
    "SketchMesh",
    "shard_streams",
    "psum_merge",
    "fold_live_partials",
    "fold_hosts",
    "DistributedDDSketch",
]


def _value_axes(value_axis) -> tuple:
    """Normalize a value-axis spec (None / one name / tuple of names,
    outer->inner) to a tuple of axis names; empty means no value
    parallelism."""
    if value_axis is None:
        return ()
    if isinstance(value_axis, (tuple, list)):
        return tuple(value_axis)
    return (value_axis,)


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise SpecError(
            "a mesh takes every CUDA device by default and none is available;"
            " pass devices=['cpu', ...] to build one on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class SketchMesh:
    """Rebuildable mesh: a device grid plus the layout policy behind it.

    ``value_axis`` may be one name, ``None`` (pure stream parallelism) or an
    ``(outer, inner)`` pair for the hierarchical fold; ``stream_shards``
    stream shards need a ``stream_axis``.  ``n_hosts`` groups the value
    shards into contiguous groups (the outer level of a hierarchical fold);
    one process drives the whole mesh, so it defaults to 1.  ``devices``
    (any ``torch.device`` specs, repeats allowed) defaults to every CUDA
    device; the first ``n_devices`` of it form the grid, stream-major.
    Raises ``SpecError`` for impossible layouts, as the JAX package does.
    """

    def __init__(
        self,
        n_devices: Optional[int] = None,
        *,
        value_axis="values",
        stream_axis: Optional[str] = None,
        stream_shards: int = 1,
        n_hosts: Optional[int] = None,
        devices=None,
    ):
        pool = _cuda_devices() if devices is None else [torch.device(d) for d in devices]
        if n_devices is None:
            n_devices = len(pool)
        if not 1 <= n_devices <= len(pool):
            raise SpecError(
                f"SketchMesh needs 1 <= n_devices <= {len(pool)}"
                f" available devices; got {n_devices}"
            )
        vaxes = _value_axes(value_axis)
        if len(vaxes) > 2:
            raise SpecError(
                f"value_axis may be one axis name or an (outer, inner) pair; got {value_axis!r}"
            )
        if not vaxes and stream_axis is None:
            raise SpecError("Need at least one of value_axis / stream_axis")
        if stream_axis is None and stream_shards != 1:
            raise SpecError(f"stream_shards={stream_shards} needs a stream_axis")
        if n_devices % max(stream_shards, 1):
            raise SpecError(f"{n_devices} devices do not divide into {stream_shards} stream shards")
        self._pool = tuple(pool)
        self.devices = tuple(pool[:n_devices])
        self.value_axis = vaxes[0] if len(vaxes) == 1 else (tuple(vaxes) if vaxes else None)
        self.stream_axis = stream_axis
        self.stream_shards = int(stream_shards)
        n_value = n_devices // max(stream_shards, 1) if vaxes else 1
        if vaxes and n_value * max(stream_shards, 1) != n_devices:
            raise SpecError(f"{n_devices} devices do not fill the mesh")
        if not vaxes and n_devices != stream_shards:
            raise SpecError(
                f"a stream-only mesh has one device per stream shard; got"
                f" {n_devices} devices for {stream_shards} shards"
            )
        if n_hosts is None:
            n_hosts = 1
        if not vaxes and n_hosts != 1:
            raise SpecError("host grouping applies to value shards; a stream-only mesh has n_hosts=1")
        if n_value % max(n_hosts, 1):
            raise SpecError(f"{n_value} value shards do not divide into {n_hosts} hosts")
        self.n_hosts = int(n_hosts)
        self.n_value_shards = int(n_value)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def grid(self) -> List[List[torch.device]]:
        """Devices as ``[stream shard][value shard]`` (value shards host-major
        for a hierarchical pair)."""
        v = self.n_value_shards
        return [list(self.devices[s * v : (s + 1) * v]) for s in range(self.stream_shards)]

    def resized(self, n_devices: int, devices=None) -> "SketchMesh":
        """The same layout policy at another device count, drawn from
        ``devices`` (default: the pool this mesh was built from).  Host
        grouping is kept where it still divides the value shards and
        collapses to one host otherwise."""
        n_value = n_devices // max(self.stream_shards, 1)
        n_hosts = (
            self.n_hosts
            if n_value >= self.n_hosts and n_value % self.n_hosts == 0
            else 1
        )
        return SketchMesh(
            n_devices,
            value_axis=self.value_axis,
            stream_axis=self.stream_axis,
            stream_shards=self.stream_shards,
            n_hosts=n_hosts,
            devices=self._pool if devices is None else devices,
        )

    def __repr__(self) -> str:
        return (
            f"SketchMesh(n_devices={self.n_devices},"
            f" value_axis={self.value_axis!r},"
            f" stream_axis={self.stream_axis!r},"
            f" stream_shards={self.stream_shards},"
            f" n_hosts={self.n_hosts})"
        )


def default_mesh(
    axis_names: Sequence[str] = ("streams",), shape: Optional[Sequence[int]] = None, devices=None
) -> SketchMesh:
    """A mesh over ``devices`` (default every CUDA device): the first axis
    shards streams, a second one (if named) values; 1-D over all devices
    by default."""
    pool = _cuda_devices() if devices is None else list(devices)
    if not 1 <= len(axis_names) <= 2:
        raise SpecError(f"default_mesh takes one or two axis names; got {tuple(axis_names)}")
    if shape is None:
        shape = (len(pool),) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise SpecError(f"shape {tuple(shape)} does not match axes {tuple(axis_names)}")
    return SketchMesh(
        int(np.prod(shape)),
        value_axis=axis_names[1] if len(axis_names) == 2 else None,
        stream_axis=axis_names[0],
        stream_shards=int(shape[0]),
        devices=pool,
    )


def make_hierarchical_mesh(
    n_hosts: Optional[int] = None,
    value_axes: Sequence[str] = ("dcn", "ici"),
    stream_axis: Optional[str] = None,
    stream_shards: int = 1,
    devices=None,
) -> SketchMesh:
    """A two-level value mesh: ``psum_merge`` folds each host's contiguous
    group of value shards first (the inner axis), then the host partials
    (the outer axis).  Raises ``SpecError`` on indivisible layouts."""
    return SketchMesh(
        value_axis=tuple(value_axes),
        stream_axis=stream_axis,
        stream_shards=stream_shards,
        n_hosts=n_hosts,
        devices=devices,
    )


def _rows(n_streams: int, n_shards: int) -> List[tuple]:
    """Contiguous ``(start, end)`` row blocks of each stream shard."""
    sizes = [len(b) for b in np.array_split(np.arange(n_streams), n_shards)]
    edges = np.concatenate([[0], np.cumsum(sizes)])
    return [(int(edges[i]), int(edges[i + 1])) for i in range(n_shards)]


def shard_streams(state: SketchState, mesh: SketchMesh, axis_name: str = "streams") -> list:
    """Lay a batch over the mesh's stream axis -> one ``SketchState`` per
    stream shard (contiguous rows) on that shard's first device."""
    if mesh.stream_axis != axis_name:
        raise SpecError(f"mesh has no stream axis {axis_name!r} (it has {mesh.stream_axis!r})")
    grid = mesh.grid()
    return [
        state.map(lambda x, a=a, b=b, d=grid[s][0]: x[a:b].to(d))
        for s, (a, b) in enumerate(_rows(state.n_streams, mesh.stream_shards))
    ]


def _fold_pair(a: SketchState, b: SketchState) -> SketchState:
    """``merge`` of two partials of one window; offsets fold with max (they
    are equal on every partial)."""
    return SketchState(
        bins_pos=a.bins_pos + b.bins_pos,
        bins_neg=a.bins_neg + b.bins_neg,
        zero_count=a.zero_count + b.zero_count,
        count=a.count + b.count,
        sum=a.sum + b.sum,
        min=torch.minimum(a.min, b.min),
        max=torch.maximum(a.max, b.max),
        collapsed_low=a.collapsed_low + b.collapsed_low,
        collapsed_high=a.collapsed_high + b.collapsed_high,
        key_offset=torch.maximum(a.key_offset, b.key_offset),
        pos_lo=torch.minimum(a.pos_lo, b.pos_lo),
        pos_hi=torch.maximum(a.pos_hi, b.pos_hi),
        neg_lo=torch.minimum(a.neg_lo, b.neg_lo),
        neg_hi=torch.maximum(a.neg_hi, b.neg_hi),
        neg_total=a.neg_total + b.neg_total,
        tile_sums=a.tile_sums + b.tile_sums,
    )


def psum_merge(partials: Sequence[SketchState], n_hosts: int = 1, device=None) -> SketchState:
    """Fold the value shards' partials of one stream shard onto ``device``
    (default: the first partial's).

    With ``n_hosts > 1`` the fold is hierarchical, like the JAX package's
    over an ``(outer, inner)`` axis pair: each host's contiguous group of
    partials folds first, then the host partials.  Every operand is
    copied to ``device`` explicitly.
    """
    if not partials:
        raise SketchValueError("psum_merge needs at least one partial")
    dev = partials[0].device if device is None else torch.device(device)
    k = len(partials)
    if k % max(n_hosts, 1):
        raise SpecError(f"{k} partials do not divide into {n_hosts} hosts")
    per = k // max(n_hosts, 1)

    def fold(group):
        out = group[0].map(lambda x: x.to(dev))
        for st in group[1:]:
            out = _fold_pair(out, st.map(lambda x: x.to(dev)))
        return out

    hosts = [fold(partials[h * per : (h + 1) * per]) for h in range(k // per)]
    return fold(hosts)


def fold_live_partials(spec: SketchSpec, partials: SketchState, live) -> SketchState:
    """Fold a stacked ``[K, n_streams, ...]`` partials state over its shard
    axis, counting only the shards where ``live[k]`` is True.  Dead shards
    contribute the fold identities (zero mass, +-inf extrema, empty-span
    sentinels), so the result is an exact sketch of the survivors."""
    dev = partials.device
    lv = torch.as_tensor(np.asarray(live, bool), device=dev)
    l2, l1 = lv[:, None, None], lv[:, None]

    def msum(x, m):
        return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=dev)).sum(0, dtype=x.dtype)

    def mext(x, fill, op):
        return op(torch.where(l1, x, torch.full((), fill, dtype=x.dtype, device=dev)), 0)

    i32min = torch.iinfo(torch.int32).min
    return SketchState(
        bins_pos=msum(partials.bins_pos, l2),
        bins_neg=msum(partials.bins_neg, l2),
        zero_count=msum(partials.zero_count, l1),
        count=msum(partials.count, l1),
        sum=msum(partials.sum, l1),
        min=mext(partials.min, float("inf"), torch.amin),
        max=mext(partials.max, float("-inf"), torch.amax),
        collapsed_low=msum(partials.collapsed_low, l1),
        collapsed_high=msum(partials.collapsed_high, l1),
        key_offset=mext(partials.key_offset, i32min, torch.amax),
        pos_lo=mext(partials.pos_lo, spec.n_bins, torch.amin),
        pos_hi=mext(partials.pos_hi, -1, torch.amax),
        neg_lo=mext(partials.neg_lo, spec.n_bins, torch.amin),
        neg_hi=mext(partials.neg_hi, -1, torch.amax),
        neg_total=msum(partials.neg_total, l1),
        tile_sums=msum(partials.tile_sums, l2),
    )


def _stack(states: Sequence[SketchState], device) -> SketchState:
    return SketchState(
        **{f: torch.stack([getattr(st, f).to(device) for st in states]) for f in LEAVES}
    )


def fold_hosts(spec: SketchSpec, states, reachable=None):
    """Cross-host fold of per-host merged states -> ``(folded state,
    ShardLossReport over hosts)``.

    Windows are aligned first (per stream, onto the first reachable host
    holding binned mass), then the stack folds through
    :func:`fold_live_partials` on the first reachable host's device.  An
    unreachable host's mass is folded around and accounted in the report;
    no host reachable raises ``ShardLossError``; an empty or
    shape-mismatched ``states`` raises ``SketchValueError``.
    """
    n_hosts = len(states)
    if n_hosts == 0:
        raise SketchValueError("fold_hosts needs at least one host state")
    shapes = {tuple(st.bins_pos.shape) for st in states}
    if len(shapes) != 1:
        raise SketchValueError(f"fold_hosts needs equal-shape host states; got {shapes}")
    if reachable is None:
        reach = np.ones((n_hosts,), bool)
    else:
        reach = np.asarray(reachable, bool).reshape(-1)
        if reach.shape[0] != n_hosts:
            raise SketchValueError(f"reachable mask length {reach.shape[0]} != {n_hosts} hosts")
    if not reach.any():
        raise ShardLossError(f"all {n_hosts} hosts unreachable; nothing to fold")
    live_idx = np.nonzero(reach)[0]
    dev = states[int(live_idx[0])].device
    offs = np.stack([st.key_offset.cpu().numpy() for st in states])
    binned = np.stack(
        [(st.count.double() - st.zero_count.double()).cpu().numpy() for st in states]
    )
    target = offs[live_idx[0]].copy()
    chosen = np.zeros(target.shape, bool)
    for h in live_idx:
        pick = (~chosen) & (binned[h] > 0)
        target[pick] = offs[h][pick]
        chosen |= pick
    aligned = [
        st if not reach[h] or (offs[h] == target).all()
        else recenter(spec, st, torch.as_tensor(target, device=st.device))
        for h, st in enumerate(states)
    ]
    folded = fold_live_partials(spec, _stack(aligned, dev), reach)
    counts = np.stack([st.count.double().cpu().numpy() for st in aligned])
    report = ShardLossReport(
        live=reach,
        surviving_count=counts[reach].sum(0),
        dropped_count=counts[~reach].sum(0),
    )
    return folded, report


class DistributedDDSketch:
    """Mesh-parallel sketch batch: sharded ingest, folded queries.

    Counterpart of the JAX package's facade.  ``mesh`` is a
    :class:`SketchMesh` (whose axis names the facade takes) or ``None``: a
    mesh over every CUDA device on ``value_axis``, or on ``stream_axis``
    when ``value_axis`` is None.  ``engine="auto" | "kernel" | "plain"``
    stands for JAX's ``"auto" | "pallas" | "xla"``, judged on the
    per-shard shapes; a call whose per-shard batch width is not 128-aligned
    takes the plain ``add`` for that call, as in JAX.  The first batch
    centres each still-empty stream on the largest of the value shards'
    batch-median offsets, so every partial shares one window per stream.

    Queries walk the five tiers of the JAX facade (``overlap``, ``tiles``,
    ``windowed``, ``wxla``, ``xla``), planned over every stream shard's
    fold at the shard-local block width; on the kernel engine ``xla`` is
    ``kernels.fused_quantile``, else ``batched.quantile``.  Answers come
    back on the mesh's first device.  Failures raise.
    """

    def __init__(
        self,
        n_streams: int,
        mesh: Optional[SketchMesh] = None,
        value_axis="values",
        stream_axis: Optional[str] = None,
        spec: Optional[SketchSpec] = None,
        engine: str = "auto",
        auto_recenter: Optional[bool] = None,
        n_hosts: Optional[int] = None,
        **spec_kwargs,
    ):
        if auto_recenter is None:
            auto_recenter = spec is None and "key_offset" not in spec_kwargs
        if spec is None:
            spec = SketchSpec(**spec_kwargs)
        if spec.backend != "dense":
            raise SpecError(f"DistributedDDSketch requires backend='dense'; got {spec.backend!r}")
        if engine not in ("auto", "kernel", "plain"):
            raise SpecError(f"Unknown engine {engine!r}; expected 'auto', 'kernel' or 'plain'")
        self.spec = spec
        if isinstance(value_axis, (tuple, list)):
            value_axis = tuple(value_axis) or None
        if mesh is None:
            if value_axis is None and stream_axis is None:
                raise SpecError(
                    "Need at least one of value_axis / stream_axis (or pass an explicit mesh)"
                )
            if value_axis is not None:
                mesh = SketchMesh(value_axis=value_axis, n_hosts=n_hosts)
            else:
                devs = _cuda_devices()
                mesh = SketchMesh(
                    value_axis=None, stream_axis=stream_axis, stream_shards=len(devs), devices=devs
                )
        elif not isinstance(mesh, SketchMesh):
            raise SpecError(f"mesh must be a SketchMesh; got {type(mesh).__name__}")
        self.mesh = mesh
        self.value_axis = mesh.value_axis
        self.stream_axis = mesh.stream_axis
        vaxes = _value_axes(mesh.value_axis)
        self.n_value_shards = mesh.n_value_shards
        self.n_hosts = mesh.n_hosts if n_hosts is None else int(n_hosts)
        if self.n_value_shards % max(self.n_hosts, 1):
            raise SpecError(
                f"{self.n_value_shards} value shards do not divide into {self.n_hosts} hosts"
            )
        # The hierarchical fold runs over an (outer, inner) value-axis pair.
        self._fold_groups = self.n_hosts if len(vaxes) == 2 else 1
        self.n_streams = n_streams
        self._grid = mesh.grid()
        n_stream_shards = len(self._grid)
        self._row_blocks = _rows(n_streams, n_stream_shards)
        divisible = n_streams % n_stream_shards == 0
        n_local = n_streams // n_stream_shards
        if engine == "kernel" and not divisible:
            raise SpecError(
                f"engine='kernel' needs a whole per-shard stream count:"
                f" n_streams={n_streams} is not divisible by {n_stream_shards} stream shards"
            )
        use_kernels = all(
            kernels.select_engine(spec, n_local if divisible else 1, engine, d)
            for d in sorted(set(mesh.devices), key=str)
        )
        self._engine_arg = engine
        self.engine = "kernel" if use_kernels else "plain"
        self._kernel_ingest = use_kernels
        self._kernel_query = use_kernels and not spec.bins_integer
        self._wxla_ok = spec.n_bins % 128 == 0
        self._n_local_streams = n_local if divisible else 0
        self._shards = [
            [init(spec, b - a, d) for d in row]
            for row, (a, b) in zip(self._grid, self._row_blocks)
        ]
        self._folds: Optional[list] = None
        self._merged: Optional[SketchState] = None
        self._window_plan = None
        self._tile_plans: dict = {}
        self._qs_tensors: dict = {}
        self._auto_recenter_pending = bool(auto_recenter)
        self._pending_recenter_mask: Optional[np.ndarray] = None
        self._policy_collapsed = np.zeros((n_streams,), np.float64)
        self._policy_binned = np.zeros((n_streams,), np.float64)
        self._policy_stale = False

    # -- ingest --------------------------------------------------------------
    def _local_add(self, st: SketchState, values, weights) -> SketchState:
        """One partial's ingest: the fused kernel when this call's per-shard
        width qualifies, the plain scatter ``add`` otherwise."""
        if (
            self._kernel_ingest
            and kernels.supports(self.spec, st.n_streams, values.shape[-1])
            and not (self.spec.bins_integer and weights is not None)
        ):
            return kernels.add(self.spec, st, values, weights)
        return add(self.spec, st, values, weights)

    def _block(self, x, s: int, v: int):
        """Stream shard ``s``'s rows and value shard ``v``'s columns of a
        batch, on that cell's device (None stays None)."""
        if x is None:
            return None
        a, b = self._row_blocks[s]
        w = x.shape[-1] // self.n_value_shards
        return x[a:b, v * w : (v + 1) * w].to(self._grid[s][v]).contiguous()

    def add(self, values, weights=None) -> "DistributedDDSketch":
        """Ingest ``values[n_streams, S]``; S must divide by the number of
        value shards (pad ragged batches with ``weights == 0`` entries)."""
        values = torch.as_tensor(values, dtype=self.spec.dtype)
        if values.ndim == 1:
            values = values[:, None]
        if values.shape[-1] % self.n_value_shards:
            raise SketchValueError(
                f"values width {values.shape[-1]} must be divisible by the"
                f" {self.n_value_shards} value shards; pad with weights=0 entries"
            )
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=self.spec.dtype, device=values.device)
            if weights.ndim == 1:
                weights = weights[:, None]
            weights = weights.broadcast_to(values.shape)
        armed = self._pending_recenter_mask is not None
        if self._auto_recenter_pending or armed:
            or_empty = self._auto_recenter_pending
            if armed:
                mask = torch.as_tensor(self._pending_recenter_mask)
            else:
                mask = torch.zeros((self.n_streams,), dtype=torch.bool)
            self._auto_recenter_pending = False
            self._pending_recenter_mask = None
            self._recenter_ingest(values, weights, mask, or_empty)
        else:
            for s, row in enumerate(self._shards):
                for v, st in enumerate(row):
                    row[v] = self._local_add(
                        st, self._block(values, s, v), self._block(weights, s, v)
                    )
        self._invalidate()
        if armed:
            st = self.merged_state()
            self._policy_collapsed = (st.collapsed_low + st.collapsed_high).double().cpu().numpy()
            self._policy_binned = (st.count - st.zero_count).double().cpu().numpy()
        return self

    def _recenter_ingest(self, values, weights, mask, or_empty: bool) -> None:
        """Derive offsets from this batch on every value shard, take their
        max per stream, recenter every partial to the same offsets, ingest.
        ``or_empty`` also recentres streams with no folded binned mass."""
        for s, row in enumerate(self._shards):
            a, b = self._row_blocks[s]
            dev0 = self._grid[s][0]
            vals = [self._block(values, s, v) for v in range(len(row))]
            wts = [self._block(weights, s, v) for v in range(len(row))]
            offs = torch.stack(
                [auto_offset(self.spec, st, x, w).to(dev0) for st, x, w in zip(row, vals, wts)]
            ).amax(0)
            m = mask[a:b].to(dev0)
            if or_empty:
                binned = torch.stack(
                    [(st.count - st.zero_count).to(dev0) for st in row]
                ).sum(0)
                m = m | (binned <= 0)
            target = torch.where(m, offs, row[0].key_offset.to(dev0))
            for v, st in enumerate(row):
                st = recenter(self.spec, st, target.to(st.device))
                row[v] = self._local_add(st, vals[v], wts[v])

    # -- fold ----------------------------------------------------------------
    def _invalidate(self) -> None:
        self._folds = None
        self._merged = None
        self._window_plan = None
        self._tile_plans = {}

    def _shard_folds(self) -> List[SketchState]:
        """Each stream shard's folded state on its first device (cached
        between mutations)."""
        if self._folds is None:
            self._folds = [
                psum_merge(row, n_hosts=self._fold_groups, device=devs[0])
                for row, devs in zip(self._shards, self._grid)
            ]
        return self._folds

    def merged_state(self) -> SketchState:
        """The folded ``[n_streams, n_bins]`` batch on the mesh's first
        device (cached between mutations)."""
        if self._merged is None:
            folds = self._shard_folds()
            dev = self._grid[0][0]
            if len(folds) == 1:
                self._merged = folds[0]
            else:
                self._merged = SketchState(
                    **{f: torch.cat([getattr(st, f).to(dev) for st in folds]) for f in LEAVES}
                )
        return self._merged

    def shard_partials(self) -> List[List[SketchState]]:
        """The partials as ``[stream shard][value shard]`` states, each on
        its own device (the live objects: read, do not mutate)."""
        return self._shards

    # -- query ---------------------------------------------------------------
    def _plans(self, qs_tuple: tuple, bn: int):
        if self._window_plan is None:
            stats = [kernels.window_stats(st) for st in self._shard_folds()]
            glo = min(x[0] for x in stats)
            ghi = max(x[1] for x in stats)
            lo_w, n_w, w_t = kernels.plan_window(self.spec, glo, ghi)
            self._window_plan = (lo_w, n_w, w_t, any(x[2] for x in stats))
        plan = self._tile_plans.get(qs_tuple)
        if plan is None and bn:
            # Judged at the shard-local block width: the max over shards of
            # each shard's largest block union bounds every block.
            per_shard = [
                kernels.plan_tile_query(self.spec, st, list(qs_tuple), bn=bn)
                for st in self._shard_folds()
            ]
            plan = (max(p[0] for p in per_shard), any(p[1] for p in per_shard))
            self._tile_plans[qs_tuple] = plan
        return self._window_plan, plan

    def _query_choice(self, qs_tuple: tuple, disabled: frozenset = frozenset()):
        """Per-shard query dispatch -> ``(tier, fn)``, ``fn(state, qs)``
        answering one stream shard's fold."""
        spec = self.spec
        if self._kernel_query and "windowed" not in disabled:
            n_local = self._n_local_streams
            bn = kernels._stream_block(n_local) if n_local else 0
            eligible = n_local and "tiles" not in disabled
            wplan, _ = self._plans(qs_tuple, 0)
            if eligible and kernels.tile_query_eligible(spec, len(qs_tuple), wplan):
                wplan, plan = self._plans(qs_tuple, bn)
                k_tiles, with_neg_t = plan
                pick = kernels.choose_query_engine(
                    wplan, plan,
                    overlap_ok=kernels.overlap_enabled() and "overlap" not in disabled,
                )
                if pick == "overlap":
                    return "overlap", functools.partial(
                        kernels.fused_quantile_tiles_overlap, spec,
                        k_tiles=k_tiles, with_neg=with_neg_t, block_streams=bn,
                    )
                if pick == "tiles":
                    return "tiles", functools.partial(
                        kernels.fused_quantile_tiles, spec, k_tiles=k_tiles, with_neg=with_neg_t
                    )
            lo_w, n_w, w_t, with_neg = wplan
            return "windowed", functools.partial(_windowed_call, spec, lo_w, n_w, w_t, with_neg)
        if self._wxla_ok and "wxla" not in disabled:
            lo_w, n_w, w_t, with_neg = self._plans(qs_tuple, 0)[0]
            return "wxla", functools.partial(_wxla_call, spec, lo_w * w_t, n_w * w_t, with_neg)
        if self._kernel_query:
            return "xla", functools.partial(kernels.fused_quantile, spec)
        return "xla", functools.partial(quantile, spec)

    def _qs_on(self, qs_tuple: tuple, device) -> torch.Tensor:
        key = (qs_tuple, str(device))
        qs = self._qs_tensors.get(key)
        if qs is None:
            qs = self._qs_tensors[key] = torch.tensor(qs_tuple, dtype=torch.float32, device=device)
        return qs

    def _run_query(self, qs_tuple: tuple, disabled: frozenset = frozenset()):
        tier, fn = self._query_choice(qs_tuple, disabled)
        outs = [fn(st, self._qs_on(qs_tuple, st.device)) for st in self._shard_folds()]
        if len(outs) == 1:
            return tier, outs[0]
        dev = self._grid[0][0]
        return tier, torch.cat([o.to(dev) for o in outs])

    def get_quantile_value(self, q: float) -> torch.Tensor:
        """Per-stream value at ``q`` -> ``[n_streams]`` (NaN if empty)."""
        return self._run_query((float(q),))[1][:, 0]

    def get_quantile_values(self, qs: Sequence[float]) -> torch.Tensor:
        """Fused multi-quantile -> ``[n_streams, Q]``."""
        return self._run_query(tuple(float(q) for q in qs))[1]

    def get_quantile_values_resolved(self, quantiles: Sequence[float], disabled_tiers=()):
        """Fused multi-quantile that also names the tier that answered ->
        ``(tier, [n_streams, Q])``; ``disabled_tiers`` excludes tiers for
        this call only."""
        return self._run_query(tuple(float(q) for q in quantiles), frozenset(disabled_tiers))

    # -- merge / windows -----------------------------------------------------
    def _recenter_all(self, shards, target: torch.Tensor) -> list:
        """Every partial of ``shards`` recentred to the per-stream
        ``target`` [N] (new states; the operand is not mutated)."""
        out = []
        for row, (a, b) in zip(shards, self._row_blocks):
            out.append([recenter(self.spec, st, target[a:b].to(st.device)) for st in row])
        return out

    def merge(self, other: "DistributedDDSketch") -> "DistributedDDSketch":
        """Fold another distributed batch of the same mesh shape into this
        one, partial by partial, after one broadcast recenter of both onto
        a shared window per stream (self's offsets where self holds binned
        mass, the operand's otherwise)."""
        if self.spec != other.spec:
            raise UnequalSketchParametersError(
                "Cannot merge distributed sketches with different specs"
            )
        if (
            len(other._shards) != len(self._shards)
            or other.n_value_shards != self.n_value_shards
            or other._row_blocks != self._row_blocks
        ):
            raise SpecError("merge needs operands on meshes of one shape; reshard one first")
        a_st = self.merged_state()
        b_st = other.merged_state()
        dev = a_st.device
        a_binned = (a_st.count - a_st.zero_count) > 0
        target = torch.where(a_binned, a_st.key_offset, b_st.key_offset.to(dev)).to(torch.int32)
        mine = self._recenter_all(self._shards, target)
        theirs = self._recenter_all(other._shards, target)
        self._shards = [
            [_fold_pair(x, y.map(lambda t, d=x.device: t.to(d))) for x, y in zip(r1, r2)]
            for r1, r2 in zip(mine, theirs)
        ]
        self._invalidate()
        if self._auto_recenter_pending and bool((b_st.count > 0).any()):
            self._auto_recenter_pending = False
        return self

    def recenter(self, new_key_offset) -> "DistributedDDSketch":
        """Slide every stream's window to ``new_key_offset`` (scalar or
        [N]), identically on every partial."""
        off = torch.as_tensor(new_key_offset, dtype=torch.int32).broadcast_to((self.n_streams,))
        self._shards = self._recenter_all(self._shards, off)
        self._invalidate()
        return self

    def recenter_to_data(self) -> "DistributedDDSketch":
        """Recenter each stream on its folded binned-mass median, the same
        shift on every partial."""
        targets = [data_center_offsets(self.spec, st) for st in self._shard_folds()]
        self._shards = [
            [recenter(self.spec, st, t.to(st.device)) for st in row]
            for row, t in zip(self._shards, targets)
        ]
        self._invalidate()
        return self

    def collapsed_fraction(self) -> torch.Tensor:
        """Per-stream fraction of binned mass that hit a window edge -> [N]."""
        st = self.merged_state()
        binned = (st.count - st.zero_count).to(self.spec.dtype)
        collapsed = (st.collapsed_low + st.collapsed_high).to(self.spec.dtype)
        return collapsed / torch.clamp(binned, min=1)

    def maybe_recenter(self, threshold: float = 0.01) -> bool:
        """Arm a recenter, on the next batch's median keys, for streams whose
        collapse grew by more than ``threshold`` of their binned-mass growth
        since the previous call (the batched facade's policy on the folded
        counters).  Returns whether any stream armed."""
        st = self.merged_state()
        collapsed = (st.collapsed_low + st.collapsed_high).double().cpu().numpy()
        binned = (st.count - st.zero_count).double().cpu().numpy()
        d_coll = collapsed - self._policy_collapsed
        d_binned = binned - self._policy_binned
        self._policy_collapsed = collapsed
        self._policy_binned = binned
        if self._policy_stale:
            self._policy_stale = False
            return False
        mask = d_coll > threshold * np.maximum(d_binned, 1.0)
        if mask.any():
            prev = self._pending_recenter_mask
            self._pending_recenter_mask = mask if prev is None else np.logical_or(prev, mask)
            return True
        return False

    # -- shard loss / reshard ------------------------------------------------
    def merge_partial(self, live_mask=None):
        """Fold only the live value shards' partials -> ``(state,
        ShardLossReport)``: an exact sketch of the surviving mass, with the
        per-stream dropped mass.  ``live_mask`` is ``[n_value_shards]``
        bool, all live by default; none live raises ``ShardLossError``."""
        k = self.n_value_shards
        live = np.ones((k,), bool) if live_mask is None else np.asarray(live_mask, bool).reshape(-1)
        if live.shape[0] != k:
            raise SketchValueError(f"live_mask length {live.shape[0]} != n_value_shards {k}")
        if not live.any():
            raise ShardLossError(f"all {k} value shards marked dead; nothing to fold")
        partials = self.partials
        survived = fold_live_partials(self.spec, partials, live)
        full_count = partials.count.double().sum(0).cpu().numpy()
        surviving = survived.count.double().cpu().numpy()
        report = ShardLossReport(
            live=live, surviving_count=surviving, dropped_count=full_count - surviving
        )
        return survived, report

    def reshard(
        self,
        mesh: Optional[SketchMesh] = None,
        n_devices: Optional[int] = None,
        *,
        live_mask=None,
        engine: Optional[str] = None,
        n_hosts: Optional[int] = None,
    ):
        """Fold the surviving partials and rebuild the fleet on another mesh
        -> ``(new facade, ReshardReport)``.  The target is ``mesh`` or this
        mesh's layout resized to ``n_devices``.  This facade is left as it
        was.  Raises ``SpecError`` without a target, ``ShardLossError``
        when no shard survives, ``SketchValueError`` on a bad mask."""
        k = self.n_value_shards
        live = np.ones((k,), bool)
        if live_mask is not None:
            lm = np.asarray(live_mask, bool).reshape(-1)
            if lm.shape[0] != k:
                raise SketchValueError(f"live_mask length {lm.shape[0]} != n_value_shards {k}")
            live &= lm
        if not live.any():
            raise ShardLossError(f"all {k} value shards marked dead; nothing to regrow from")
        if mesh is None:
            if n_devices is None:
                raise SpecError("reshard needs a target: mesh= or n_devices=")
            mesh = self.mesh.resized(n_devices)
        partials = self.partials
        part_counts = partials.count.double().cpu().numpy()
        folded = fold_live_partials(self.spec, partials, live)
        surviving = folded.count.double().cpu().numpy()
        new = DistributedDDSketch.from_merged_state(
            folded,
            self.spec,
            mesh=mesh,
            engine=self._engine_arg if engine is None else engine,
            n_hosts=n_hosts,
        )
        new_count = new.merged_state().count.double().cpu().numpy()
        report = ReshardReport(
            live=live,
            from_devices=self.mesh.n_devices,
            to_devices=mesh.n_devices,
            surviving_count=surviving,
            dropped_count=part_counts[~live].sum(axis=0),
            exact=bool(np.array_equal(new_count, surviving, equal_nan=True)),
        )
        return new, report

    @classmethod
    def from_merged_state(
        cls,
        state: SketchState,
        spec: SketchSpec,
        mesh: Optional[SketchMesh] = None,
        value_axis="values",
        stream_axis: Optional[str] = None,
        engine: str = "auto",
        live_mask=None,
        n_hosts: Optional[int] = None,
    ) -> "DistributedDDSketch":
        """A mesh-sharded facade holding a folded batch (the inverse of
        ``merged_state``).  The state loads into value shard 0's partials;
        the others keep their empty init (the fold's identities) and take
        the loaded offsets.  A stacked ``[K, N, ...]`` state folds its
        ``live_mask`` shards first (all of them without a mask)."""
        if live_mask is None and state.bins_pos.ndim == 3:
            live_mask = np.ones((state.bins_pos.shape[0],), bool)
        if live_mask is not None:
            live = np.asarray(live_mask, bool).reshape(-1)
            if state.bins_pos.ndim != 3 or state.bins_pos.shape[0] != live.shape[0]:
                raise SketchValueError(
                    "live_mask requires a stacked [K, n_streams, n_bins] partials state with"
                    f" K == len(live_mask) == {live.shape[0]}; got bins of shape"
                    f" {tuple(state.bins_pos.shape)}"
                )
            if not live.any():
                raise ShardLossError("all partials marked dead; nothing to restore")
            state = fold_live_partials(spec, state, live)
        dist = cls(
            state.n_streams,
            mesh=mesh,
            value_axis=value_axis,
            stream_axis=stream_axis,
            spec=spec,
            engine=engine,
            n_hosts=n_hosts,
        )
        for s, (row, (a, b)) in enumerate(zip(dist._shards, dist._row_blocks)):
            rows = state.map(lambda x, a=a, b=b: x[a:b])
            row[0] = rows.map(lambda x, d=row[0].device: x.to(d).clone())
            for v in range(1, len(row)):
                row[v] = dataclasses.replace(row[v], key_offset=row[0].key_offset.to(row[v].device))
        dist._invalidate()
        return dist

    def to_batched(self) -> BatchedDDSketch:
        """The folded batch as a single-batch facade (a copy)."""
        st = self.merged_state()
        return BatchedDDSketch(
            self.n_streams,
            spec=self.spec,
            state=st.map(torch.clone),
            engine="plain" if self._engine_arg == "plain" else "auto",
            device=st.device,
        )

    # -- accessors -----------------------------------------------------------
    @property
    def state(self) -> SketchState:
        """The folded batch (``merged_state``), for read paths."""
        return self.merged_state()

    @property
    def partials(self) -> SketchState:
        """The partials stacked ``[n_value_shards, n_streams, ...]`` on the
        mesh's first device (a copy)."""
        dev = self._grid[0][0]
        per_v = [
            SketchState(
                **{
                    f: torch.cat([getattr(row[v], f).to(dev) for row in self._shards])
                    for f in LEAVES
                }
            )
            for v in range(self.n_value_shards)
        ]
        return _stack(per_v, dev)

    @partials.setter
    def partials(self, new_partials: SketchState) -> None:
        """Load a stacked ``[n_value_shards, n_streams, ...]`` state onto the
        mesh; cached folds, plans and the recenter policy reset."""
        if tuple(new_partials.bins_pos.shape[:2]) != (self.n_value_shards, self.n_streams):
            raise SketchValueError(
                f"partials must be stacked [{self.n_value_shards}, {self.n_streams}, ...];"
                f" got bins of shape {tuple(new_partials.bins_pos.shape)}"
            )
        self._shards = [
            [
                new_partials.map(lambda x, v=v, a=a, b=b, d=d: x[v, a:b].to(d).contiguous())
                for v, d in enumerate(devs)
            ]
            for devs, (a, b) in zip(self._grid, self._row_blocks)
        ]
        self._invalidate()
        self._policy_stale = True
        self._pending_recenter_mask = None

    @property
    def count(self) -> torch.Tensor:
        return self.merged_state().count

    @property
    def sum(self) -> torch.Tensor:  # noqa: A003 - reference API name
        return self.merged_state().sum

    def __repr__(self) -> str:
        return (
            f"DistributedDDSketch(n_streams={self.n_streams}, mesh={self.mesh!r},"
            f" value_axis={self.value_axis!r}, stream_axis={self.stream_axis!r})"
        )
