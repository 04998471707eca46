"""Time-windowed quantiles: "p99 over the last 5 minutes" as a query
(PyTorch port of ``sketches_tpu/windows.py``).

DDSketch's full mergeability makes windowing a merge over the bucket
sketches that cover the window.  This module is that composition:

* **Ring of time-slice buckets.**  A :class:`WindowedSketch` routes ingest
  to the *current* bucket of a ring of time slices (one backend sketch per
  slice: dense, ``uniform_collapse``, ``moment``, or a mesh-sharded
  ``DistributedDDSketch``).  The clock is injectable (``telemetry.clock``
  by default), so every rotation and query replays exactly under a
  :class:`VirtualClock`; nothing here sleeps or reads wall time.
* **Window queries fold the covered buckets** with the backend's own merge
  algebra: dense buckets through ``batched.merge`` when every state shares
  one ``key_offset`` and ``batched.merge_aligned`` otherwise, adaptive
  buckets through ``backends.uniform.merge``, moment buckets through
  ``backends.moment.merge``.  The folded dense state decodes through
  ``kernels.floor_quantile`` (the full-window kernel on the card, where
  the JAX package dispatches its jitted ``batched.quantile``).  The answer
  is bit-identical to :func:`oracle_quantile`, a host-driven sequential
  merge of the covered buckets.
* **Eviction is rotation, with an exact mass ledger.**  A bucket that ages
  out of its ring retires into the next rung of a coarsening ladder
  (5 s -> 1 min -> 1 h by default), collapsing first on the
  ``uniform_collapse`` backend when the rung declares a collapse level;
  mass falling off the last rung is recorded in ``retired_mass``.  Every
  ingested unit of weight is in exactly one live bucket or retired, and
  :func:`sketches_tpu_torch.integrity.check_window` holds the ledger with
  ``==``.
* **Atomic rotation.**  A rotation plans functionally (new ring dicts, new
  folded states) and commits by reference swap; the ``window.rotate_torn``
  fault site fires between plan and commit, so a torn rotation leaves the
  ring, the ledger and the live bucket as they were.
* **Maintained aggregates.**  Sealed buckets of each rung sit in a
  two-stacks aggregator (:class:`_TwoStacks`), so a window query folds
  O(1) pre-merged components; a repeat query on an unchanged window
  decodes from a cached folded state through a throwaway facade's query
  ladder (the overlap kernel on the card).  ``SKETCHES_TPU_WINDOW_AGG=0``
  falls back to folding every covered bucket.

Where the JAX package caches ``jax.jit`` callables per spec, the port keeps
plain Python callables in the same per-spec caches (PyTorch runs eagerly).
States carry their device: a ring lives where its live facade lives (the
card unless ``device="cpu"``, or the mesh's first device).

The port's dense facade updates a large state's tensors in place, chunk by
chunk, where the JAX facade donates its buffers; a :class:`WindowPlan` that
names the live bucket must therefore be consumed before the ring's next
write, exactly as the JAX contract says (the serving tier plans and
dispatches under one lock).

Failure modes: constructing (or querying) a :class:`WindowedSketch` with
``SKETCHES_TPU_WINDOWED=0`` raises ``SpecError``; invalid ladder
configurations raise ``SpecError`` at construction; a window with no
covered mass answers NaN; merging mismatched configs raises
``UnequalSketchParametersError``; a torn rotation (injected) raises
``InjectedFault`` with nothing mutated.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sketches_tpu_torch import batched, faults, integrity, kernels, telemetry
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.batched import SketchSpec
from sketches_tpu_torch.resilience import (
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
    bump,
    record_downgrade,
)

__all__ = [
    "WindowConfig",
    "WindowedSketch",
    "VirtualClock",
    "DEFAULT_LADDER",
]


class VirtualClock:
    """A deterministic, manually advanced clock for tests and drills.

    Call the instance to read ``t``, :meth:`advance` to move it.  Time never
    goes backwards: a negative delta raises ``SketchValueError`` (a
    backwards window clock would re-open retired buckets).
    """

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        """Move the clock forward by ``dt`` seconds -> the new time."""
        if dt < 0:
            raise SketchValueError("VirtualClock cannot run backwards")
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """The ring/ladder layout: per-rung slice widths and ring lengths.

    ``slices_s[r]`` is rung ``r``'s slice width in seconds (rung 0 takes
    ingest); ``lengths[r]`` is how many slices rung ``r`` keeps before a
    bucket retires into rung ``r + 1`` (or, off the last rung, is dropped
    with its mass recorded in ``retired_mass``).  ``collapse_levels[r]``
    (``uniform_collapse`` only) is the level a bucket is brought to when it
    *enters* rung ``r``: the rung's declared ``effective_alpha``.

    Non-positive widths or lengths, a coarser slice that is not an integer
    multiple of the finer one, and a ``collapse_levels`` tuple of the wrong
    length or in decreasing order raise ``SpecError``.
    """

    slices_s: Tuple[float, ...] = (5.0, 60.0, 3600.0)
    lengths: Tuple[int, ...] = (12, 60, 24)
    collapse_levels: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        slices = tuple(float(s) for s in self.slices_s)
        lengths = tuple(int(n) for n in self.lengths)
        object.__setattr__(self, "slices_s", slices)
        object.__setattr__(self, "lengths", lengths)
        if not slices or len(slices) != len(lengths):
            raise SpecError(
                "WindowConfig needs one (slice width, ring length) pair"
                f" per rung; got {len(slices)} widths, {len(lengths)}"
                " lengths"
            )
        if any(s <= 0 for s in slices) or any(n <= 0 for n in lengths):
            raise SpecError("slice widths and ring lengths must be positive")
        for fine, coarse in zip(slices, slices[1:]):
            ratio = coarse / fine
            if coarse <= fine or abs(ratio - round(ratio)) > 1e-9:
                raise SpecError(
                    "ladder slices must be strictly coarsening integer"
                    f" multiples; got {fine}s -> {coarse}s"
                )
        if self.collapse_levels is not None:
            levels = tuple(int(v) for v in self.collapse_levels)
            object.__setattr__(self, "collapse_levels", levels)
            if len(levels) != len(slices):
                raise SpecError(
                    "collapse_levels needs one level per rung; got"
                    f" {len(levels)} for {len(slices)} rungs"
                )
            if any(v < 0 for v in levels) or list(levels) != sorted(levels):
                raise SpecError(
                    "collapse_levels must be non-negative and"
                    " non-decreasing (coarser rungs never regain"
                    " resolution)"
                )

    @property
    def n_rungs(self) -> int:
        return len(self.slices_s)

    def horizon_s(self) -> float:
        """Total retained history in seconds (every rung's span summed)."""
        return float(sum(s * n for s, n in zip(self.slices_s, self.lengths)))


#: The dashboard-shaped default ladder: 12 x 5 s (the live minute),
#: 60 x 1 min (the hour), 24 x 1 h (the day).
DEFAULT_LADDER = WindowConfig()


@dataclasses.dataclass
class _Bucket:
    """One frozen time-slice bucket: its ring position, its backend state
    and its exact ledger entry.  ``fp`` memoizes the content fingerprint
    (a frozen state never changes)."""

    rung: int
    id: int
    state: Any
    mass: float
    fp: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One resolved window query: the covered buckets' states (frozen at
    plan time, so a rotation between plan and dispatch cannot skew the
    answer), their fingerprints, and the cache-key digest of the covered
    ``(rung, id, fingerprint)`` set.  From
    :meth:`WindowedSketch.window_plan`; an empty plan answers NaN.

    A plan must be consumed before the ring's next write: ingest may
    update the live bucket's tensors in place."""

    window_s: Optional[float]
    now: float
    keys: Tuple[Tuple[int, int], ...]  # (rung, bucket id), coverage order
    states: Tuple[Any, ...]
    fingerprint: np.ndarray
    digest: bytes
    #: Maintained-aggregate path (``SKETCHES_TPU_WINDOW_AGG=1``): the
    #: pre-merged component states the fold runs over, and one recipe per
    #: component naming the ``states`` indices it folds and its tree shape
    #: (``("raw", i)`` or ``("fold", rung, front idxs, back idxs)``), which
    #: :func:`oracle_quantile` replays.  ``None`` on the full re-merge path.
    components: Optional[Tuple[Any, ...]] = None
    recipes: Optional[Tuple[Tuple, ...]] = None

    @property
    def n_covered(self) -> int:
        return len(self.states)


def _dense_quantile(spec: SketchSpec, state, qs):
    """A dense or adaptive folded state's quantiles through the floor
    router (K2 on the card, ``batched.quantile`` on the CPU); the adaptive
    answer is level-corrected as ``uniform.quantile`` does."""
    if spec.backend == "uniform_collapse":
        from sketches_tpu_torch.backends import uniform

        return uniform.correct_values(
            spec, state.level, kernels.floor_quantile(spec, state.base, qs)
        )
    return kernels.floor_quantile(spec, state, qs)


def _merge_fn(spec: SketchSpec, aligned: bool) -> Callable:
    """The backend's pairwise merge: ``batched.merge`` for aligned dense
    operands, ``batched.merge_aligned`` for drifted ones, the backend's own
    merge otherwise."""
    if spec.backend == "uniform_collapse":
        from sketches_tpu_torch.backends import uniform

        return functools.partial(uniform.merge, spec)
    if spec.backend == "moment":
        from sketches_tpu_torch.backends import moment

        return functools.partial(moment.merge, spec)
    return functools.partial(batched.merge if aligned else batched.merge_aligned, spec)


def _left_fold(merge: Callable, states):
    acc = states[0]
    for st in states[1:]:
        acc = merge(acc, st)
    return acc


#: Process-wide fold cache: ``{mode: callable}`` per spec.  Dense specs
#: carry two modes, ``"aligned"`` (every covered window shares one offset:
#: elementwise merge) and ``"general"`` (a ``merge_aligned`` chain),
#: chosen on the host from the plan's offsets; the oracle makes the same
#: choice, so bit-identity holds by symmetry.
_FOLD_CACHE: Dict[SketchSpec, Dict[str, Callable]] = {}


def _plan_aligned(spec: SketchSpec, states) -> bool:
    """Whether every covered dense state shares one per-stream window
    offset.  Non-dense backends answer False (their folds self-align)."""
    if spec.backend != "dense" or len(states) < 2:
        return spec.backend == "dense"
    first = states[0].key_offset
    return all(torch.equal(first, st.key_offset) for st in states[1:])


def _fold_for(spec: SketchSpec) -> Dict[str, Callable]:
    fns = _FOLD_CACHE.get(spec)
    if fns is not None:
        return fns
    folds = _fold_state_for(spec)
    if spec.backend == "moment":
        from sketches_tpu_torch.backends import moment

        def host_solve(states, qs):  # host maxent after one merge chain
            return moment.quantile(spec, folds["general"](states), qs)

        fns = {"general": host_solve}
    else:
        fns = {
            mode: (lambda states, qs, f=fold: _dense_quantile(spec, f(states), qs))
            for mode, fold in folds.items()
        }
    _FOLD_CACHE[spec] = fns
    return fns


def _fold_mode(spec: SketchSpec, states) -> str:
    fns = _fold_for(spec)
    if "aligned" in fns and _plan_aligned(spec, states):
        return "aligned"
    return "general"


#: Fold-to-STATE twin of :data:`_FOLD_CACHE` (the serving tier's windowed
#: stacking reduces each tenant to one state, then decodes every
#: same-spec tenant in one call): the same per-mode merge chains.
_FOLD_STATE_CACHE: Dict[SketchSpec, Dict[str, Callable]] = {}


def _fold_state_for(spec: SketchSpec) -> Dict[str, Callable]:
    fns = _FOLD_STATE_CACHE.get(spec)
    if fns is not None:
        return fns
    if spec.backend == "dense":
        fns = {
            "general": functools.partial(_left_fold, _merge_fn(spec, False)),
            "aligned": functools.partial(_left_fold, _merge_fn(spec, True)),
        }
    else:
        fns = {"general": functools.partial(_left_fold, _merge_fn(spec, False))}
    _FOLD_STATE_CACHE[spec] = fns
    return fns


#: Single-state quantile twin: decode ONE (already folded) state.  With the
#: per-digest folded-window cache this is the whole cost of a repeated
#: window query on the non-dense backends.
_QUANTILE_CACHE: Dict[SketchSpec, Callable] = {}


def _quantile_for(spec: SketchSpec) -> Callable:
    fn = _QUANTILE_CACHE.get(spec)
    if fn is not None:
        return fn
    if spec.backend == "moment":
        from sketches_tpu_torch.backends import moment

        fn = functools.partial(moment.quantile, spec)
    else:
        fn = functools.partial(_dense_quantile, spec)
    _QUANTILE_CACHE[spec] = fn
    return fn


def _batch_mass(spec: SketchSpec, values, weights) -> float:
    """Exact host-side mass of one ingest batch, matching the device
    ``count`` delta: the sum of positive weights (``w <= 0`` lanes are
    padding; NaN values still count, in the zero path).  Integer bins
    truncate fractional weights as the device cast does.  ``values`` may be
    a tensor on any device: unweighted, only its size is read."""
    if weights is None:
        if isinstance(values, torch.Tensor):
            return float(values.numel())
        return float(np.asarray(values).size)
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    shape = tuple(values.shape) if hasattr(values, "shape") else np.asarray(values).shape
    w = np.broadcast_to(np.asarray(weights, np.float64), shape)
    live = w > 0
    if spec.bins_integer:
        return float(np.trunc(w[live]).sum())
    return float(w[live].sum())


def _leaves(state) -> List[torch.Tensor]:
    """Every tensor of a backend state, in field order (the adaptive base's
    leaves before its level)."""
    out: List[torch.Tensor] = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


class _TwoStacks:
    """Two-stacks incremental aggregator over ONE rung's *sealed* buckets.

    ``front`` holds the older buckets as ``(id, raw state, suffix state)``,
    oldest first, where ``suffix[j]`` is the RIGHT fold ``raw[j] + (raw[j+1]
    + (...))`` over the rest of the front, so evicting the oldest entry
    leaves every other suffix valid.  ``back`` holds the newer buckets as
    ``(id, raw state)`` with lazily maintained LEFT-fold tails
    (``_tails[start id] = (n folded, state)``), each extended by one merge
    when a bucket lands.  An eviction that finds the front empty flips the
    whole back into the front, so every pushed bucket is merged at most once
    by a flip and at most once by a tail extension (<= 2 merges per rotation
    amortized).  A window answer over the rung is then one merge, ``front
    suffix + back tail``.

    The tree SHAPE is the bit-identity contract: backend merges are not
    associative in floating point, so :meth:`suffix` reports which ids sit
    in each leg and :func:`oracle_quantile` replays the same right fold
    (front) + left fold (back).  Cached states are derived: dropping them is
    always safe.
    """

    __slots__ = ("_owner", "rung", "front", "back", "_tails", "_combined")

    def __init__(self, owner: "WindowedSketch", rung: int):
        self._owner = owner
        self.rung = rung
        self.front: List[Tuple[int, Any, Any]] = []
        self.back: List[Tuple[int, Any]] = []
        #: back start id -> (entries folded from there, left-fold state)
        self._tails: Dict[int, Tuple[int, Any]] = {}
        #: front id -> (back length folded, suffix+back-tail state)
        self._combined: Dict[int, Tuple[int, Any]] = {}

    def ids(self) -> List[int]:
        return [e[0] for e in self.front] + [e[0] for e in self.back]

    def _merge(self, a, b):
        o = self._owner
        o._agg_maint_merges += 1
        return o._merge_states(a, b)

    def push(self, bid: int, state) -> None:
        """Append a newly sealed bucket (no merges: tails extend lazily)."""
        if self.back and bid <= self.back[-1][0]:
            raise SketchValueError(
                f"two-stacks push out of order: {bid} after {self.back[-1][0]}"
            )
        if self.front and bid <= self.front[-1][0]:
            raise SketchValueError(f"two-stacks push out of order: {bid} behind front")
        self.back.append((bid, state))

    def evict(self, bid: int) -> None:
        """Drop the oldest sealed bucket (it retired off the rung)."""
        if not self.front:
            self._flip()
        if not self.front or self.front[0][0] != bid:
            raise SketchValueError(
                f"two-stacks evict out of order: {bid} is not the oldest"
            )
        self.front.pop(0)
        self._combined.pop(bid, None)

    def _flip(self) -> None:
        """Move the whole back into the front, computing right-fold
        suffixes (one merge per entry beyond the first)."""
        acc = None
        rev: List[Tuple[int, Any, Any]] = []
        for bid, raw in reversed(self.back):
            acc = raw if acc is None else self._merge(raw, acc)
            rev.append((bid, raw, acc))
        self.front = list(reversed(rev))
        self.back = []
        self._tails.clear()
        self._combined.clear()

    def _back_tail(self, t: int):
        """Left fold of ``back[t:]``, extended by one merge per newly pushed
        bucket."""
        bid = self.back[t][0]
        n = len(self.back) - t
        cached = self._tails.get(bid)
        if cached is not None and cached[0] == n:
            return cached[1]
        if cached is not None and 0 < cached[0] < n:
            done, acc = cached
        else:
            done, acc = 1, self.back[t][1]
        for i in range(t + done, len(self.back)):
            acc = self._merge(acc, self.back[i][1])
        self._tails[bid] = (n, acc)
        return acc

    def suffix(self, start_bid: int):
        """The maintained fold of sealed buckets ``start_bid..newest`` ->
        ``(state, front ids folded, back ids folded)``, or ``None`` when
        ``start_bid`` is not a stacked id.  Tree shape: right fold over the
        front leg + left fold over the back leg."""
        o = self._owner
        for j, (bid, _raw, sfx) in enumerate(self.front):
            if bid == start_bid:
                front_ids = tuple(e[0] for e in self.front[j:])
                back_ids = tuple(e[0] for e in self.back)
                if not self.back:
                    return sfx, front_ids, back_ids
                cached = self._combined.get(bid)
                if cached is not None and cached[0] == len(self.back):
                    return cached[1], front_ids, back_ids
                tail = self._back_tail(0)
                o._agg_query_merges += 1
                st = o._merge_states(sfx, tail)
                self._combined[bid] = (len(self.back), st)
                return st, front_ids, back_ids
        for t, (bid, _raw) in enumerate(self.back):
            if bid == start_bid:
                return (
                    self._back_tail(t), (),
                    tuple(e[0] for e in self.back[t:]),
                )
        return None


class WindowedSketch:
    """Per-tenant ring of time-slice bucket sketches with a coarsening
    ladder (the module docstring has the design).

    ``spec``/``**kwargs`` select the backend as
    :func:`sketches_tpu_torch.backends.facade_for` does; ``device`` places
    the ring (the card by default, ``"cpu"`` for the CPU).  Passing
    ``mesh``/``value_axis``/``stream_axis`` backs the live bucket with a
    mesh-sharded ``DistributedDDSketch`` (dense only); frozen buckets are
    topology-free folded states on the mesh's first device, so they survive
    :meth:`reshard` untouched.

    Failure modes: ``SKETCHES_TPU_WINDOWED=0`` raises ``SpecError`` at
    construction; ``collapse_levels`` on a non-``uniform_collapse`` backend
    raises ``SpecError``; :meth:`merge` across unequal specs or configs
    raises ``UnequalSketchParametersError``; :meth:`reshard` of a ring
    without a mesh raises ``SpecError``; empty windows answer NaN; an
    injected torn rotation raises ``InjectedFault`` with the ring unchanged.
    """

    def __init__(
        self,
        n_streams: int,
        *,
        spec: Optional[SketchSpec] = None,
        config: Optional[WindowConfig] = None,
        clock: Optional[Callable[[], float]] = None,
        mesh=None,
        value_axis=None,
        stream_axis=None,
        engine: str = "auto",
        device=None,
        **kwargs,
    ):
        if not registry.enabled(registry.WINDOWED):
            raise SpecError(
                "time-windowed sketches are disabled"
                " (SKETCHES_TPU_WINDOWED=0): refusing to construct a"
                " WindowedSketch rather than silently serving"
                " unwindowed answers"
            )
        self.config = config or DEFAULT_LADDER
        if spec is None:
            backend = kwargs.pop("backend", "dense")
            spec = SketchSpec(backend=backend, **kwargs)
            kwargs = {}
        self.spec = spec
        self._n_streams = int(n_streams)
        self._clock = clock if clock is not None else telemetry.clock
        if self.config.collapse_levels is not None:
            if spec.backend != "uniform_collapse":
                raise SpecError(
                    "collapse_levels need backend='uniform_collapse';"
                    f" got {spec.backend!r}"
                )
            if max(self.config.collapse_levels) > spec.max_collapses:
                raise SpecError(
                    "collapse_levels exceed spec.max_collapses"
                    f" ({max(self.config.collapse_levels)} >"
                    f" {spec.max_collapses})"
                )
        self._distributed = (
            mesh is not None or value_axis is not None or stream_axis is not None
        )
        self._engine = engine
        self._mesh = mesh
        self._dist_axes = (value_axis, stream_axis)
        self._device_arg = device
        self._live = self._make_live()
        self._live_id: Optional[int] = None
        self._live_mass = 0.0
        self._rungs: List[Dict[int, _Bucket]] = [{} for _ in range(self.config.n_rungs)]
        self._total = 0.0
        self._retired = 0.0
        self._rotations = 0
        self._ladder_collapses = 0
        self._cur: Optional[int] = None
        self._version = 0  # bumped on every content change (live fp cache)
        self._live_fp: Optional[Tuple[int, np.ndarray]] = None
        # -- maintained two-stacks window aggregates (derived state) --
        self._agg_enabled = registry.enabled(registry.WINDOW_AGG)
        self._agg_stacks: Optional[List[_TwoStacks]] = (
            [_TwoStacks(self, r) for r in range(self.config.n_rungs)]
            if self._agg_enabled else None
        )
        self._agg_maint_merges = 0
        self._agg_query_merges = 0
        self._agg_reuse = 0
        self._agg_rebuilds = 0
        # (digest, folded state, component states, fold mode, decode facade
        # or None): the per-plan-digest folded-window cache; derived, never
        # serialized.
        self._agg_fold_cache: Optional[Tuple[bytes, Any, Tuple, str, Any]] = None

    # -- construction helpers ---------------------------------------------

    def _make_live(self):
        if self._distributed:
            from sketches_tpu_torch.parallel import DistributedDDSketch

            value_axis, stream_axis = self._dist_axes
            if self._mesh is None and value_axis is None and stream_axis is None:
                value_axis = "values"
            return DistributedDDSketch(
                self._n_streams, mesh=self._mesh, value_axis=value_axis,
                stream_axis=stream_axis, spec=self.spec, engine=self._engine,
            )
        from sketches_tpu_torch.backends import facade_for

        return facade_for(
            self._n_streams, spec=self.spec, engine=self._engine, device=self._device_arg
        )

    @property
    def device(self) -> torch.device:
        """Where the ring's states live: the live facade's device (a mesh's
        first device for a mesh-backed ring)."""
        if self._distributed:
            return self._live.mesh.devices[0]
        return self._live.device

    def _reset_live(self) -> None:
        """Empty the live bucket's facade (a state swap; a mesh-backed live
        bucket rebuilds on its current mesh)."""
        if self._distributed:
            self._live = self._make_live()
            return
        self._live.state = self._empty_state()
        if hasattr(self._live, "_auto_recenter_pending"):
            # A fresh bucket re-centres its window on its first batch,
            # exactly like a fresh facade would.
            self._live._auto_recenter_pending = True

    def _set_live_state(self, state) -> None:
        """Assign merged content to the live bucket (merge and restore
        paths).  The facade gets its own tensors: the port's ingest may
        update a live state in place."""
        if self._distributed:
            from sketches_tpu_torch.parallel import DistributedDDSketch

            value_axis, stream_axis = self._dist_axes
            self._live = DistributedDDSketch.from_merged_state(
                state, self.spec, mesh=self._mesh,
                value_axis=value_axis or "values",
                stream_axis=stream_axis, engine=self._engine,
            )
            return
        self._live.state = state

    def _snapshot_state(self, state):
        """Freeze a bucket state for the ring.  A mesh-backed ring keeps a
        copy of the fold on the mesh's first device (frozen buckets are
        topology-free and must survive reshard); host facades pass through
        (their states are single-device already)."""
        if not self._distributed:
            return state
        return _map_state(state, torch.clone)

    def _empty_state(self):
        dev = self.device
        if self.spec.backend == "uniform_collapse":
            from sketches_tpu_torch.backends import uniform

            return uniform.init(self.spec, self._n_streams, dev)
        if self.spec.backend == "moment":
            from sketches_tpu_torch.backends import moment

            return moment.init(self.spec, self._n_streams, dev)
        return batched.init(self.spec, self._n_streams, dev)

    def _merge_states(self, a, b):
        """Functional backend merge of two bucket states.  Dense operands
        sharing one per-stream window merge elementwise; drifted windows
        take ``merge_aligned``."""
        return _merge_fn(self.spec, _plan_aligned(self.spec, (a, b)))(a, b)

    # -- time arithmetic ---------------------------------------------------

    def _id_at(self, rung: int, now: float) -> int:
        return int(math.floor(now / self.config.slices_s[rung]))

    def _interval(self, rung: int, bucket_id: int) -> Tuple[float, float]:
        s = self.config.slices_s[rung]
        return bucket_id * s, (bucket_id + 1) * s

    # -- maintained two-stacks aggregates (derived state) ------------------

    def _seal_cutoff(self, rung: int, now: float) -> int:
        """Bucket ids of ``rung`` below this can never receive another
        retirement merge: they are *sealed* and may enter the stacks.
        Rung 0's frozen buckets seal when they freeze; a coarser bucket
        seals once every finer constituent slice has retired past rung
        ``rung - 1``'s floor (``(bid + 1) * ratio <= floor``)."""
        if rung == 0:
            return self._id_at(0, now)
        floor_finer = self._id_at(rung - 1, now) - self.config.lengths[rung - 1] + 1
        ratio = round(self.config.slices_s[rung] / self.config.slices_s[rung - 1])
        return floor_finer // ratio

    def _agg_invalidate(self) -> None:
        """Drop the maintained stacks (ring merge, restore, torn sync): the
        next plan rebuilds them lazily with zero upfront merges."""
        if self._agg_enabled:
            self._agg_stacks = None
            self._agg_fold_cache = None

    def _agg_sync(self, now: float) -> None:
        """Bring the per-rung stacks up to date with the ring: push newly
        sealed buckets, evict retired ones.  Runs after the rotation commit
        (and at plan time).  Any failure, the injected ``window.stack_torn``
        tear included, drops the stacks (rebuilt lazily) and is recorded in
        the health ledger: a query can get slower, never wrong."""
        if not self._agg_enabled:
            return
        try:
            if faults._ACTIVE:
                faults.inject(faults.WINDOW_STACK_TORN)
            if self._agg_stacks is None:
                self._agg_stacks = [_TwoStacks(self, r) for r in range(self.config.n_rungs)]
                self._agg_rebuilds += 1
                if telemetry._ACTIVE:
                    telemetry.counter_inc("window.agg_rebuilds")
            for r, stack in enumerate(self._agg_stacks):
                cutoff = self._seal_cutoff(r, now)
                sealed = sorted(bid for bid in self._rungs[r] if bid < cutoff)
                cur_ids = stack.ids()
                if cur_ids == sealed:
                    continue
                sealed_set = set(sealed)
                gone = [b for b in cur_ids if b not in sealed_set]
                keep = cur_ids[len(gone):]
                if cur_ids[: len(gone)] == gone and sealed[: len(keep)] == keep:
                    for bid in gone:
                        stack.evict(bid)
                    for bid in sealed[len(keep):]:
                        stack.push(bid, self._rungs[r][bid].state)
                else:
                    # Non-incremental drift: rebuild this rung's stack.
                    fresh = _TwoStacks(self, r)
                    for bid in sealed:
                        fresh.push(bid, self._rungs[r][bid].state)
                    self._agg_stacks[r] = fresh
                    self._agg_rebuilds += 1
                    if telemetry._ACTIVE:
                        telemetry.counter_inc("window.agg_rebuilds")
        except Exception as e:  # noqa: BLE001 - derived state must degrade
            self._agg_stacks = None
            bump("window.stack_torn")
            record_downgrade(
                "windows.agg", "two-stacks", "rebuild",
                reason=f"stack sync torn: {e!r}",
            )

    def _agg_assemble(self, covered):
        """The maintained-component list of a covered-bucket plan ->
        ``(components, recipes)``, or ``(None, None)`` without stacks.

        Component order is pinned: rungs coarsest to finest (per rung one
        maintained sealed aggregate when the covered sealed ids form the
        stack's newest suffix, then the absorbing raw buckets in id order),
        the live bucket last.  Each recipe names the ``covered`` indices its
        component folds, so the oracle replays the association."""
        stacks = self._agg_stacks
        if stacks is None:
            return None, None
        components: List[Any] = []
        recipes: List[Tuple] = []
        by_rung: Dict[int, List[int]] = {}
        live_idx: Optional[int] = None
        for i, (r, _bid, _st, b) in enumerate(covered):
            if b is None:
                live_idx = i
            else:
                by_rung.setdefault(r, []).append(i)
        for r in sorted(by_rung, reverse=True):
            stack = stacks[r]
            stacked = set(stack.ids())
            sealed = [i for i in by_rung[r] if covered[i][1] in stacked]
            loose = [i for i in by_rung[r] if covered[i][1] not in stacked]
            if sealed:
                ids_cov = [covered[i][1] for i in sealed]
                sids = stack.ids()
                hit = None
                if sids[-len(ids_cov):] == ids_cov:
                    before = self._agg_maint_merges + self._agg_query_merges
                    hit = stack.suffix(ids_cov[0])
                if hit is not None:
                    state, front_ids, back_ids = hit
                    if before == self._agg_maint_merges + self._agg_query_merges:
                        self._agg_reuse += 1
                        if telemetry._ACTIVE:
                            telemetry.counter_inc("window.agg_reuse")
                    idx_of = {covered[i][1]: i for i in sealed}
                    components.append(state)
                    recipes.append((
                        "fold", r,
                        tuple(idx_of[b] for b in front_ids),
                        tuple(idx_of[b] for b in back_ids),
                    ))
                else:
                    # Covered sealed ids are not the stack's newest suffix
                    # (a window ending in the past): raw buckets instead.
                    loose = sealed + loose
            for i in sorted(loose, key=lambda i: covered[i][1]):
                components.append(covered[i][2])
                recipes.append(("raw", i))
        if live_idx is not None:
            components.append(covered[live_idx][2])
            recipes.append(("raw", live_idx))
        return tuple(components), tuple(recipes)

    def _agg_fold(self, plan: "WindowPlan"):
        """Fold a maintained-component plan to ONE state, cached by the
        plan digest (which hashes every covered ``(rung, id, fingerprint)``,
        so a stale entry can only miss).  A hit is a repeat query on an
        unchanged window: zero merges.  The fold reuses the per-mode
        fold-to-state chains, so the tree shape, and with it the bit-exact
        answer, is the fold-and-decode path's."""
        states = plan.components
        if len(states) == 1:
            return states[0]
        cached = self._agg_fold_cache
        if cached is not None and cached[0] == plan.digest:
            self._agg_reuse += 1
            if telemetry._ACTIVE:
                telemetry.counter_inc("window.agg_reuse")
            return cached[1]
        mode = _fold_mode(self.spec, states)
        folded = _fold_state_for(self.spec)[mode](states)
        self._agg_query_merges += len(states) - 1
        if telemetry._ACTIVE:
            telemetry.counter_inc("window.query_merges", float(len(states) - 1))
        self._agg_fold_cache = (
            plan.digest, folded, states, mode, self._agg_decode_facade(folded),
        )
        return folded

    def _agg_decode_facade(self, folded):
        """Wrap a folded dense window state in a throwaway facade, so a
        fold-cache hit decodes through the facade's query ladder (the
        occupied-window plans a plain facade pays; the overlap kernel on
        the card) instead of the full-width decode.  The tiers answer
        alike, so bit-identity to the oracle is unchanged.  The facade
        wraps the state where it lies, without re-centring or copying it.
        Non-dense and mesh-backed rings get None."""
        if self.spec.backend != "dense" or self._distributed:
            return None
        return batched.BatchedDDSketch(self._n_streams, spec=self.spec, state=folded)

    def _agg_corrupt(self, flips) -> bool:
        """Apply ``window.agg_stale`` flip coordinates to the first cached
        maintained aggregate (raw bucket states stay clean: only the
        stack-consistency audit can catch it), the folded-window cache
        first.  Returns whether anything was corrupted; moment states carry
        no bin stores, so the site no-ops there."""
        if not flips or self._agg_stacks is None or self.spec.backend == "moment":
            return False

        def corrupt(st):
            if self.spec.backend == "uniform_collapse":
                return dataclasses.replace(
                    st, base=faults.apply_state_bitflips(st.base, flips)
                )
            return faults.apply_state_bitflips(st, flips)

        if self._agg_fold_cache is not None:
            digest, folded, states, mode, _fac = self._agg_fold_cache
            bad = corrupt(folded)
            # Rebuild the decode facade around the corrupted state so the
            # corruption stays query-visible, not just audit-visible.
            self._agg_fold_cache = (digest, bad, states, mode, self._agg_decode_facade(bad))
            return True
        for stack in self._agg_stacks:
            if stack._combined:
                bid, (n, st) = sorted(stack._combined.items())[0]
                stack._combined[bid] = (n, corrupt(st))
                return True
            if stack._tails:
                bid, (n, st) = sorted(stack._tails.items())[0]
                stack._tails[bid] = (n, corrupt(st))
                return True
            if stack.front:
                bid, raw, sfx = stack.front[0]
                stack.front[0] = (bid, raw, corrupt(sfx))
                return True
        return False

    def _agg_audit(self) -> List[str]:
        """Stack-consistency audit: recompute every CACHED maintained
        aggregate from its raw states through the same merge tree and
        compare leaf for leaf, exactly, on the device (a clean cache matches
        bit for bit).  Returns violation details; disabled or dropped stacks
        audit clean.  Never mutates the ring."""
        out: List[str] = []
        if not self._agg_enabled or self._agg_stacks is None:
            return out

        def mismatch(expect, got) -> bool:
            ea, ga = _leaves(expect), _leaves(got)
            return len(ea) != len(ga) or any(
                not torch.equal(x, y) for x, y in zip(ea, ga)
            )

        for stack in self._agg_stacks:
            r = stack.rung
            # Front suffixes: suffix[j] == right fold of front raws [j:].
            acc = None
            for bid, raw, sfx in reversed(stack.front):
                acc = raw if acc is None else self._merge_states(raw, acc)
                if mismatch(acc, sfx):
                    out.append(
                        f"rung {r} front suffix @{bid} diverges from its raw right-fold"
                    )
            # Back tails: _tails[bid] == left fold of back raws from bid.
            back_pos = {b: t for t, (b, _s) in enumerate(stack.back)}
            for bid, (n, st) in sorted(stack._tails.items()):
                t = back_pos.get(bid)
                if t is None or t + n > len(stack.back):
                    out.append(f"rung {r} back tail @{bid} orphaned")
                    continue
                acc = stack.back[t][1]
                for i in range(t + 1, t + n):
                    acc = self._merge_states(acc, stack.back[i][1])
                if mismatch(acc, st):
                    out.append(f"rung {r} back tail @{bid} diverges from its raw left-fold")
            # Combined: _combined[bid] == suffix(bid) + left fold of the
            # first ``n`` back raws.
            front_pos = {b: j for j, (b, _r, _s) in enumerate(stack.front)}
            for bid, (n, st) in sorted(stack._combined.items()):
                j = front_pos.get(bid)
                if j is None or n > len(stack.back) or n < 1:
                    out.append(f"rung {r} combined @{bid} orphaned")
                    continue
                acc = None
                for _fbid, raw, _s in reversed(stack.front[j:]):
                    acc = raw if acc is None else self._merge_states(raw, acc)
                tail = stack.back[0][1]
                for i in range(1, n):
                    tail = self._merge_states(tail, stack.back[i][1])
                if mismatch(self._merge_states(acc, tail), st):
                    out.append(f"rung {r} combined @{bid} diverges from its raw fold")
        cache = self._agg_fold_cache
        if cache is not None:
            _digest, folded, comp_states, mode, _fac = cache
            if mismatch(_fold_state_for(self.spec)[mode](comp_states), folded):
                out.append("folded-window cache diverges from its component re-fold")
        return out

    def agg_stats(self) -> Dict[str, float]:
        """The maintained-aggregate scoreboard: whether the layer is on,
        merges spent maintaining the stacks, merges spent answering
        queries, component reuses, and stack rebuilds."""
        return {
            "enabled": float(self._agg_enabled),
            "maintenance_merges": float(self._agg_maint_merges),
            "query_merges": float(self._agg_query_merges),
            "reuse": float(self._agg_reuse),
            "rebuilds": float(self._agg_rebuilds),
        }

    # -- rotation ----------------------------------------------------------

    def _roll(self, now: float) -> None:
        """Advance the ring to ``now``: freeze an aged-out live bucket,
        cascade retirements down the ladder, drop mass off the last rung.
        Plans functionally, injects ``window.rotate_torn``, then commits by
        reference swap: a tear mutates nothing."""
        cur = self._id_at(0, now)
        if cur == self._cur and (self._live_id is None or self._live_id == cur):
            return
        freeze = self._live_id is not None and self._live_id != cur
        new_rungs = [dict(r) for r in self._rungs]
        rotations = 0
        collapses = 0
        retired = 0.0
        if freeze:
            state = self._snapshot_state(self._live.state)
            new_rungs[0][self._live_id] = _Bucket(
                rung=0, id=self._live_id, state=state, mass=self._live_mass,
            )
            rotations += 1
        # Cascade: rung r keeps its newest ``lengths[r]`` slices; older
        # buckets fold into the coarser bucket covering their interval.
        levels = self.config.collapse_levels
        for r in range(self.config.n_rungs):
            cur_r = self._id_at(r, now)
            floor_id = cur_r - self.config.lengths[r] + 1
            for bid in sorted(new_rungs[r]):
                if bid >= floor_id:
                    continue
                b = new_rungs[r].pop(bid)
                if r + 1 >= self.config.n_rungs:
                    retired += b.mass
                    continue
                state = b.state
                if levels is not None and levels[r + 1] > 0:
                    from sketches_tpu_torch.backends import uniform

                    state = uniform.collapse_to(
                        self.spec, state,
                        torch.clamp(state.level, min=levels[r + 1]),
                    )
                    collapses += 1
                start, _ = self._interval(r, bid)
                tgt = self._id_at(r + 1, start)
                existing = new_rungs[r + 1].get(tgt)
                if existing is None:
                    new_rungs[r + 1][tgt] = _Bucket(
                        rung=r + 1, id=tgt, state=state, mass=b.mass
                    )
                else:
                    new_rungs[r + 1][tgt] = _Bucket(
                        rung=r + 1, id=tgt,
                        state=self._merge_states(existing.state, state),
                        mass=existing.mass + b.mass,
                    )
        if faults._ACTIVE:
            # Everything above is functional (new dicts, new states);
            # nothing observable has mutated, so a tear here proves
            # rotation atomicity.
            faults.inject(faults.WINDOW_ROTATE_TORN)
        # -- commit (reference swaps only) --
        self._rungs = new_rungs
        if freeze:
            self._reset_live()
            self._live_id = None
            self._live_mass = 0.0
        self._cur = cur
        self._rotations += rotations
        self._ladder_collapses += collapses
        self._retired += retired
        self._version += 1
        self._live_fp = None
        # Content moved between buckets: the plan digest moves and the
        # folded-window cache could only miss.
        self._agg_fold_cache = None
        if telemetry._ACTIVE:
            if rotations:
                telemetry.counter_inc("window.rotations", float(rotations))
            if collapses:
                telemetry.counter_inc("window.ladder_collapses", float(collapses))
            if retired:
                telemetry.counter_inc("window.retired_mass", retired)
        # Stacks sync strictly after the commit: a torn rotation never sees
        # half-updated aggregates.
        self._agg_sync(now)

    # -- write path --------------------------------------------------------

    def add(self, values, weights=None) -> "WindowedSketch":
        """Ingest ``values[n_streams, S]`` into the current slice's bucket;
        returns self.

        Rotates first (the clock picks the bucket), then rides the backend
        facade's ingest unchanged (its engine ladder, degradations and
        refusals).  The exact batch mass lands in the bucket's ledger entry.
        """
        now = self._clock()
        self._roll(now)
        if self._live_id is None:
            self._live_id = self._id_at(0, now)
        self._live.add(values, weights)
        mass = _batch_mass(self.spec, values, weights)
        self._live_mass += mass
        self._total += mass
        self._version += 1
        self._live_fp = None
        # Ingest moves the plan digest (and may update the live tensors in
        # place): a cached folded window is dead and unsafe to re-audit.
        self._agg_fold_cache = None
        return self

    def merge(self, other: "WindowedSketch") -> "WindowedSketch":
        """Fold another windowed ring into this one (same spec, same ladder,
        clock-aligned bucket ids): every bucket merges with its same-id twin
        through the backend merge algebra, ledgers add exactly.  Unequal
        specs or configs raise ``UnequalSketchParametersError``."""
        if other.spec != self.spec or other.config != self.config:
            raise UnequalSketchParametersError(
                "cannot merge windowed sketches with different specs or"
                " ladder configs"
            )
        for r in range(self.config.n_rungs):
            for bid, b in sorted(other._rungs[r].items()):
                mine = self._rungs[r].get(bid)
                if mine is None:
                    self._rungs[r][bid] = _Bucket(rung=r, id=bid, state=b.state, mass=b.mass)
                else:
                    self._rungs[r][bid] = _Bucket(
                        rung=r, id=bid,
                        state=self._merge_states(mine.state, b.state),
                        mass=mine.mass + b.mass,
                    )
        if other._live_id is not None:
            if self._live_id is None:
                self._live_id = other._live_id
                # A copy: this ring's ingest may update it in place.
                self._set_live_state(_map_state(other._live.state, torch.clone))
                self._live_mass = other._live_mass
            elif self._live_id == other._live_id:
                self._set_live_state(
                    self._merge_states(self._live.state, other._live.state)
                )
                self._live_mass += other._live_mass
            else:
                # Different current slices: the other's live bucket is
                # frozen history from this ring's point of view.
                self._rungs[0][other._live_id] = _Bucket(
                    rung=0, id=other._live_id,
                    state=_map_state(other._live.state, torch.clone),
                    mass=other._live_mass,
                )
        self._total += other._total
        self._retired += other._retired
        self._version += 1
        self._live_fp = None
        # A ring merge rewrites sealed states: the stacks hold stale
        # references, drop and rebuild.
        self._agg_invalidate()
        return self

    def reshard(self, mesh=None, n_devices: Optional[int] = None, *, live_mask=None):
        """Resize a mesh-backed live bucket live -> its ``ReshardReport``;
        frozen buckets are topology-free and survive untouched.

        Raises ``SpecError`` for a ring without a mesh; a torn reshard
        (injected) raises and leaves the live fleet as it was.  Mass of dead
        shards is subtracted from the live bucket's ledger entry and from
        ``total_mass`` exactly.
        """
        if not self._distributed:
            raise SpecError(
                "reshard needs a mesh-backed WindowedSketch (pass"
                " mesh=/value_axis= at construction)"
            )
        new_facade, report = self._live.reshard(
            mesh=mesh, n_devices=n_devices, live_mask=live_mask
        )
        self._live = new_facade
        self._mesh = new_facade.mesh
        if report.n_dead:
            dropped = float(np.asarray(report.dropped_count, np.float64).sum())
            self._live_mass -= dropped
            self._total -= dropped
        self._version += 1
        self._live_fp = None
        return report

    # -- read path ---------------------------------------------------------

    def _covered(
        self, window_s: Optional[float], now: float
    ) -> List[Tuple[int, int, Any, Optional[_Bucket]]]:
        """Buckets whose slice intersects ``[now - W, now)`` in (start time,
        rung) order -> ``(rung, id, state, bucket or None for live)``."""
        t0 = -math.inf if window_s is None else now - float(window_s)
        out = []
        for r in range(self.config.n_rungs):
            for bid, b in self._rungs[r].items():
                start, end = self._interval(r, bid)
                if end > t0 and start <= now:
                    out.append((start, r, bid, b.state, b))
        if self._live_id is not None:
            # ``start <= now``: data ingested "right now" is always part
            # of "the last W seconds", also exactly on a slice boundary.
            start, end = self._interval(0, self._live_id)
            if end > t0 and start <= now:
                out.append((
                    start, 0, self._live_id,
                    self._snapshot_state(self._live.state), None,
                ))
        out.sort(key=lambda e: (e[0], e[1]))
        return [(r, bid, st, b) for _, r, bid, st, b in out]

    def _bucket_fp(self, bucket: Optional[_Bucket], state) -> np.ndarray:
        if bucket is not None:
            if bucket.fp is None:
                bucket.fp = integrity.fingerprint(self.spec, bucket.state)
            return bucket.fp
        cached = self._live_fp
        if cached is not None and cached[0] == self._version:
            return cached[1]
        fp = integrity.fingerprint(self.spec, state)
        self._live_fp = (self._version, fp)
        return fp

    def window_plan(self, window_s: Optional[float] = None) -> WindowPlan:
        """Resolve a window query: rotate, select the covered buckets and
        derive the fingerprint-set digest -> a :class:`WindowPlan`.

        The digest (the serving cache's key) hashes every covered ``(rung,
        id, fingerprint)``, so a rotation, an ingest or any content change
        moves it: a stale cache entry can only miss.  An empty coverage
        yields a plan whose query answers NaN.
        """
        now = self._clock()
        self._roll(now)
        components = recipes = None
        if self._agg_enabled:
            self._agg_sync(now)  # rebuild if dropped; no-op when current
            if faults._ACTIVE:
                flips = faults.agg_stale_flips(
                    self._n_streams, getattr(self.spec, "n_bins", 1)
                )
                if flips:
                    self._agg_corrupt(flips)
        covered = self._covered(window_s, now)
        if self._agg_enabled:
            components, recipes = self._agg_assemble(covered)
        fps = [self._bucket_fp(b, st) for (_, _, st, b) in covered]
        h = hashlib.sha256()
        h.update(b"window")
        for (r, bid, _, _), fp in zip(covered, fps):
            h.update(np.int64(r).tobytes())
            h.update(np.int64(bid).tobytes())
            h.update(np.ascontiguousarray(fp).tobytes())
        fingerprint = (
            np.concatenate([np.atleast_1d(f) for f in fps])
            if fps else np.zeros((0,), np.float64)
        )
        if telemetry._ACTIVE:
            telemetry.gauge_set("window.covered_buckets", float(len(covered)))
        return WindowPlan(
            window_s=window_s,
            now=now,
            keys=tuple((r, bid) for r, bid, _, _ in covered),
            states=tuple(st for _, _, st, _ in covered),
            fingerprint=fingerprint,
            digest=h.digest(),
            components=components,
            recipes=recipes,
        )

    def query_plan(self, plan: WindowPlan, quantiles: Sequence[float]):
        """Answer ``quantiles`` over a resolved :class:`WindowPlan` ->
        ``[n_streams, Q]`` (NaN for empty coverage or empty streams): a
        tensor on the ring's device, or numpy (empty coverage, moment).
        The plan's states are frozen references, so a rotation between
        planning and dispatch cannot change the answer."""
        qs = tuple(float(q) for q in quantiles)
        if not plan.states:
            return np.full((self._n_streams, len(qs)), np.nan, np.float32)
        states = plan.states
        if plan.components is not None:
            # Maintained-aggregate path: fold the O(1) components once per
            # plan digest, then decode the single folded state; a repeat
            # query on an unchanged window hits the fold cache (zero
            # merges) and, dense, rides the cached facade's query ladder.
            folded = self._agg_fold(plan)
            cache = self._agg_fold_cache
            if cache is not None and cache[0] == plan.digest and cache[4] is not None:
                return cache[4].get_quantile_values(qs)
            return _quantile_for(self.spec)(folded, qs)
        mode = _fold_mode(self.spec, states)
        return _fold_for(self.spec)[mode](states, qs)

    def quantile(self, quantiles: Sequence[float], window: Optional[float] = None):
        """``quantile(qs, window=W)``: the window query -> ``[n_streams,
        Q]``.  ``window=None`` covers the whole retained horizon.
        Bit-identical to :func:`oracle_quantile`; empty windows and streams
        answer NaN."""
        return self.query_plan(self.window_plan(window), quantiles)

    def get_quantile_values(self, quantiles: Sequence[float]):
        """Facade-parity alias: the full-horizon query -> ``[n_streams,
        Q]``."""
        return self.quantile(quantiles, window=None)

    # -- introspection -----------------------------------------------------

    @property
    def n_streams(self) -> int:
        return self._n_streams

    @property
    def total_mass(self) -> float:
        """Exact mass ever ingested (minus reshard-dropped mass); equals the
        live ledger plus ``retired_mass``, the invariant
        :func:`sketches_tpu_torch.integrity.check_window` holds with
        ``==``."""
        return self._total

    @property
    def retired_mass(self) -> float:
        """Exact mass dropped off the last ladder rung."""
        return self._retired

    def buckets(self) -> List[Tuple[int, int, float]]:
        """The live ledger: ``(rung, bucket id, exact mass)`` per bucket
        (the current ingest bucket included), sorted.  Empty before the
        first ingest."""
        out = [
            (r, bid, b.mass)
            for r in range(self.config.n_rungs)
            for bid, b in sorted(self._rungs[r].items())
        ]
        if self._live_id is not None:
            out.append((0, self._live_id, self._live_mass))
        return sorted(out, key=lambda e: (e[0], e[1]))

    def ledger(self) -> Dict[str, float]:
        """The mass ledger summary: ``total`` (ever ingested), ``live`` (the
        bucket entries' sum), ``retired``, ``rotations``,
        ``ladder_collapses``.  The exact invariant is ``total == live +
        retired``."""
        live = sum(m for _, _, m in self.buckets())
        return {
            "total": self._total,
            "live": live,
            "retired": self._retired,
            "rotations": float(self._rotations),
            "ladder_collapses": float(self._ladder_collapses),
        }

    def rung_effective_alpha(self) -> List[float]:
        """Each rung's declared accuracy: ``effective_alpha`` at the rung's
        collapse level (``uniform_collapse`` with collapse levels), the
        spec's alpha everywhere otherwise."""
        if (
            self.spec.backend == "uniform_collapse"
            and self.config.collapse_levels is not None
        ):
            from sketches_tpu_torch.backends.uniform import effective_alpha

            return [
                float(effective_alpha(self.spec, torch.tensor(level, dtype=torch.int32)))
                for level in self.config.collapse_levels
            ]
        return [self.spec.relative_accuracy for _ in range(self.config.n_rungs)]

    def device_masses(self) -> Dict[Tuple[int, int], float]:
        """Per-bucket device-side mass (each state's ``count`` summed in
        f64 on the host), the audit-side twin of :meth:`buckets`.  Fetches
        one count vector a bucket; an empty ring returns ``{}``."""
        out: Dict[Tuple[int, int], float] = {}

        def mass(count) -> float:
            return float(count.cpu().numpy().astype(np.float64).sum())

        for r in range(self.config.n_rungs):
            for bid, b in self._rungs[r].items():
                out[(r, bid)] = mass(b.state.count)
        if self._live_id is not None:
            out[(0, self._live_id)] = mass(self._live.count)
        return out

    def __repr__(self) -> str:
        rungs = [f"{s:g}s x {n}" for s, n in zip(self.config.slices_s, self.config.lengths)]
        return (
            f"WindowedSketch(n_streams={self._n_streams},"
            f" backend={self.spec.backend!r}, rungs={rungs},"
            f" live_buckets={len(self.buckets())},"
            f" total_mass={self._total:g}, device={self.device})"
        )


def _map_state(state, fn):
    """A backend state with ``fn`` applied to every tensor leaf."""
    return dataclasses.replace(
        state,
        **{
            f.name: (
                _map_state(getattr(state, f.name), fn)
                if dataclasses.is_dataclass(getattr(state, f.name))
                else fn(getattr(state, f.name))
            )
            for f in dataclasses.fields(state)
        },
    )


def oracle_quantile(
    wsk: WindowedSketch,
    quantiles: Sequence[float],
    window: Optional[float] = None,
):
    """The host-driven oracle: merge the covered buckets one pair at a time
    with the backend's own merge, then decode -> ``[n_streams, Q]``.

    The window query must be bit-identical to this.  On the maintained
    path the oracle replays the plan's recipes from the raw covered states
    (right fold over each sealed front leg, left fold over each back leg,
    then the component chain), the association the two-stacks layer
    maintains.  The merged state decodes through the plain
    ``batched.quantile`` (``uniform.quantile`` for adaptive buckets, the
    host solve for moment ones), as the JAX oracle decodes through XLA, so
    the oracle shares no kernel with the query it checks: on the card a
    window answer equal to it shows the kernels equal to the plain version.
    Empty coverage answers NaN; the ring changes only by the rotation the
    query itself would perform.
    """
    plan = wsk.window_plan(window)
    qs = tuple(float(q) for q in quantiles)
    if not plan.states:
        return np.full((wsk.n_streams, len(qs)), np.nan, np.float32)
    spec = wsk.spec
    if plan.recipes is not None:
        comps = []
        for rcp in plan.recipes:
            if rcp[0] == "raw":
                comps.append(plan.states[rcp[1]])
                continue
            _, _r, front_idx, back_idx = rcp
            acc = None
            for i in reversed(front_idx):  # right fold over the front leg
                st = plan.states[i]
                acc = st if acc is None else wsk._merge_states(st, acc)
            tail = None
            for i in back_idx:  # left fold over the back leg
                st = plan.states[i]
                tail = st if tail is None else wsk._merge_states(tail, st)
            if acc is None:
                comps.append(tail)
            elif tail is None:
                comps.append(acc)
            else:
                comps.append(wsk._merge_states(acc, tail))
        states = tuple(comps)
    else:
        states = plan.states
    if _fold_mode(spec, states) == "aligned":
        # The host-side mode choice the fold makes: aligned dense windows
        # merge elementwise.
        acc = functools.reduce(functools.partial(batched.merge, spec), states)
    else:
        acc = functools.reduce(wsk._merge_states, states)
    if spec.backend == "moment":
        from sketches_tpu_torch.backends import moment

        return moment.quantile(spec, acc, qs)
    if spec.backend == "uniform_collapse":
        from sketches_tpu_torch.backends import uniform

        return uniform.quantile(spec, acc, qs)
    return batched.quantile(spec, acc, qs)
