"""DDSketch control layer: add / get_quantile_value / merge (PyTorch port).

Counterpart of ``sketches_tpu/ddsketch.py`` (parity target: reference
``ddsketch/ddsketch.py``: BaseDDSketch, DDSketch,
LogCollapsingLowestDenseDDSketch, LogCollapsingHighestDenseDDSketch).  A
sketch owns one positive store, one negative store (holding keys of
``-value``) and a scalar ``zero_count``, plus count/min/max/sum bookkeeping.

Accuracy contract: for any quantile q and value stream S,
``|get_quantile_value(q) - exact_quantile(S, q)| <= alpha * |exact|``.
Mergeability contract: ``sketch(A).merge(sketch(B)) == sketch(A + B)`` up to
the same accuracy bound, for sketches with equal mappings.

Backend seam: ``DDSketch(..., backend="torch")`` keeps this API but holds its
bins as a 1-stream slice of the batched device state
(``sketches_tpu_torch.batched``), on the card unless ``device="cpu"`` is
passed (:class:`TorchDDSketch`, the JAX package's ``backend="jax"``).  For
millions of sketches, use ``BatchedDDSketch`` directly.
"""

from __future__ import annotations

import math
import sys
import typing

import numpy as np
import torch

from sketches_tpu_torch import integrity, telemetry
from sketches_tpu_torch.mapping import KeyMapping, LogarithmicMapping, zero_threshold
from sketches_tpu_torch.resilience import (
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)
from sketches_tpu_torch.store import (
    CollapsingHighestDenseStore,
    CollapsingLowestDenseStore,
    DenseStore,
    Store,
)

__all__ = [
    "UnequalSketchParametersError",
    "BaseDDSketch",
    "DDSketch",
    "TorchDDSketch",
    "LogCollapsingLowestDenseDDSketch",
    "LogCollapsingHighestDenseDDSketch",
]

DEFAULT_REL_ACC = 0.01
DEFAULT_BIN_LIMIT = 2048
_F32_TINY = zero_threshold(np.float32)  # the device tier's zero-bucket threshold


class BaseDDSketch:
    """Quantile sketch with relative-error guarantee alpha.

    Reference seam: ``ddsketch/ddsketch.py . BaseDDSketch``.
    """

    def __init__(
        self,
        mapping: KeyMapping,
        store: Store,
        negative_store: Store,
        zero_count: float = 0.0,
    ):
        self._mapping = mapping
        self._store = store
        self._negative_store = negative_store
        self._zero_count = zero_count

        self._relative_accuracy = mapping.relative_accuracy
        self._count = self._zero_count + self._store.count + self._negative_store.count
        self._min = math.inf
        self._max = -math.inf
        self._sum = 0.0

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(count={self._count}, sum={self._sum},"
            f" min={self._min}, max={self._max},"
            f" relative_accuracy={self._relative_accuracy})"
        )

    # -- accessors --------------------------------------------------------
    @property
    def mapping(self) -> KeyMapping:
        return self._mapping

    @property
    def store(self) -> Store:
        return self._store

    @property
    def negative_store(self) -> Store:
        return self._negative_store

    @property
    def zero_count(self) -> float:
        return self._zero_count

    @property
    def count(self) -> float:
        return self._count

    @property
    def num_values(self) -> float:
        return self._count

    @property
    def sum(self) -> float:  # noqa: A003 - reference API name
        return self._sum

    @property
    def avg(self) -> float:
        return self._sum / self._count

    @property
    def relative_accuracy(self) -> float:
        return self._relative_accuracy

    # -- core API ---------------------------------------------------------
    def add(self, val: float, weight: float = 1.0) -> None:
        """Ingest ``val`` with multiplicity ``weight`` (> 0)."""
        if weight <= 0.0:
            raise SketchValueError("weight must be positive")

        if val > self._mapping.min_possible:
            self._store.add(self._mapping.key(val), weight)
        elif val < -self._mapping.min_possible:
            self._negative_store.add(self._mapping.key(-val), weight)
        else:
            self._zero_count += weight

        self._count += weight
        self._sum += val * weight
        if val < self._min:
            self._min = val
        if val > self._max:
            self._max = val

    def get_quantile_value(self, quantile: float) -> typing.Optional[float]:
        """Value at quantile ``q`` in [0, 1], within relative accuracy alpha.

        Returns None for q outside [0, 1] or an empty sketch.
        """
        if quantile < 0 or quantile > 1 or self._count == 0:
            return None

        rank = quantile * (self._count - 1)
        if rank < self._negative_store.count:
            reversed_rank = self._negative_store.count - 1 - rank
            key = self._negative_store.key_at_rank(reversed_rank, lower=False)
            quantile_value = -self._mapping.value(key)
        elif rank < self._zero_count + self._negative_store.count:
            return 0.0
        else:
            key = self._store.key_at_rank(
                rank - self._zero_count - self._negative_store.count
            )
            quantile_value = self._mapping.value(key)
        return quantile_value

    def merge(self, sketch: "BaseDDSketch") -> None:
        """Fold ``sketch`` into self; equivalent to having ingested its stream."""
        if not self.mergeable(sketch):
            raise UnequalSketchParametersError(
                "Cannot merge two DDSketches with different parameters"
            )
        # A torch-backed operand defers its scalar bookkeeping to flush
        # time; settle it before reading the private fields below.
        flush = getattr(sketch, "_flush", None)
        if flush is not None:
            flush()
        if integrity._ACTIVE:
            # Guarded seam: a corrupted operand is caught before it is
            # folded into self (IntegrityError or a report, per the mode).
            integrity.verify(sketch, seam="host.merge.operand")
        if sketch._count == 0:
            return

        # Public accessors, not _store: a torch-backed operand materializes
        # its device bins as host stores through these properties.  An empty
        # self takes the same path (Store.merge re-bins through self's own
        # store type), so merging never swaps in the operand's store class.
        self._store.merge(sketch.store)
        self._negative_store.merge(sketch.negative_store)
        self._zero_count += sketch._zero_count

        self._count += sketch._count
        self._sum += sketch._sum
        if sketch._min < self._min:
            self._min = sketch._min
        if sketch._max > self._max:
            self._max = sketch._max
        if integrity._ACTIVE:
            integrity.verify(self, seam="host.merge")

    def mergeable(self, other: "BaseDDSketch") -> bool:
        """Two sketches are mergeable iff their mappings are identical (same
        type, gamma and offset): the mapping types share gamma at equal
        alpha but key values differently."""
        return self._mapping == other._mapping

    def _copy(self, sketch: "BaseDDSketch") -> None:
        self._store = sketch.store.copy()
        self._negative_store = sketch.negative_store.copy()
        self._zero_count = sketch._zero_count
        self._count = sketch._count
        self._sum = sketch._sum
        self._min = sketch._min
        self._max = sketch._max

    def copy(self) -> "BaseDDSketch":
        new = type(self).__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._copy(self)
        return new


class TorchDDSketch(BaseDDSketch):
    """Single-sketch facade over the device tier: reference API, torch bins.

    The ``backend="torch"`` seam (the JAX package's ``JaxDDSketch``).  Its
    bins are a 1-stream slice of the batched state on ``device`` (the card
    unless ``device="cpu"``).  Scalar ``add`` calls buffer on the host;
    every accessor flushes first, so no counter is observably stale.

    Two flush tiers:

    * **native** (``native.available()``): each flush chunk feeds
      ``NativeDDSketch.add_batch`` on the host, and the accumulated native
      bins lift onto the device state once per query, merge or store view
      (``_settle``), not once per chunk;
    * **device**: without the native engine (no toolchain, or
      ``SKETCHES_TPU_NATIVE=0``), each chunk of ``_FLUSH_CHUNK`` values
      goes to the card through the plain ``batched.add``.

    The device side is the port's plain batched functions (``add``,
    ``recenter``/``auto_offset`` on the first chunk, ``get_quantile_value``,
    ``merge_aligned``), as the JAX facade jits its XLA tier: a 1-stream
    state does not meet ``kernels.supports``' stream alignment.

    Scalar bookkeeping (count/sum/min/max) stays in host float64; bin mass
    lives on the device in float32, exact up to 2**24 a bin.  The native
    buffer keys values with the scalar (f64) mapping path, which may differ
    from the device's f32 ``key_array`` by one bucket at bucket edges (an
    alpha-safe divergence of the two tiers).

    Not a subclass of ``DDSketch``: ``DDSketch.__new__`` returns one of
    these for ``backend="torch"``, and Python then skips
    ``DDSketch.__init__``.

    Failure modes: non-positive weights raise ``SketchValueError``,
    unequal-parameter merges raise ``UnequalSketchParametersError``,
    empty-sketch quantiles return ``None``, no card without
    ``device="cpu"`` raises ``SpecError``.  Mass beyond the static window
    collapses into the edge bins (the collapse counters record it).  A
    native engine that fails to build leaves the device tier in use, with
    the reason in ``native.status()``.
    """

    # Fixed chunk shape: 16k balances per-dispatch cost against first-flush
    # latency; the auto-centre median only improves with a bigger first
    # buffer.
    _FLUSH_CHUNK = 16384

    def __init__(
        self,
        relative_accuracy: typing.Optional[float] = None,
        n_bins: typing.Optional[int] = None,
        mapping: str = "logarithmic",
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        from sketches_tpu_torch import batched
        from sketches_tpu_torch.mapping import mapping_from_name

        if relative_accuracy is None:
            relative_accuracy = DEFAULT_REL_ACC
        self._spec = batched.SketchSpec(
            relative_accuracy=relative_accuracy,
            mapping_name=mapping,
            n_bins=DEFAULT_BIN_LIMIT if n_bins is None else n_bins,
            key_offset=key_offset,
        )
        self._device = batched.resolve_device(device)
        self._mapping = mapping_from_name(mapping, relative_accuracy)
        self._relative_accuracy = relative_accuracy
        self._state = batched.init(self._spec, 1, self._device)
        # The first flush centres the window on the data unless the caller
        # pinned it (an explicit key_offset is a deliberate window choice).
        self._auto_center_pending = key_offset is None
        self._pending_vals: list = []
        self._pending_weights: list = []
        self._host_cache: typing.Optional[BaseDDSketch] = None
        # Native flush buffer: None when the engine is unavailable (device
        # tier) or until the first flush establishes the window.
        self._native_acc = None
        self._use_native = self._native_available()
        # The established window's low edge, known on the host once the
        # first flush (or a merge into an empty self) fixes it; the native
        # buffer shares the device window so clamp-to-edge collapse agrees.
        self._window_offset: typing.Optional[int] = (
            None if key_offset is None else int(self._spec.key_offset)
        )
        self._zero_count = 0.0
        self._count = 0.0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @staticmethod
    def _native_available() -> bool:
        from sketches_tpu_torch import native

        return native.available()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def flush_tier(self) -> str:
        """``"native"`` when flush chunks feed the native engine, else
        ``"device"``."""
        return "native" if self._use_native else "device"

    # -- device side ---------------------------------------------------------
    def _device_chunk(self, values: np.ndarray, weights: np.ndarray) -> None:
        """One ``[1, _FLUSH_CHUNK]`` f32 chunk (zero-weight padding is
        inert) into the device state; the first one centres the window."""
        from sketches_tpu_torch import batched

        spec, st = self._spec, self._state
        v = torch.from_numpy(values).to(self._device)
        w = torch.from_numpy(weights).to(self._device)
        if self._auto_center_pending:
            st = batched.recenter(spec, st, batched.auto_offset(spec, st, v))
        self._state = batched.add(spec, st, v, w)

    # -- core API ----------------------------------------------------------
    def add(self, val: float, weight: float = 1.0) -> None:
        if weight <= 0.0:
            raise SketchValueError("weight must be positive")
        # All scalar bookkeeping happens vectorized at flush time; this is
        # two list appends.
        self._pending_vals.append(val)
        self._pending_weights.append(weight)
        if len(self._pending_vals) >= self._FLUSH_CHUNK:
            self._flush()

    def add_many(self, values, weights=None) -> None:
        """Vectorized bulk add: one numpy pass instead of N ``add`` calls.

        Semantically N scalar ``add`` calls (same zero classification, same
        f64 bookkeeping, same auto-centring on the first data this sketch
        sees), but the values feed the native buffer or the device flush
        directly.  ``weights`` broadcasts against ``values`` and must be
        strictly positive.  Values are flattened; pending scalar adds flush
        first so arrival order is preserved.
        """
        v64 = np.asarray(values, np.float64).ravel()
        if weights is None:
            w64 = np.ones_like(v64)
        else:
            w64 = np.broadcast_to(np.asarray(weights, np.float64), v64.shape)
            if v64.size and not (w64 > 0.0).all():
                raise SketchValueError("weight must be positive")
        if v64.size == 0:
            return
        self._flush()  # drain buffered scalar adds ahead of this batch
        _t0 = telemetry.clock() if telemetry._ACTIVE else None
        self._host_cache = None
        # Device-semantics zero classification, identical to _flush.
        v32 = v64.astype(np.float32)
        zero_lanes = ~(np.abs(v32) >= _F32_TINY)
        if self._use_native:
            self._flush_native(v64, w64, zero_lanes)
            self._auto_center_pending = False
        else:
            # Device tier: _FLUSH_CHUNK-shaped slices, zero-weight padding.
            chunk = self._FLUSH_CHUNK
            for s in range(0, v64.size, chunk):
                vv = np.zeros((1, chunk), np.float32)
                ww = np.zeros((1, chunk), np.float32)
                piece = slice(s, min(s + chunk, v64.size))
                ln = piece.stop - piece.start
                vv[0, :ln] = v32[piece]
                ww[0, :ln] = w64[piece]
                self._device_chunk(vv, ww)
                self._auto_center_pending = False
        # Scalar bookkeeping over the whole batch (the f64 master copies,
        # NaN poisoning the sum as in _flush).
        self._count += float(w64.sum())
        self._sum += float((v64 * w64).sum())
        finite = ~np.isnan(v64)
        if finite.any():
            self._min = min(self._min, float(v64[finite].min()))
            self._max = max(self._max, float(v64[finite].max()))
        if zero_lanes.any():
            self._zero_count += float(w64[zero_lanes].sum())
        if _t0 is not None:
            telemetry.finish_span("scalar.ingest_s", _t0, path="add_many")
            telemetry.counter_inc("scalar.values", float(v64.size))

    def _flush(self) -> None:
        if not self._pending_vals:
            return
        _t0 = telemetry.clock() if telemetry._ACTIVE else None
        _n = len(self._pending_vals)
        self._host_cache = None
        while self._pending_vals:
            chunk_v = self._pending_vals[: self._FLUSH_CHUNK]
            chunk_w = self._pending_weights[: self._FLUSH_CHUNK]
            # The f64 arrays are the master copies; the f32 device buffers
            # derive from them by a numpy downcast.
            v64 = np.asarray(chunk_v, np.float64)
            w64 = np.asarray(chunk_w, np.float64)
            # Classify zeros with the device's semantics (the f32 cast, and
            # f32 subnormals and NaN land in the zero bucket), not the host
            # mapping's f64 min_possible: anything the device counts as zero
            # must count as zero here too, or cross-backend merges drop it.
            v32 = v64.astype(np.float32)
            zero_lanes = ~(np.abs(v32) >= _F32_TINY)
            # The engine call runs before any counter or buffer changes: a
            # failed chunk leaves the sketch self-consistent and retryable.
            if self._use_native:
                self._flush_native(v64, w64, zero_lanes)
            else:
                values = np.zeros((1, self._FLUSH_CHUNK), np.float32)
                weights = np.zeros((1, self._FLUSH_CHUNK), np.float32)
                values[0, : len(chunk_v)] = v32
                weights[0, : len(chunk_w)] = w64
                self._device_chunk(values, weights)
            self._auto_center_pending = False
            del self._pending_vals[: self._FLUSH_CHUNK]
            del self._pending_weights[: self._FLUSH_CHUNK]
            self._count += float(w64.sum())
            self._sum += float((v64 * w64).sum())  # NaN poisons
            finite = ~np.isnan(v64)
            if finite.any():
                self._min = min(self._min, float(v64[finite].min()))
                self._max = max(self._max, float(v64[finite].max()))
            if zero_lanes.any():
                self._zero_count += float(w64[zero_lanes].sum())
        if _t0 is not None:
            telemetry.finish_span("scalar.ingest_s", _t0, path="flush")
            telemetry.counter_inc("scalar.values", float(_n))

    def _flush_native(self, v64, w64, zero_lanes) -> None:
        """Feed one chunk to the native accumulator.

        Values below the device zero threshold (f32 subnormals, NaN) are fed
        as literal zeros so the native zero bucket matches the device
        classification; everything else keys through the scalar (f64)
        mapping path.
        """
        from sketches_tpu_torch import native

        if self._native_acc is None:
            if self._auto_center_pending and self._window_offset is None:
                self._window_offset = self._auto_center_offset(v64, zero_lanes)
            if self._window_offset is None:
                self._window_offset = int(self._spec.key_offset)
            self._native_acc = native.NativeDDSketch(
                self._spec.relative_accuracy,
                n_bins=self._spec.n_bins,
                key_offset=self._window_offset,
                mapping=self._spec.mapping_name,
            )
        feed = v64.copy()
        feed[zero_lanes] = 0.0
        self._native_acc.add_batch(feed, w64)

    def _auto_center_offset(self, v64, zero_lanes) -> int:
        """First-batch window centre, host twin of ``batched.auto_offset``:
        the median key of the chunk's live nonzero values.  Keys are a
        monotone function of |v|, so key(median |v|) == median(key): one
        sort and one scalar ``mapping.key`` (the f64 path; at most one
        bucket from the device's f32 derivation)."""
        from sketches_tpu_torch.batched import _center_bin

        live = ~zero_lanes
        if not live.any():
            return int(self._spec.key_offset)
        a = np.sort(np.abs(v64[live]))
        med = float(a[(a.size - 1) // 2])
        if not math.isfinite(med):
            # An infinite median has no key: centre on the largest finite
            # magnitude, where the device's saturating key would land.
            med = sys.float_info.max
        return int(self._mapping.key(med)) - _center_bin(self._spec)

    def _settle(self) -> None:
        """Flush, then lift any native-buffered mass onto the device state:
        one device dispatch per query, merge or view, not one per chunk.
        ``merge_aligned`` adopts the buffer's window while the device state
        is empty and realigns otherwise."""
        from sketches_tpu_torch import batched

        self._flush()
        acc = self._native_acc
        if acc is not None and acc.count > 0:
            self._state = batched.merge_aligned(
                self._spec, self._state, acc.to_state(self._device)
            )
            self._native_acc = None
            self._host_cache = None

    def get_quantile_value(self, quantile: float) -> typing.Optional[float]:
        from sketches_tpu_torch import batched

        self._settle()  # also settles the deferred _count bookkeeping
        if quantile < 0 or quantile > 1 or self._count == 0:
            return None
        return float(batched.get_quantile_value(self._spec, self._state, float(quantile))[0])

    def mergeable(self, other: "BaseDDSketch") -> bool:
        """Torch-backed sketches need the full spec (gamma and window) to
        match; cross-backend merges need the identical mapping (type, gamma,
        offset).  The host bins are then packed into this sketch's window,
        clamping at the edges."""
        if isinstance(other, TorchDDSketch):
            return self._spec == other._spec
        return self._mapping == other._mapping

    def merge(self, sketch: "BaseDDSketch") -> None:
        from sketches_tpu_torch import batched

        if not self.mergeable(sketch):
            raise UnequalSketchParametersError(
                "Cannot merge two DDSketches with different parameters"
            )
        if sketch.count == 0:
            return
        self._settle()
        if isinstance(sketch, TorchDDSketch):
            sketch._settle()
            other_state = sketch._state.map(lambda x: x.to(self._device))
        else:
            # Cross-backend: pack the pure-Python sketch's bins into a
            # 1-stream state (out-of-window mass clamps to the edge bins).
            other_state = batched.from_host_sketches(self._spec, [sketch], self._device)
        _ipre = (
            integrity.premerge(self._spec, self._state, other_state)
            if integrity._ACTIVE
            else None
        )
        self._state = batched.merge_aligned(self._spec, self._state, other_state)
        if _ipre is not None:
            # Guarded seam: fingerprint / conservation check of the merged
            # state against the operand snapshot (the JAX package's seam
            # name).
            integrity.postmerge(self._spec, self._state, _ipre, seam="jax.merge")
        # The merge populated the device state; a pending auto-centre would
        # recentre away from the merged mass.  The merged-in window is now
        # the established one: pin the native buffer's window to it.
        self._auto_center_pending = False
        if self._window_offset is None:
            if isinstance(sketch, TorchDDSketch) and sketch._window_offset is not None:
                self._window_offset = sketch._window_offset
            else:
                self._window_offset = int(self._state.key_offset[0])
        self._host_cache = None
        self._zero_count += sketch._zero_count
        self._count += sketch._count
        self._sum += sketch._sum
        self._min = min(self._min, sketch._min)
        self._max = max(self._max, sketch._max)

    def copy(self) -> "TorchDDSketch":
        self._settle()
        new = TorchDDSketch(
            self._relative_accuracy,
            n_bins=self._spec.n_bins,
            mapping=self._spec.mapping_name,
            key_offset=self._spec.key_offset,
            device=self._device,
        )
        new._state = self._state.map(torch.clone)
        new._auto_center_pending = self._auto_center_pending
        new._window_offset = self._window_offset
        new._zero_count = self._zero_count
        new._count = self._count
        new._sum = self._sum
        new._min = self._min
        new._max = self._max
        return new

    # -- accessors (BaseDDSketch properties read these fields) -------------
    @property
    def zero_count(self) -> float:
        self._flush()
        return self._zero_count

    @property
    def count(self) -> float:
        self._flush()
        return self._count

    @property
    def num_values(self) -> float:
        self._flush()
        return self._count

    @property
    def sum(self) -> float:  # noqa: A003 - reference API name
        self._flush()
        return self._sum

    @property
    def avg(self) -> float:
        self._flush()
        return self._sum / self._count

    def __repr__(self) -> str:
        self._flush()  # the inherited repr reads the deferred counters
        return super().__repr__()

    def _host_view(self) -> "BaseDDSketch":
        """Host materialization of the device bins, cached until the next
        change, so back-to-back store/negative_store reads pay one copy.
        Settles first, unconditionally, so a view never misses buffered
        values."""
        from sketches_tpu_torch.batched import to_host_sketches

        self._settle()
        if self._host_cache is None:
            self._host_cache = to_host_sketches(self._spec, self._state)[0]
        return self._host_cache

    @property
    def store(self):
        return self._host_view().store

    @property
    def negative_store(self):
        return self._host_view().negative_store


class DDSketch(BaseDDSketch):
    """Default preset: LogarithmicMapping + unbounded DenseStore (pos & neg).

    Reference seam: ``ddsketch/ddsketch.py . DDSketch``.  Pass
    ``backend="torch"`` for the same API on the device tier
    (:class:`TorchDDSketch`); the default pure-Python backend doubles as
    the oracle the device path is tested against.

    Failure modes: invalid configuration raises ``SpecError``;
    non-positive weights raise ``SketchValueError``; quantiles of an empty
    sketch return ``None``; merging sketches with different mapping
    parameters raises ``UnequalSketchParametersError``.
    """

    def __new__(
        cls,
        relative_accuracy: typing.Optional[float] = None,
        backend: str = "py",
        *,
        mapping: typing.Optional[str] = None,
        n_bins: typing.Optional[int] = None,
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        if backend == "torch":
            if cls is not DDSketch:
                raise NotImplementedError(
                    f"backend='torch' is not inherited by subclass {cls.__name__};"
                    " construct TorchDDSketch directly"
                )
            return TorchDDSketch(
                relative_accuracy,
                n_bins=n_bins,
                mapping=mapping or "logarithmic",
                key_offset=key_offset,
                device=device,
            )
        if backend != "py":
            raise SpecError(f"Unknown backend {backend!r}")
        _reject_torch_only_kwargs(
            mapping=mapping, n_bins=n_bins, key_offset=key_offset, device=device
        )
        return super().__new__(cls)

    def __init__(
        self,
        relative_accuracy: typing.Optional[float] = None,
        backend: str = "py",
        *,
        mapping: typing.Optional[str] = None,
        n_bins: typing.Optional[int] = None,
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        if relative_accuracy is None:
            relative_accuracy = DEFAULT_REL_ACC
        super().__init__(
            mapping=LogarithmicMapping(relative_accuracy),
            store=DenseStore(),
            negative_store=DenseStore(),
        )


def _reject_torch_only_kwargs(**kwargs) -> None:
    """The py presets are reference-shaped (LogarithmicMapping + the preset's
    store class); the device-tier knobs only apply to ``backend="torch"``.
    Compose ``BaseDDSketch`` directly for a non-default pure-Python sketch."""
    passed = [k for k, v in kwargs.items() if v is not None]
    if passed:
        raise SpecError(
            f"{', '.join(passed)} only apply to backend='torch'; for a custom"
            " pure-Python sketch compose BaseDDSketch(mapping=..., store=...)"
        )


def _torch_collapsing_sketch(
    relative_accuracy: typing.Optional[float],
    bin_limit: typing.Optional[int],
    mapping: typing.Optional[str] = None,
    key_offset: typing.Optional[int] = None,
    device=None,
) -> "TorchDDSketch":
    """The torch backend for both collapsing presets.

    The device tier always collapses (a static ``bin_limit``-bin window,
    mass clamping at both edges with counters), which bounds memory like
    the reference presets.  The difference, inherent to static shapes: the
    py presets slide their window to follow the data while the device
    window is fixed once the first flush centres it.
    """
    # Degenerate limits (< 2, incl. the py tier's accepted 0/1) fall back to
    # the default: the device window needs >= 2 bins.
    if bin_limit is None or bin_limit < 2:
        bin_limit = DEFAULT_BIN_LIMIT
    return TorchDDSketch(
        relative_accuracy,
        n_bins=bin_limit,
        mapping=mapping or "logarithmic",
        key_offset=key_offset,
        device=device,
    )


class LogCollapsingLowestDenseDDSketch(BaseDDSketch):
    """LogarithmicMapping + CollapsingLowestDenseStore (bounded memory).

    Reference seam: ``ddsketch/ddsketch.py . LogCollapsingLowestDenseDDSketch``.
    ``backend="torch"`` bounds memory with the device tier's static window
    (see ``_torch_collapsing_sketch``).
    """

    def __new__(
        cls,
        relative_accuracy: typing.Optional[float] = None,
        bin_limit: typing.Optional[int] = None,
        backend: str = "py",
        *,
        mapping: typing.Optional[str] = None,
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        if backend == "torch":
            if cls is not LogCollapsingLowestDenseDDSketch:
                raise NotImplementedError(
                    f"backend='torch' is not inherited by subclass {cls.__name__};"
                    " construct TorchDDSketch directly"
                )
            return _torch_collapsing_sketch(
                relative_accuracy, bin_limit, mapping, key_offset, device
            )
        if backend != "py":
            raise SpecError(f"Unknown backend {backend!r}")
        _reject_torch_only_kwargs(mapping=mapping, key_offset=key_offset, device=device)
        return super().__new__(cls)

    def __init__(
        self,
        relative_accuracy: typing.Optional[float] = None,
        bin_limit: typing.Optional[int] = None,
        backend: str = "py",
        *,
        mapping: typing.Optional[str] = None,
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        if relative_accuracy is None:
            relative_accuracy = DEFAULT_REL_ACC
        if bin_limit is None or bin_limit < 0:
            bin_limit = DEFAULT_BIN_LIMIT
        super().__init__(
            mapping=LogarithmicMapping(relative_accuracy),
            store=CollapsingLowestDenseStore(bin_limit),
            negative_store=CollapsingLowestDenseStore(bin_limit),
        )


class LogCollapsingHighestDenseDDSketch(BaseDDSketch):
    """LogarithmicMapping + CollapsingHighestDenseStore (bounded memory).

    Reference seam: ``ddsketch/ddsketch.py . LogCollapsingHighestDenseDDSketch``.
    ``backend="torch"`` bounds memory with the device tier's static window
    (see ``_torch_collapsing_sketch``).
    """

    def __new__(
        cls,
        relative_accuracy: typing.Optional[float] = None,
        bin_limit: typing.Optional[int] = None,
        backend: str = "py",
        *,
        mapping: typing.Optional[str] = None,
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        if backend == "torch":
            if cls is not LogCollapsingHighestDenseDDSketch:
                raise NotImplementedError(
                    f"backend='torch' is not inherited by subclass {cls.__name__};"
                    " construct TorchDDSketch directly"
                )
            return _torch_collapsing_sketch(
                relative_accuracy, bin_limit, mapping, key_offset, device
            )
        if backend != "py":
            raise SpecError(f"Unknown backend {backend!r}")
        _reject_torch_only_kwargs(mapping=mapping, key_offset=key_offset, device=device)
        return super().__new__(cls)

    def __init__(
        self,
        relative_accuracy: typing.Optional[float] = None,
        bin_limit: typing.Optional[int] = None,
        backend: str = "py",
        *,
        mapping: typing.Optional[str] = None,
        key_offset: typing.Optional[int] = None,
        device=None,
    ):
        if relative_accuracy is None:
            relative_accuracy = DEFAULT_REL_ACC
        if bin_limit is None or bin_limit < 0:
            bin_limit = DEFAULT_BIN_LIMIT
        super().__init__(
            mapping=LogarithmicMapping(relative_accuracy),
            store=CollapsingHighestDenseStore(bin_limit),
            negative_store=CollapsingHighestDenseStore(bin_limit),
        )
