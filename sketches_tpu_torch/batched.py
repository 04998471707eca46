"""Device tier: batched DDSketch as struct-of-arrays tensors (PyTorch port).

Counterpart of ``sketches_tpu/batched.py``.  One batch of ``n_streams``
independent sketches is a :class:`SketchState` of tensors on one device:

    bins_pos, bins_neg : [n_streams, n_bins]   (f32, or int32 bins)
    zero_count, count, sum, min, max, ... : [n_streams]

The pure functions (``init``, ``add``, ``quantile``, ``merge``,
``recenter``, ...) repeat the JAX package's arithmetic with ordinary tensor
ops; they are the port's plain tier (JAX's XLA tier) and the floor the
facade routes to when no kernel applies.  :class:`BatchedDDSketch` is the
stateful facade: it centres each stream's window on its first batch, sends
128-aligned batches through the fused ingest kernel and picks the query
tier exactly as the JAX facade does (``kernels.choose_query_engine``, with
the overlap engine on unless ``SKETCHES_TPU_OVERLAP=0``).

Failures degrade instead of crashing, as in the JAX package: a query tier
that fails (or an armed ``pallas.lowering`` fault) demotes the facade down
``overlap -> tiles -> windowed -> wxla -> xla``, an ingest kernel failure
(or an armed ``pallas.ingest`` fault) moves it to the plain ingest for
good, and each step is recorded in ``resilience.health()``.  On CUDA
tensors only an armed fault steps down: a real kernel error raises, so no
kernel is replaced by its plain version on the card
(``resilience.survivable``).  With the integrity layer armed, ``merge`` fingerprints its operands and its result.

PyTorch runs eagerly, so nothing here is jitted.  Where the JAX facade
donates its state to a jitted chunk op, the port updates the state's
tensors in place, chunk by chunk (``BatchedDDSketch._stream_op``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from sketches_tpu_torch import accuracy, faults, integrity, profiling, resilience, telemetry, tracing
from sketches_tpu_torch.mapping import KeyMapping, mapping_from_name, zero_threshold
from sketches_tpu_torch.resilience import (
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

__all__ = [
    "SketchSpec",
    "SketchState",
    "LEAVES",
    "init",
    "add",
    "quantile",
    "get_quantile_value",
    "merge",
    "merge_aligned",
    "merge_axis",
    "recenter",
    "recenter_to_data",
    "auto_offset",
    "data_center_offsets",
    "overflow_risk",
    "tile_sums_of",
    "tile_sums_np",
    "occupied_bounds_np",
    "cumsum_f32",
    "to_host_sketches",
    "from_host_sketches",
    "arrays_to_state",
    "BatchedDDSketch",
]

DEFAULT_REL_ACC = 0.01
DEFAULT_N_BINS = 2048

# Column-tile width of the bin axis and the granule of ``tile_sums``.
TILE = 128

_BIN_DTYPES = (torch.float32, torch.int32)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static configuration of a sketch batch (``batched.SketchSpec``).

    Same fields, defaults, validation and hash as the JAX package, with
    torch dtypes.  The port runs f32 values (``dtype=torch.float32``) and
    f32 or int32 bins (``bin_dtype``); any other dtype raises ``SpecError``.
    """

    relative_accuracy: float = DEFAULT_REL_ACC
    mapping_name: str = "logarithmic"
    n_bins: int = DEFAULT_N_BINS
    key_offset: Optional[int] = None
    dtype: torch.dtype = torch.float32
    bin_dtype: Optional[torch.dtype] = None
    backend: str = "dense"
    collapse_threshold: float = 0.01
    max_collapses: int = 10
    n_moments: int = 12

    def __post_init__(self):
        if not 0.0 < self.relative_accuracy < 1.0:
            raise SpecError("Relative accuracy must be between 0 and 1.")
        if self.n_bins < 2:
            raise SpecError("n_bins must be >= 2")
        if self.backend not in ("dense", "uniform_collapse", "moment"):
            raise SpecError(
                f"Unknown backend {self.backend!r}: expected one of"
                " 'dense', 'uniform_collapse', 'moment'"
            )
        if self.backend == "uniform_collapse":
            if self.mapping_name != "logarithmic":
                raise SpecError(
                    "uniform_collapse backend requires the logarithmic"
                    f" mapping; got {self.mapping_name!r}"
                )
            if not 0.0 < self.collapse_threshold < 1.0:
                raise SpecError("collapse_threshold must be in (0, 1)")
            if self.max_collapses < 1:
                raise SpecError("max_collapses must be >= 1")
        if self.backend == "moment" and not 2 <= self.n_moments <= 16:
            raise SpecError("n_moments must be in [2, 16]")
        if self.key_offset is None:
            object.__setattr__(self, "key_offset", -(self.n_bins // 2))
        if self.bin_dtype is None:
            object.__setattr__(self, "bin_dtype", self.dtype)
        if self.dtype != torch.float32:
            raise SpecError(f"dtype must be torch.float32; got {self.dtype}")
        if self.bin_dtype not in _BIN_DTYPES:
            raise SpecError(
                f"bin_dtype must be torch.float32 or torch.int32; got {self.bin_dtype}"
            )
        # Unknown mapping names fail here, at construction.
        _ = self.mapping

    @property
    def bins_integer(self) -> bool:
        return not self.bin_dtype.is_floating_point

    @property
    def n_tiles(self) -> int:
        """Column tiles per store: ``ceil(n_bins / 128)``."""
        return -(-self.n_bins // TILE)

    @functools.cached_property
    def mapping(self) -> KeyMapping:
        return mapping_from_name(self.mapping_name, self.relative_accuracy)

    @property
    def gamma(self) -> float:
        return self.mapping.gamma

    @property
    def min_value(self) -> float:
        return self.mapping.value(self.key_offset)

    @property
    def max_value(self) -> float:
        return self.mapping.value(self.key_offset + self.n_bins - 1)

    def __hash__(self):
        return hash(
            (
                self.relative_accuracy,
                self.mapping_name,
                self.n_bins,
                self.key_offset,
                _dtype_name(self.dtype),
                _dtype_name(self.bin_dtype),
                self.backend,
                self.collapse_threshold,
                self.max_collapses,
                self.n_moments,
            )
        )


#: The sixteen state leaves, in ``SketchState`` field order.
LEAVES = (
    "bins_pos", "bins_neg", "zero_count", "count", "sum", "min", "max",
    "collapsed_low", "collapsed_high", "key_offset", "pos_lo", "pos_hi",
    "neg_lo", "neg_hi", "neg_total", "tile_sums",
)


@dataclasses.dataclass
class SketchState:
    """Per-batch device state (``batched.SketchState``), one tensor per leaf.

    All leaves live on one device.  ``key_offset`` and the occupied bounds
    are int32; the bins and mass counters are in the spec's ``bin_dtype``;
    ``sum``/``min``/``max`` in its ``dtype``.  ``collapsed_low`` /
    ``collapsed_high`` count the mass collapsed into the edge bins (the
    reference's observability counters); an empty stream's occupied
    bounds are ``(n_bins, -1)``.
    """

    bins_pos: torch.Tensor  # [n_streams, n_bins]
    bins_neg: torch.Tensor  # [n_streams, n_bins]
    zero_count: torch.Tensor  # [n_streams]
    count: torch.Tensor
    sum: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    collapsed_low: torch.Tensor
    collapsed_high: torch.Tensor
    key_offset: torch.Tensor  # int32 window low edge per stream
    pos_lo: torch.Tensor  # int32 occupied bounds, (n_bins, -1) when empty
    pos_hi: torch.Tensor
    neg_lo: torch.Tensor
    neg_hi: torch.Tensor
    neg_total: torch.Tensor  # == bins_neg.sum(-1)
    tile_sums: torch.Tensor  # [n_streams, 2 * n_tiles]

    @property
    def occ_lo(self) -> torch.Tensor:
        return torch.minimum(self.pos_lo, self.neg_lo)

    @property
    def occ_hi(self) -> torch.Tensor:
        return torch.maximum(self.pos_hi, self.neg_hi)

    @property
    def n_streams(self) -> int:
        return self.bins_pos.shape[-2]

    @property
    def n_bins(self) -> int:
        return self.bins_pos.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.bins_pos.device

    def map(self, fn) -> "SketchState":
        """A new state with ``fn`` applied to every leaf."""
        return SketchState(**{f: fn(getattr(self, f)) for f in LEAVES})

    @classmethod
    def cat(cls, states) -> "SketchState":
        """The states stacked along the stream axis, leaf by leaf (one
        device; the tile sums and occupied bounds come along)."""
        return cls(**{f: torch.cat([getattr(s, f) for s in states]) for f in LEAVES})


def init(spec: SketchSpec, n_streams: int, device=None) -> SketchState:
    """Allocate an empty batch of ``n_streams`` sketches on ``device``: the
    card by default (``SpecError`` without one), the CPU when asked for."""
    dev = resolve_device(device)
    bd, dt = spec.bin_dtype, spec.dtype

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    n = n_streams
    return SketchState(
        bins_pos=full((n, spec.n_bins), 0, bd),
        bins_neg=full((n, spec.n_bins), 0, bd),
        zero_count=full((n,), 0, bd),
        count=full((n,), 0, bd),
        sum=full((n,), 0.0, dt),
        min=full((n,), float("inf"), dt),
        max=full((n,), float("-inf"), dt),
        collapsed_low=full((n,), 0, bd),
        collapsed_high=full((n,), 0, bd),
        key_offset=full((n,), spec.key_offset, torch.int32),
        pos_lo=full((n,), spec.n_bins, torch.int32),
        pos_hi=full((n,), -1, torch.int32),
        neg_lo=full((n,), spec.n_bins, torch.int32),
        neg_hi=full((n,), -1, torch.int32),
        neg_total=full((n,), 0, bd),
        tile_sums=full((n, 2 * spec.n_tiles), 0, bd),
    )


def tile_sums_of(bins_pos: torch.Tensor, bins_neg: torch.Tensor) -> torch.Tensor:
    """The [N, 2*T] per-tile masses recomputed from the bins (ragged last
    tile zero-padded)."""
    n, b = bins_pos.shape
    t = -(-b // TILE)
    pad = t * TILE - b

    def tiles(x):
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        return x.reshape(n, t, TILE).sum(-1, dtype=x.dtype)

    return torch.cat([tiles(bins_pos), tiles(bins_neg)], dim=1)


def tile_sums_np(bins_pos: np.ndarray, bins_neg: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of :func:`tile_sums_of` for interop and restore
    paths."""
    n, b = bins_pos.shape
    t = -(-b // TILE)
    pad = t * TILE - b

    def tiles(x):
        if pad:
            x = np.pad(x, ((0, 0), (0, pad)))
        return x.reshape(n, t, TILE).sum(-1)

    return np.concatenate([tiles(bins_pos), tiles(bins_neg)], axis=1)


def occupied_bounds_np(bins: np.ndarray):
    """Host (numpy) twin of :func:`_occupied_bounds`, any batch shape.

    The one implementation of the ``(n_bins, -1)`` sentinel contract for
    host interop paths (checkpoint restore, host-sketch packing, native
    lift, wire decode); the windowed and tile queries clip on these
    sentinels, so every producer must agree on them.
    """
    n_bins = bins.shape[-1]
    occ = bins > 0
    any_ = occ.any(axis=-1)
    # argmax on bool = first/last True: fewer and smaller temporaries than
    # a where(iota) min/max.
    lo = np.where(any_, occ.argmax(axis=-1), n_bins).astype(np.int32)
    hi = np.where(any_, n_bins - 1 - occ[..., ::-1].argmax(axis=-1), -1).astype(np.int32)
    return lo, hi


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Running sums along the last axis, accumulated in ``x``'s own dtype.

    The one prefix sum of every plain rank walk.  JAX, and ``torch.cumsum``
    on CUDA, accumulate f32 in f32; ``torch.cumsum`` on the CPU accumulates
    f32 in f64 and rounds each prefix once, which moves a weighted rank
    boundary by one occupied bucket.  On the CPU an f32 input therefore
    goes through numpy's ``add.accumulate``: one f32 add per column, in
    column order.  Integer bins are exact in any order.
    """
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.from_numpy(np.cumsum(x.detach().numpy(), axis=-1, dtype=np.float32))
    return torch.cumsum(x, dim=-1, dtype=x.dtype)


def _occupied_bounds(bins: torch.Tensor):
    """Exact occupied span of one store -> (lo [N], hi [N]) int32, with the
    ``(n_bins, -1)`` sentinels for empty rows."""
    n_bins = bins.shape[-1]
    occ = bins > 0
    iota = torch.arange(n_bins, dtype=torch.int32, device=bins.device)
    lo = torch.where(occ, iota, n_bins).amin(-1).to(torch.int32)
    hi = torch.where(occ, iota, -1).amax(-1).to(torch.int32)
    return lo, hi


def _keys_and_masks(spec: SketchSpec, key_offset: torch.Tensor, values: torch.Tensor):
    """values [N, S] -> (clamped bin index [N, S] int32, is_pos, is_neg,
    is_zero, clamped_low, clamped_high).

    The zero bucket is |v| below the smallest positive normal (explicit, not
    left to flush-to-zero); NaN fails both compares and lands there.
    """
    v = values.to(spec.dtype)
    tiny = zero_threshold(v.dtype)
    is_pos = v >= tiny
    is_neg = v <= -tiny
    is_zero = ~(is_pos | is_neg)
    absv = torch.where(is_zero, torch.ones_like(v), v.abs())
    keys = spec.mapping.key_array(absv)
    lo = key_offset[:, None].to(torch.int32)
    hi = lo + (spec.n_bins - 1)
    clamped_low = keys < lo
    clamped_high = keys > hi
    idx = torch.minimum(torch.maximum(keys, lo), hi) - lo
    return idx, is_pos, is_neg, is_zero, clamped_low, clamped_high


def _weights_like(spec: SketchSpec, v: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return torch.ones_like(v)
    w = torch.as_tensor(weights, dtype=spec.dtype, device=v.device)
    return w.broadcast_to(v.shape)


def add(
    spec: SketchSpec,
    state: SketchState,
    values: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> SketchState:
    """Ingest ``values[n_streams, S]`` (optionally weighted) -> new state.

    The plain (scatter-add) ingest.  ``weights <= 0`` entries are inert
    padding; NaN values land in the zero bucket, leave min/max untouched and
    poison ``sum``, as in the JAX package.
    """
    v = values.to(spec.dtype)
    w = _weights_like(spec, v, weights)
    idx, is_pos, is_neg, is_zero, clamped_low, clamped_high = _keys_and_masks(
        spec, state.key_offset, v
    )
    live = w > 0
    zero = torch.zeros((), dtype=spec.dtype, device=v.device)
    w_pos = torch.where(is_pos & live, w, zero)
    w_neg = torch.where(is_neg & live, w, zero)
    w_zero = torch.where(is_zero & live, w, zero)
    w_live = w_pos + w_neg + w_zero

    bd = spec.bin_dtype
    wb_pos, wb_neg, wb_zero = w_pos.to(bd), w_neg.to(bd), w_zero.to(bd)
    signed = wb_pos + wb_neg
    zero_b = torch.zeros((), dtype=bd, device=v.device)
    finite_live = live & ~torch.isnan(v)
    hits_pos = live & is_pos
    hits_neg = live & is_neg
    idx64 = idx.to(torch.int64)
    tile_tgt = idx64 // TILE + torch.where(is_neg, spec.n_tiles, 0)
    inf = float("inf")

    def rsum(x):
        return x.sum(-1, dtype=x.dtype)

    return SketchState(
        bins_pos=state.bins_pos.scatter_add(1, idx64, wb_pos),
        bins_neg=state.bins_neg.scatter_add(1, idx64, wb_neg),
        zero_count=state.zero_count + rsum(wb_zero),
        count=state.count + rsum(wb_pos + wb_neg + wb_zero),
        sum=state.sum + (torch.where(live, v, zero) * w_live).sum(-1),
        min=torch.minimum(state.min, torch.where(finite_live, v, inf).amin(-1)),
        max=torch.maximum(state.max, torch.where(finite_live, v, -inf).amax(-1)),
        collapsed_low=state.collapsed_low + rsum(torch.where(clamped_low, signed, zero_b)),
        collapsed_high=state.collapsed_high
        + rsum(torch.where(clamped_high, signed, zero_b)),
        key_offset=state.key_offset,
        pos_lo=torch.minimum(
            state.pos_lo, torch.where(hits_pos, idx, spec.n_bins).amin(-1).to(torch.int32)
        ),
        pos_hi=torch.maximum(
            state.pos_hi, torch.where(hits_pos, idx, -1).amax(-1).to(torch.int32)
        ),
        neg_lo=torch.minimum(
            state.neg_lo, torch.where(hits_neg, idx, spec.n_bins).amin(-1).to(torch.int32)
        ),
        neg_hi=torch.maximum(
            state.neg_hi, torch.where(hits_neg, idx, -1).amax(-1).to(torch.int32)
        ),
        neg_total=state.neg_total + rsum(wb_neg),
        tile_sums=state.tile_sums.scatter_add(1, tile_tgt, signed),
    )


def _last_occupied(bins: torch.Tensor) -> torch.Tensor:
    """Per row: largest index with bins > 0 (0 if the row is empty)."""
    iota = torch.arange(bins.shape[-1], dtype=torch.int32, device=bins.device)
    return torch.where(bins > 0, iota, 0).amax(-1).to(torch.int32)


def _first_occupied(bins: torch.Tensor) -> torch.Tensor:
    """Per row: smallest index with bins > 0 (n_bins - 1 if empty)."""
    n_bins = bins.shape[-1]
    iota = torch.arange(n_bins, dtype=torch.int32, device=bins.device)
    return torch.where(bins > 0, iota, n_bins - 1).amin(-1).to(torch.int32)


def _as_qs(qs, device) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(qs, dtype=torch.float32, device=device))


# Float -> int threshold casts stay below the int32 edge (batched.quantile).
_INT_SAFE = float(2**31 - 256)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), so lo > hi yields hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def quantile(spec: SketchSpec, state: SketchState, qs) -> torch.Tensor:
    """Quantile values for ``qs[Q]`` across the batch -> ``[n_streams, Q]``.

    One cumsum per store reused across every quantile, mask-count rank
    selection, three-way negative/zero/positive select; NaN for an empty
    stream or q outside [0, 1].  Integer bins compare in integer space.
    """
    qs = _as_qs(qs, state.device)
    if qs.shape[0] == 0:
        return torch.zeros((state.n_streams, 0), dtype=spec.dtype, device=state.device)
    neg_count = state.neg_total
    count = state.count
    rank = qs[None, :] * (count[:, None] - 1)
    bd = state.bins_pos.dtype
    cum_pos = cumsum_f32(state.bins_pos)
    cum_neg = cumsum_f32(state.bins_neg)
    rev_rank = neg_count.to(spec.dtype)[:, None] - 1 - rank
    q_total = rank.shape[1]
    int_mode = spec.bins_integer

    def counts(cum, thr, strict):
        cols = []
        for qi in range(q_total):
            t = thr[:, qi : qi + 1]
            m = (cum < t) if strict else (cum <= t)
            cols.append(m.sum(-1).to(torch.int32))
        return torch.stack(cols, dim=1)

    if int_mode:
        thr_neg = torch.clamp(torch.ceil(rev_rank + 1) - 1, -_INT_SAFE, _INT_SAFE).to(bd)
        idx_neg = counts(cum_neg, thr_neg, False)
    else:
        idx_neg = counts(cum_neg, rev_rank + 1, True)
    idx_neg = _clip(
        idx_neg,
        _first_occupied(state.bins_neg)[:, None],
        _last_occupied(state.bins_neg)[:, None],
    )
    pos_rank = rank - (state.zero_count + neg_count).to(spec.dtype)[:, None]
    if int_mode:
        thr_pos = torch.clamp(torch.floor(pos_rank), -_INT_SAFE, _INT_SAFE).to(bd)
        idx_pos = counts(cum_pos, thr_pos, False)
    else:
        idx_pos = counts(cum_pos, pos_rank, False)
    idx_pos = _clip(
        idx_pos,
        _first_occupied(state.bins_pos)[:, None],
        _last_occupied(state.bins_pos)[:, None],
    )
    key_lo = state.key_offset[:, None].to(torch.int32)
    val_neg = -spec.mapping.value_array(idx_neg + key_lo)
    val_pos = spec.mapping.value_array(idx_pos + key_lo)
    in_neg = rank < neg_count.to(spec.dtype)[:, None]
    in_zero = rank < (neg_count + state.zero_count).to(spec.dtype)[:, None]
    zero = torch.zeros((), dtype=spec.dtype, device=state.device)
    out = torch.where(in_neg, val_neg, torch.where(in_zero, zero, val_pos))
    valid = ((qs >= 0) & (qs <= 1))[None, :] & (count > 0)[:, None]
    return torch.where(valid, out, float("nan"))


def get_quantile_value(spec: SketchSpec, state: SketchState, q: float) -> torch.Tensor:
    """Single-quantile convenience: ``[n_streams]`` (NaN if empty)."""
    return quantile(spec, state, [q])[:, 0]


def merge(spec: SketchSpec, a: SketchState, b: SketchState) -> SketchState:
    """Elementwise merge of two batches on the same windows."""
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
        key_offset=a.key_offset,
        pos_lo=torch.minimum(a.pos_lo, b.pos_lo),
        pos_hi=torch.maximum(a.pos_hi, b.pos_hi),
        neg_lo=torch.minimum(a.neg_lo, b.neg_lo),
        neg_hi=torch.maximum(a.neg_hi, b.neg_hi),
        neg_total=a.neg_total + b.neg_total,
        tile_sums=a.tile_sums + b.tile_sums,
    )


def merge_axis(spec: SketchSpec, state: SketchState, axis: int = 0) -> SketchState:
    """Fold a stacked ``[..., K, n_streams, ...]`` state over ``axis``,
    keeping slice 0's window offsets."""

    def tsum(x):
        return x.sum(axis, dtype=x.dtype)

    return SketchState(
        bins_pos=tsum(state.bins_pos),
        bins_neg=tsum(state.bins_neg),
        zero_count=tsum(state.zero_count),
        count=tsum(state.count),
        sum=tsum(state.sum),
        min=state.min.amin(axis),
        max=state.max.amax(axis),
        collapsed_low=tsum(state.collapsed_low),
        collapsed_high=tsum(state.collapsed_high),
        key_offset=state.key_offset.select(axis, 0),
        pos_lo=state.pos_lo.amin(axis),
        pos_hi=state.pos_hi.amax(axis),
        neg_lo=state.neg_lo.amin(axis),
        neg_hi=state.neg_hi.amax(axis),
        neg_total=tsum(state.neg_total),
        tile_sums=tsum(state.tile_sums),
    )


def overflow_risk(spec: SketchSpec, state: SketchState):
    """Per-stream largest accumulator mass and its fraction of the exact
    ceiling (2**24 for f32 bins, ``iinfo.max`` for int32 bins)."""
    m = torch.maximum(state.bins_pos.amax(-1), state.bins_neg.amax(-1))
    m = torch.maximum(m, state.zero_count)
    m = torch.maximum(m, torch.maximum(state.count, state.neg_total)).to(spec.dtype)
    if spec.bins_integer:
        ceiling = float(torch.iinfo(spec.bin_dtype).max)
    else:
        ceiling = float(2**24)
    return m, m / float(np.float32(ceiling))


# ---------------------------------------------------------------------------
# Adaptive window: recenter / auto-offset
# ---------------------------------------------------------------------------

# Temp budget for stream-chunked ops (elements per chunk of [chunk, n_bins]).
_CHUNK_ELEMS = 1 << 25


def _stream_chunk(n_streams: int, n_bins: int) -> int:
    """Chunk length for bounded-memory stream chunking; 0 = don't chunk.

    Same policy as the JAX package: 128-aligned chunks of about 2**25
    elements, only when chunking at least halves the temporaries.
    """
    target = max(128, (_CHUNK_ELEMS // max(n_bins, 1)) // 128 * 128)
    if n_streams <= 2 * target:
        return 0
    return target


def _slice_streams(x, n: int, start: int, end: int):
    """Rows ``start:end`` of a state or of a tensor with a leading stream
    axis of length ``n``; anything else passes through."""
    if isinstance(x, SketchState):
        return x.map(lambda t: t[start:end])
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == n:
        return x[start:end]
    return x


def _map_stream_chunks(fn, n_streams: int, n_bins: int, *operands) -> SketchState:
    """``fn(*operands)`` evaluated in bounded-memory stream chunks."""
    chunk = _stream_chunk(n_streams, n_bins)
    if not chunk:
        return fn(*operands)
    outs = [
        fn(*(_slice_streams(o, n_streams, s, min(s + chunk, n_streams)) for o in operands))
        for s in range(0, n_streams, chunk)
    ]
    return SketchState(**{f: torch.cat([getattr(o, f) for o in outs]) for f in LEAVES})


def recenter(spec: SketchSpec, state: SketchState, new_key_offset) -> SketchState:
    """Slide each stream's key window to ``new_key_offset`` (scalar or [N]).

    Mass whose key leaves the new window folds into the nearest edge bin
    (mass conserved) and the collapse counters record it.
    """
    new_off = torch.as_tensor(new_key_offset, dtype=torch.int32, device=state.device)
    new_off = new_off.broadcast_to(state.key_offset.shape).contiguous()
    return _map_stream_chunks(
        functools.partial(_recenter_body, spec), state.n_streams, spec.n_bins, state, new_off
    )


def _recenter_body(spec: SketchSpec, state: SketchState, new_off: torch.Tensor) -> SketchState:
    shift = new_off - state.key_offset  # new_idx = old_idx - shift
    n_bins = spec.n_bins
    iota = torch.arange(n_bins, dtype=torch.int32, device=state.device)
    tgt = iota[None, :] - shift[:, None]
    below = tgt < 0
    above = tgt > n_bins - 1
    idx = tgt.clamp(0, n_bins - 1).to(torch.int64)
    signed = state.bins_pos + state.bins_neg
    new_pos = torch.zeros_like(state.bins_pos).scatter_add_(1, idx, state.bins_pos)
    new_neg = torch.zeros_like(state.bins_neg).scatter_add_(1, idx, state.bins_neg)
    pos_lo, pos_hi = _occupied_bounds(new_pos)
    neg_lo, neg_hi = _occupied_bounds(new_neg)
    zero = torch.zeros((), dtype=signed.dtype, device=state.device)
    return SketchState(
        bins_pos=new_pos,
        bins_neg=new_neg,
        zero_count=state.zero_count,
        count=state.count,
        sum=state.sum,
        min=state.min,
        max=state.max,
        collapsed_low=state.collapsed_low
        + torch.where(below, signed, zero).sum(-1, dtype=signed.dtype),
        collapsed_high=state.collapsed_high
        + torch.where(above, signed, zero).sum(-1, dtype=signed.dtype),
        key_offset=new_off,
        pos_lo=pos_lo,
        pos_hi=pos_hi,
        neg_lo=neg_lo,
        neg_hi=neg_hi,
        neg_total=state.neg_total,
        tile_sums=tile_sums_of(new_pos, new_neg),
    )


def merge_aligned(spec: SketchSpec, a: SketchState, b: SketchState) -> SketchState:
    """``merge`` for operands whose windows may have drifted apart: both
    recenter onto ``a``'s offset where ``a`` holds binned mass, else ``b``'s."""
    return _map_stream_chunks(
        functools.partial(_merge_aligned_body, spec), a.n_streams, spec.n_bins, a, b
    )


def _merge_aligned_body(spec: SketchSpec, a_: SketchState, b_: SketchState) -> SketchState:
    a_binned = (a_.count - a_.zero_count) > 0
    target = torch.where(a_binned, a_.key_offset, b_.key_offset).to(torch.int32)
    return merge(
        spec, _recenter_body(spec, a_, target), _recenter_body(spec, b_, target)
    )


def _center_bin(spec: SketchSpec) -> int:
    """The bin auto-centering targets: the midpoint of a 128-bin tile (keeps
    a span of <= 128 bins inside one tile) for windows of >= 512 bins."""
    half = spec.n_bins // 2
    return half - 64 if spec.n_bins >= 512 else half


def auto_offset(
    spec: SketchSpec,
    state: SketchState,
    values: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-stream window offsets centred on the median key of a value batch
    -> [N] int32; streams with no live nonzero value keep their offset."""
    v = values.to(spec.dtype)
    tiny = zero_threshold(v.dtype)
    nonzero = v.abs() >= tiny
    if weights is not None:
        nonzero = nonzero & (_weights_like(spec, v, weights) > 0)
    absv = torch.where(nonzero, v.abs(), torch.ones_like(v))
    keys = spec.mapping.key_array(absv)
    ksort = torch.sort(torch.where(nonzero, keys, 2**30), dim=-1).values
    n_live = nonzero.sum(-1)
    mid = torch.clamp((n_live - 1) // 2, min=0)
    med = ksort.gather(1, mid[:, None])[:, 0]
    centered = med - _center_bin(spec)
    return torch.where(n_live > 0, centered, state.key_offset).to(torch.int32)


def data_center_offsets(spec: SketchSpec, state: SketchState) -> torch.Tensor:
    """Window offsets centring each stream on its binned-mass median key."""
    mass = state.bins_pos + state.bins_neg
    total = mass.sum(-1, dtype=mass.dtype)
    cum = cumsum_f32(mass)
    center = (cum < total[:, None] * 0.5).sum(-1).to(torch.int32)
    return torch.where(
        total > 0, state.key_offset + center - _center_bin(spec), state.key_offset
    ).to(torch.int32)


def recenter_to_data(spec: SketchSpec, state: SketchState) -> SketchState:
    """Recenter each stream's window on its binned-mass median key."""
    return recenter(spec, state, data_center_offsets(spec, state))


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


def resolve_device(device=None, state: Optional[SketchState] = None) -> torch.device:
    """An entry point's device: the caller's, else the state's, else the card.

    There is no silent CPU fallback: without a card, a caller who wants the
    CPU says so with ``device="cpu"``; otherwise this raises ``SpecError``.
    """
    if device is None and state is not None:
        return state.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SpecError(
                "the port runs on a CUDA device by default and none is"
                " available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BatchedDDSketch:
    """Stateful facade over the batched functions (``batched.BatchedDDSketch``).

    ``engine="auto" | "kernel" | "plain"`` stands for the JAX facade's
    ``"auto" | "pallas" | "xla"``: ``auto`` takes the kernel path wherever the
    configuration qualifies (``kernels.supports``), ``kernel`` demands it (and
    a CUDA device), ``plain`` never takes it.  On a CPU device the kernel
    path runs each kernel's plain version, so routing is the same on both.
    Resolved query tiers keep the JAX names: ``overlap``, ``tiles``,
    ``windowed``, ``wxla`` and ``xla``.

    Failure modes: invalid construction, an unknown engine, or no CUDA
    device without ``device="cpu"`` raise ``SpecError``; merging unequal
    specs raises ``UnequalSketchParametersError``; empty streams and
    out-of-range quantiles answer NaN.  A query tier that fails demotes
    this facade to the next tier for good (``resilience.QUERY_LADDER``,
    recorded as a ``batched.query`` downgrade) and retries; the ``xla``
    floor re-raises.  On the card only an armed fault steps down; a real
    kernel error raises.  A failed ingest kernel moves the facade to the plain
    ingest for good (a ``batched.ingest`` downgrade, ``kernel -> plain``)
    and replays the rest of the batch exactly; if the plain path fails
    too, ``EngineUnavailable`` is raised.  Armed integrity checks raise
    ``IntegrityError`` at ``merge``.
    """

    def __init__(
        self,
        n_streams: int,
        relative_accuracy: float = DEFAULT_REL_ACC,
        mapping: str = "logarithmic",
        n_bins: int = DEFAULT_N_BINS,
        key_offset: Optional[int] = None,
        spec: Optional[SketchSpec] = None,
        state: Optional[SketchState] = None,
        engine: str = "auto",
        auto_recenter: Optional[bool] = None,
        bin_dtype=None,
        device=None,
    ):
        from sketches_tpu_torch import kernels

        if auto_recenter is None:
            auto_recenter = key_offset is None and spec is None and state is None
        if spec is None:
            spec = SketchSpec(
                relative_accuracy=relative_accuracy,
                mapping_name=mapping,
                n_bins=n_bins,
                key_offset=key_offset,
                bin_dtype=bin_dtype,
            )
        self.spec = spec
        self.device = resolve_device(device, state)
        if state is not None and state.device != self.device:
            raise SpecError(f"state lives on {state.device}, not on {self.device}")
        self._state = init(spec, n_streams, self.device) if state is None else state
        self._auto_recenter_pending = bool(auto_recenter) and state is None
        self._policy_stale = False
        self._engine_request = engine
        use_kernels = kernels.select_engine(spec, n_streams, engine, self.device)
        self.engine = "kernel" if use_kernels else "plain"
        self._kernel_ingest = use_kernels
        self._ingest_variant_demoted = False
        self._kernel_query = use_kernels and not spec.bins_integer
        self._wxla_ok = spec.n_bins % TILE == 0
        self._window_plan = None
        self._tile_plans: dict = {}
        # Device copies of requested quantile lists: a host-to-device copy
        # waits for the stream, so each list is copied once.
        self._qs_tensors: dict = {}
        self._pending_recenter_mask: Optional[np.ndarray] = None
        self._policy_collapsed = np.zeros((n_streams,), np.float64)
        self._policy_binned = np.zeros((n_streams,), np.float64)
        # The demotion ladder's persistent state (resilience.QUERY_LADDER).
        self._query_disabled: set = set()
        self._health_component = "batched"
        self._rows_done = 0

    # -- ingest --------------------------------------------------------------
    def _add_recentering(self, st, values, weights, mask, spans=None):
        """Derive offsets from this batch, recenter the masked streams,
        ingest with the plain add -- the first batch's path
        (``ingest.recentre_s``)."""
        if spans is not None:
            spans.enter("ingest.recentre_s")
        offs = auto_offset(self.spec, st, values, weights)
        st = recenter(self.spec, st, torch.where(mask, offs, st.key_offset))
        out = add(self.spec, st, values, weights)
        if spans is not None:
            spans.exit()
        return out

    def add(self, values, weights=None) -> "BatchedDDSketch":
        """Ingest ``values[n_streams, S]``; returns self.  A 1-D ``values``
        is one value per stream; ``weights <= 0`` entries are padding.

        Armed observability records the engine that served (``recenter``,
        ``kernel`` or ``plain``): the ``ingest_s`` span and the ingest
        counters, an ``engine.ingest`` flight-recorder event, the
        device-clocked ``ingest`` row, and the accuracy audit's reservoir
        feed.  While telemetry is armed or a torch profiler records, the
        spans inside ``ingest_s`` name each layer (``telemetry.call_spans``):
        the recentre, and per stream chunk its slice, K1, the fold and the
        copy back."""
        _p0 = telemetry.clock() if profiling._ACTIVE else None
        with telemetry.call_spans("ingest_s") as sp:
            values, weights, _eng, variant = self._ingest(values, weights, sp)
            if sp is not None:
                sp.labels = {"component": "batched", "engine": _eng}
        if telemetry._ACTIVE:
            telemetry.counter_inc("batched.ingest_batches")
            # K1 serves every construction rung: count the rung label the
            # JAX facade would pick here (no separate construction ran).
            # The facade picks only stock or packed; literal names for the
            # telemetry-names inventory.
            if _eng == "kernel":
                if variant == "packed":
                    telemetry.counter_inc("ingest.variant.packed")
                else:
                    telemetry.counter_inc("ingest.variant.stock")
        if tracing._ACTIVE:
            tracing.record_event("engine.ingest", engine=_eng, component="batched")
        # Device-clocked attribution after the host span closes: the span
        # measures submission, the profiling record waits for execution.
        if _p0 is not None:
            profiling.record("ingest", _eng, _p0, self.state)
        if accuracy._ACTIVE:
            accuracy.observe_ingest(self, values, weights)
        return self

    def _ingest(self, values, weights, sp):
        """The work of :meth:`add` -> ``(values, weights, engine, variant)``
        as ingested; ``sp`` is the call's spans or None."""
        from sketches_tpu_torch import kernels

        _eng = "plain"
        variant = None
        values = torch.as_tensor(values, dtype=self.spec.dtype, device=self.device)
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=self.spec.dtype, device=self.device)
            if weights.ndim == 1:
                weights = weights[:, None]
        if values.ndim == 1:
            values = values[:, None]
        if self._auto_recenter_pending or self._pending_recenter_mask is not None:
            armed_by_policy = self._pending_recenter_mask is not None
            if self._auto_recenter_pending:
                # Only streams with no binned mass auto-centre: a populated
                # state assigned after construction keeps its windows.
                st = self.state
                mask = (st.count - st.zero_count) <= 0
                if armed_by_policy:
                    mask = mask | torch.as_tensor(
                        self._pending_recenter_mask, device=self.device
                    )
            else:
                mask = torch.as_tensor(self._pending_recenter_mask, device=self.device)
            self._auto_recenter_pending = False
            self._pending_recenter_mask = None
            _eng = "recenter"
            self._stream_op(
                functools.partial(self._add_recentering, spans=sp), values, weights, mask,
                spans=sp,
            )
            if armed_by_policy:
                kernels._FETCHES["add_policy"] += 1
                st = self.state
                self._policy_collapsed = (
                    (st.collapsed_low + st.collapsed_high).double().cpu().numpy()
                )
                self._policy_binned = (st.count - st.zero_count).double().cpu().numpy()
        elif (
            self._kernel_ingest
            and kernels.supports(self.spec, self.n_streams, values.shape[-1])
            and not (self.spec.bins_integer and weights is not None)
        ):
            self._rows_done = 0
            variant = (
                "stock"
                if self._ingest_variant_demoted
                else kernels.choose_ingest_engine(self.spec, weighted=weights is not None)
            )
            try:
                # The whole-kernel site sits above the rung ladder: a
                # pallas.ingest fault demotes straight to the plain path.
                if faults._ACTIVE:
                    faults.inject(faults.PALLAS_INGEST)
                if variant != "stock" and faults._ACTIVE:
                    # A non-stock rung that fails demotes to the stock rung
                    # (health ledger), not to the plain path.  K1 serves
                    # every rung and nothing was written yet, so running
                    # the stock rung replays the batch exactly.
                    try:
                        faults.inject(faults.PALLAS_INGEST_VARIANT, tier=variant)
                    except Exception as ev:
                        if not resilience.survivable(ev, self.device.type == "cuda"):
                            raise
                        self._ingest_variant_demoted = True
                        resilience.record_downgrade(
                            f"{self._health_component}.ingest_variant",
                            variant, "stock", repr(ev),
                        )
                        variant = "stock"
                _eng = "kernel"
                self._stream_op(
                    functools.partial(kernels.add, self.spec, variant=variant, spans=sp),
                    values, weights, spans=sp,
                )
            except Exception as e:
                # The ingest kernel is lost: this facade takes the plain
                # path for good and replays the stream chunks the kernel
                # did not write (each chunk is written only once its
                # kernel call returned), so the replay is exact.  On the
                # card only an armed fault is survived this way.
                if not resilience.survivable(e, self.device.type == "cuda"):
                    raise
                if sp is not None:
                    sp.unwind()
                self._kernel_ingest = False
                resilience.record_downgrade(
                    f"{self._health_component}.ingest", "kernel", "plain", repr(e)
                )
                _eng = "plain"
                try:
                    self._stream_op(
                        functools.partial(add, self.spec), values, weights,
                        start=self._rows_done, spans=sp,
                    )
                except Exception as e2:
                    raise resilience.EngineUnavailable(
                        "ingest failed on both the kernel and the plain path;"
                        " state may be partial"
                    ) from e2
        else:
            self._stream_op(functools.partial(add, self.spec), values, weights, spans=sp)
        self._invalidate_plans()
        return values, weights, _eng, variant

    def add_validated(self, values, weights=None) -> "BatchedDDSketch":
        """Like :meth:`add` but raises on negative weights (one host fetch,
        ``fetch.add_validated``)."""
        if weights is not None:
            from sketches_tpu_torch import kernels

            kernels._FETCHES["add_validated"] += 1
            if bool((torch.as_tensor(weights) < 0).any()):
                raise SketchValueError("weights must be non-negative (0 = padding)")
        return self.add(values, weights)

    def _stream_op(self, body, *args, start: int = 0, spans=None) -> None:
        """``state <- body(state, *args)``, chunked over streams when large.

        Chunked runs write each chunk's result into the state's tensors in
        place (the JAX facade donates its state for the same reason): peak
        memory stays one chunk's temporaries above the state itself.  Rows
        before ``start`` are left alone; ``self._rows_done`` counts the
        rows written so far, so a failed run can be finished from there.
        ``spans`` (the call's spans, or None) names each chunk's slice
        ``ingest.slice_s`` and its copy back ``ingest.copy_back_s``.
        """
        n = self.n_streams
        chunk = _stream_chunk(n, self.spec.n_bins)
        self._rows_done = start
        if not chunk:
            self._state = body(self._state, *args)
            self._rows_done = n
            return
        st = self._state
        for lo in range(start, n, chunk):
            hi = min(lo + chunk, n)
            if spans is not None:
                spans.enter("ingest.slice_s")
            part = _slice_streams(st, n, lo, hi)
            part_args = [_slice_streams(a, n, lo, hi) for a in args]
            if spans is not None:
                spans.exit()
            out = body(part, *part_args)
            if spans is not None:
                spans.enter("ingest.copy_back_s")
            for f in LEAVES:
                getattr(st, f)[lo:hi].copy_(getattr(out, f))
            if spans is not None:
                spans.exit()
            self._rows_done = hi

    def _invalidate_plans(self) -> None:
        self._window_plan = None
        self._tile_plans = {}

    # -- query ---------------------------------------------------------------
    def _query_choice(self, qs_tuple: tuple, disabled: frozenset = frozenset(), sp=None):
        """The query dispatch -> ``(tier, fn)``: ``overlap``/``tiles``/
        ``windowed`` on the kernel path (``kernels.choose_query_engine``;
        overlap while ``kernels.overlap_enabled()`` and neither the caller
        nor the demotion ladder has disabled it), else ``wxla`` for
        128-aligned windows, else ``xla``: ``kernels.floor_quantile`` (K2
        on the card), or ``batched.quantile`` on the ``plain`` engine.
        Each plan costs one small host fetch after a state mutation and is
        cached.  ``sp`` is the query's spans (or None): the plans and the
        route's kernel call take it."""
        from sketches_tpu_torch import kernels

        if self._query_disabled:
            disabled = self._query_disabled | disabled
        spec = self.spec
        if self._kernel_query and "windowed" not in disabled:
            if self._window_plan is None:
                self._window_plan = kernels.plan_state_window(spec, self.state, spans=sp)
            lo_w, n_w, w_t, with_neg = self._window_plan
            if "tiles" not in disabled and kernels.tile_query_eligible(
                spec, len(qs_tuple), self._window_plan
            ):
                plan = self._tile_plans.get(qs_tuple)
                if plan is None:
                    plan = kernels.plan_tile_query(
                        spec, self.state, self._qs_tensor(qs_tuple), spans=sp
                    )
                    self._tile_plans[qs_tuple] = plan
                k_tiles, with_neg_t = plan
                pick = kernels.choose_query_engine(
                    self._window_plan,
                    plan,
                    overlap_ok=kernels.overlap_enabled() and "overlap" not in disabled,
                )
                if pick == "overlap":
                    return "overlap", functools.partial(
                        kernels.fused_quantile_tiles_overlap,
                        spec,
                        k_tiles=k_tiles,
                        with_neg=with_neg_t,
                        spans=sp,
                    )
                if pick == "tiles":
                    return "tiles", functools.partial(
                        kernels.fused_quantile_tiles,
                        spec,
                        k_tiles=k_tiles,
                        with_neg=with_neg_t,
                        spans=sp,
                    )
            return "windowed", functools.partial(
                _windowed_call, spec, lo_w, n_w, w_t, with_neg, spans=sp
            )
        if self._wxla_ok and "wxla" not in disabled:
            if self._window_plan is None:
                self._window_plan = kernels.plan_state_window(spec, self.state, spans=sp)
            lo_w, n_w, w_t, with_neg = self._window_plan
            return "wxla", functools.partial(
                _wxla_call, spec, lo_w * w_t, n_w * w_t, with_neg
            )
        if self._engine_request == "plain":
            return "xla", functools.partial(quantile, spec)
        return "xla", functools.partial(_floor_call, spec, sp)

    def _run_query(self, qs_tuple: tuple, disabled: frozenset = frozenset()):
        """Dispatch a query down the tier ladder -> ``(tier, values)``.

        A failing tier (or an armed ``pallas.lowering`` fault) demotes this
        facade to the next tier, recorded in ``resilience.health()``, and
        the query retries there (``resilience.demote_query``); the ``xla``
        floor re-raises, and so does a real kernel error on the card.  Queries do
        not mutate the state, so a retry is always sound.  The ``query_s``
        span covers the whole call, plans and retries included, and the
        spans inside it name the plans, the operands and the route kernel
        (``telemetry.call_spans``).
        """
        with telemetry.call_spans("query_s") as sp:
            tier, out, _p0 = self._run_query_tiers(qs_tuple, disabled, sp)
            if sp is not None:
                sp.labels = {"component": "batched", "tier": tier}
        if _p0 is not None:
            profiling.record("query", tier, _p0, out)
        if tracing._ACTIVE:
            # The resolved rung, on the request's trace: the forensic
            # answer to "which engine actually served".
            tracing.record_event("engine.query", tier=tier, component="batched")
        return tier, out

    def _qs_tensor(self, qs_tuple: tuple) -> torch.Tensor:
        """The device copy of a quantile list, made once: a host-to-device
        copy waits for the stream."""
        qs = self._qs_tensors.get(qs_tuple)
        if qs is None:
            qs = torch.tensor(qs_tuple, dtype=torch.float32, device=self.device)
            self._qs_tensors[qs_tuple] = qs
        return qs

    def _run_query_tiers(self, qs_tuple: tuple, disabled: frozenset, sp):
        qs = self._qs_tensor(qs_tuple)
        while True:
            tier, fn = self._query_choice(qs_tuple, disabled, sp)
            try:
                if faults._ACTIVE:
                    faults.inject(faults.PALLAS_LOWERING, tier=tier)
                _p0 = telemetry.clock() if profiling._ACTIVE else None
                return tier, fn(self.state, qs), _p0
            except Exception as e:
                if sp is not None:
                    sp.unwind()
                if not resilience.demote_query(
                    self._health_component, self._query_disabled, tier, e,
                    self.device.type == "cuda",
                ):
                    raise

    def get_quantile_value(self, quantile: float) -> torch.Tensor:
        """Per-stream value at ``quantile`` -> ``[n_streams]`` (NaN if empty)."""
        return self._run_query((float(quantile),))[1][:, 0]

    def get_quantile_values(self, quantiles: Sequence[float]) -> torch.Tensor:
        """Fused multi-quantile -> ``[n_streams, Q]``."""
        return self._run_query(tuple(float(q) for q in quantiles))[1]

    def get_quantile_values_resolved(
        self, quantiles: Sequence[float], disabled_tiers: Sequence[str] = ()
    ):
        """Fused multi-quantile that also names the tier that answered ->
        ``(tier, [n_streams, Q])``; ``disabled_tiers`` excludes tiers for
        this call only, on top of the facade's own demotions."""
        return self._run_query(
            tuple(float(q) for q in quantiles), frozenset(disabled_tiers)
        )

    # -- merge / window ------------------------------------------------------
    def mergeable(self, other: "BatchedDDSketch") -> bool:
        return self.spec == other.spec

    def merge(self, other: "BatchedDDSketch") -> "BatchedDDSketch":
        """Fold ``other`` into self, alignment-safe (``merge_aligned``)."""
        if not self.mergeable(other):
            raise UnequalSketchParametersError(
                "Cannot merge two batched sketches with different specs"
            )
        _t0 = telemetry.clock() if telemetry._ACTIVE else None
        _p0 = telemetry.clock() if profiling._ACTIVE else None
        # Guarded integrity seam: fingerprint the operands before the
        # in-place merge, verify the result against them after.
        _ipre = (
            integrity.premerge(self.spec, self.state, other.state)
            if integrity._ACTIVE
            else None
        )
        self._stream_op(functools.partial(_merge_aligned_body, self.spec), other.state)
        if _ipre is not None:
            integrity.postmerge(self.spec, self.state, _ipre, seam="batched.merge")
        if _t0 is not None:
            telemetry.finish_span("merge_s", _t0, component="batched")
        if _p0 is not None:
            profiling.record("fold", "merge", _p0, self.state)
        self._invalidate_plans()
        if self._auto_recenter_pending and bool((other.state.count > 0).any()):
            self._auto_recenter_pending = False
        return self

    def recenter(self, new_key_offset) -> "BatchedDDSketch":
        """Slide the window(s) to ``new_key_offset`` (scalar or [n_streams])."""
        self._state = recenter(self.spec, self.state, new_key_offset)
        self._invalidate_plans()
        return self

    def recenter_to_data(self) -> "BatchedDDSketch":
        """Recenter each stream's window on its binned-mass median key."""
        self._state = recenter_to_data(self.spec, self.state)
        self._invalidate_plans()
        return self

    def overflow_risk(self):
        """(max accumulator mass [N], fraction of the exact ceiling [N])."""
        return overflow_risk(self.spec, self.state)

    def collapsed_fraction(self) -> torch.Tensor:
        """Per-stream fraction of binned mass that hit a window edge -> [N]."""
        st = self.state
        binned = (st.count - st.zero_count).to(self.spec.dtype)
        collapsed = (st.collapsed_low + st.collapsed_high).to(self.spec.dtype)
        return collapsed / torch.clamp(binned, min=1)

    def maybe_recenter(self, threshold: float = 0.01) -> bool:
        """Arm a recenter, on the next batch's median key, for streams whose
        collapse grew by more than ``threshold`` of their binned-mass growth
        since the previous call.  Returns whether any stream armed."""
        st = self.state
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

    # -- accessors -----------------------------------------------------------
    @property
    def state(self) -> SketchState:
        return self._state

    @state.setter
    def state(self, new_state: SketchState) -> None:
        # The external choke point: plans describing the old state are
        # dropped, the recenter policy re-baselines, an armed mask goes.
        if new_state.device != self.device:
            raise SpecError(f"state lives on {new_state.device}, not on {self.device}")
        self._state = new_state
        self._invalidate_plans()
        self._policy_stale = True
        self._pending_recenter_mask = None

    @property
    def n_streams(self) -> int:
        return self.state.n_streams

    @property
    def count(self) -> torch.Tensor:
        return self.state.count

    @property
    def num_values(self) -> torch.Tensor:
        return self.state.count

    @property
    def sum(self) -> torch.Tensor:  # noqa: A003 - reference API name
        return self.state.sum

    @property
    def avg(self) -> torch.Tensor:
        return self.state.sum / self.state.count

    @property
    def relative_accuracy(self) -> float:
        return self.spec.relative_accuracy

    def copy(self) -> "BatchedDDSketch":
        new = BatchedDDSketch(
            self.n_streams,
            spec=self.spec,
            state=self.state.map(torch.clone),
            engine=self._engine_request,
            device=self.device,
        )
        new._auto_recenter_pending = self._auto_recenter_pending
        new._pending_recenter_mask = (
            None if self._pending_recenter_mask is None else self._pending_recenter_mask.copy()
        )
        new._policy_collapsed = self._policy_collapsed.copy()
        new._policy_binned = self._policy_binned.copy()
        new._policy_stale = self._policy_stale
        # A demoted tier stays demoted in the copy (the failure is a
        # property of the environment, not of the instance).
        new._query_disabled = set(self._query_disabled)
        return new

    def __repr__(self) -> str:
        return (
            f"BatchedDDSketch(n_streams={self.n_streams},"
            f" n_bins={self.spec.n_bins},"
            f" relative_accuracy={self.spec.relative_accuracy},"
            f" mapping={self.spec.mapping_name!r}, device={self.device})"
        )


# ---------------------------------------------------------------------------
# Host interop
# ---------------------------------------------------------------------------


def to_host_sketches(spec: SketchSpec, state: SketchState):
    """Each stream as a host-tier sketch (for serde and interop).

    Returns a list of ``ddsketch.BaseDDSketch`` with the spec's mapping and
    collapsing-lowest stores holding the same bin masses at the same keys;
    the device-only collapse counters ride along as ``_collapsed_low`` /
    ``_collapsed_high`` so :func:`from_host_sketches` can round-trip them.
    Stores are built directly from numpy row slices of the occupied span:
    the state organic ``store.add`` growth would reach.
    """
    from sketches_tpu_torch.ddsketch import BaseDDSketch
    from sketches_tpu_torch.store import CollapsingLowestDenseStore

    (bins_pos, bins_neg, zero_count, count, total, vmin, vmax, clow, chigh, koff) = (
        getattr(state, f).cpu().numpy()
        for f in ("bins_pos", "bins_neg", "zero_count", "count", "sum", "min", "max",
                  "collapsed_low", "collapsed_high", "key_offset")
    )
    bins_pos = bins_pos.astype(np.float64)
    bins_neg = bins_neg.astype(np.float64)
    plo, phi = occupied_bounds_np(bins_pos)
    nlo, nhi = occupied_bounds_np(bins_neg)
    # Per-store masses from the bins (the counters may differ from them in
    # f32 rounding; the stores carry the bins' truth).
    pos_count = bins_pos.sum(axis=-1)
    neg_count = bins_neg.sum(axis=-1)
    mapping = mapping_from_name(spec.mapping_name, spec.relative_accuracy)

    def load_store(store, row, lo, hi, mass, off):
        if hi < 0:  # empty store
            return
        lo_k, hi_k = int(lo + off), int(hi + off)
        length = store._get_new_length(lo_k, hi_k)
        seg = np.zeros(length, np.float64)
        seg[: hi - lo + 1] = row[lo : hi + 1]
        store.bins = seg.tolist()
        store.offset = lo_k
        store.min_key = lo_k
        store.max_key = hi_k
        store.count = float(mass)

    sketches = []
    for i in range(state.n_streams):
        sk = BaseDDSketch(
            mapping=mapping,
            store=CollapsingLowestDenseStore(spec.n_bins),
            negative_store=CollapsingLowestDenseStore(spec.n_bins),
        )
        off = int(koff[i])
        load_store(sk.store, bins_pos[i], plo[i], phi[i], pos_count[i], off)
        load_store(sk.negative_store, bins_neg[i], nlo[i], nhi[i], neg_count[i], off)
        sk._zero_count = float(zero_count[i])
        sk._count = float(count[i])
        sk._sum = float(total[i])
        sk._min = float(vmin[i])
        sk._max = float(vmax[i])
        sk._collapsed_low = float(clow[i])
        sk._collapsed_high = float(chigh[i])
        sketches.append(sk)
    return sketches


def from_host_sketches(spec: SketchSpec, sketches, device=None) -> SketchState:
    """Pack host-tier sketches into one batched state on ``device`` (the
    card by default), on the spec's default window.

    Keys outside the window clamp to the edge bins (mass conserved, the
    collapse counters record it), mirroring ingest-side collapse.  A
    sketch whose mapping differs from the spec's raises
    ``UnequalSketchParametersError``.
    """
    n = len(sketches)
    # f64 staging: host masses are exact Python floats, and an f32
    # intermediate would round counts past 2**24 before the final cast.
    bins_pos = np.zeros((n, spec.n_bins), dtype=np.float64)
    bins_neg = np.zeros((n, spec.n_bins), dtype=np.float64)
    zero = np.zeros((n,), dtype=np.float64)
    count = np.zeros((n,), dtype=np.float64)
    total = np.zeros((n,), dtype=np.float64)
    vmin = np.full((n,), np.inf, dtype=np.float64)
    vmax = np.full((n,), -np.inf, dtype=np.float64)
    clow = np.zeros((n,), dtype=np.float64)
    chigh = np.zeros((n,), dtype=np.float64)
    for i, sk in enumerate(sketches):
        # Same gamma is not enough: the mappings share gamma at equal alpha
        # but key differently, so only identical mappings are compatible.
        if sk.mapping != spec.mapping:
            raise UnequalSketchParametersError(
                f"Host sketch mapping {sk.mapping!r} does not match batched"
                f" spec mapping {spec.mapping!r}"
            )
        for arr, store in ((bins_pos, sk.store), (bins_neg, sk.negative_store)):
            # The store's dense run lands as one slice; out-of-window mass
            # folds into the edge bins.
            row = np.asarray(store.bins, np.float64)
            if row.size == 0:
                continue
            j = np.arange(row.size) + (store.offset - spec.key_offset)
            low = j < 0
            high = j >= spec.n_bins
            mid = ~(low | high)
            low_mass = float(row[low].sum())
            high_mass = float(row[high].sum())
            arr[i, 0] += low_mass
            clow[i] += low_mass
            arr[i, -1] += high_mass
            chigh[i] += high_mass
            arr[i, j[mid]] += row[mid]  # consecutive (unique) indices
        zero[i] = sk.zero_count
        count[i] = sk.count
        total[i] = sk.sum
        vmin[i] = sk._min
        vmax[i] = sk._max
        # Round-trip the device-only collapse counters when present.
        clow[i] += getattr(sk, "_collapsed_low", 0.0)
        chigh[i] += getattr(sk, "_collapsed_high", 0.0)
    return arrays_to_state(
        spec, bins_pos, bins_neg, zero, count, total, vmin, vmax, clow, chigh, device=device
    )


def arrays_to_state(
    spec: SketchSpec,
    bins_pos: np.ndarray,
    bins_neg: np.ndarray,
    zero: np.ndarray,
    count: np.ndarray,
    total: np.ndarray,
    vmin: np.ndarray,
    vmax: np.ndarray,
    clow: np.ndarray,
    chigh: np.ndarray,
    device=None,
) -> SketchState:
    """Pack host (f64) interop arrays into a state on ``device`` (the card
    by default, ``SpecError`` without one), on the spec's default window:
    the shared tail of every host-to-device lift (:func:`from_host_sketches`,
    ``pb.wire``'s bulk decode).  The derived counters (occupied bounds,
    neg_total, tile sums) are recomputed from the bins, and masses cast to
    the spec's bin dtype (rounded for integer bins: fractional host weights
    are outside integer mode's contract).
    """
    dev = resolve_device(device)
    n = bins_pos.shape[0]
    bd = np.dtype(_dtype_name(spec.bin_dtype))
    if np.issubdtype(bd, np.integer):
        def cast(a):
            return np.rint(a).astype(bd)
    else:
        def cast(a):
            return a.astype(bd)
    dt = np.dtype(_dtype_name(spec.dtype))
    pos_lo, pos_hi = occupied_bounds_np(bins_pos)
    neg_lo, neg_hi = occupied_bounds_np(bins_neg)
    host = dict(
        bins_pos=cast(bins_pos),
        bins_neg=cast(bins_neg),
        zero_count=cast(zero),
        count=cast(count),
        sum=total.astype(dt),
        min=vmin.astype(dt),
        max=vmax.astype(dt),
        collapsed_low=cast(clow),
        collapsed_high=cast(chigh),
        key_offset=np.full((n,), spec.key_offset, dtype=np.int32),
        pos_lo=pos_lo,
        pos_hi=pos_hi,
        neg_lo=neg_lo,
        neg_hi=neg_hi,
        neg_total=cast(bins_neg.sum(axis=-1)),
        tile_sums=cast(tile_sums_np(bins_pos, bins_neg)),
    )
    return SketchState(**{f: torch.from_numpy(host[f]).to(dev) for f in LEAVES})


def _windowed_call(spec, lo_w, n_w, w_t, with_neg, state, qs, spans=None):
    from sketches_tpu_torch import kernels

    return kernels.fused_quantile_windowed(
        spec, state, qs, lo_w, n_wblocks=n_w, w_tiles=w_t, with_neg=with_neg, spans=spans
    )


def _floor_call(spec, spans, state, qs):
    """The ``xla`` floor of the kernel engine (``kernels.floor_quantile``:
    K2 on the card), named ``query.kernel_s`` in the query's spans."""
    from sketches_tpu_torch import kernels

    if spans is not None:
        spans.enter("query.kernel_s")
    out = kernels.floor_quantile(spec, state, qs)
    if spans is not None:
        spans.exit()
    return out


def _wxla_call(spec, lo_tile, n_tiles_window, with_neg, state, qs):
    from sketches_tpu_torch import kernels

    return kernels.quantile_windowed_xla(
        spec, state, qs, lo_tile, n_tiles_window=n_tiles_window, with_neg=with_neg
    )
