"""Hand-written CUDA kernels for Hopper, their plain versions and the plans
around them (counterpart of ``sketches_tpu/kernels.py``).

Five kernels carry the port's paths (``csrc/``):

* ``ingest_histogram`` -- fused ingest (replaces ``_ingest_kernel``);
* ``fused_quantile`` -- full-window query (``_quantile_kernel``), the
  floor tier of the distributed facade on the kernel engine;
* ``fused_quantile_windowed`` -- occupied-window query (``_windowed_kernel``);
* ``fused_quantile_tiles`` -- tile-list query (``_tiles_kernel`` +
  ``_count_and_decode``);
* ``fused_quantile_tiles_overlap`` -- the tile-list walk through an
  asynchronous-copy ring (``_overlap_kernel``), the facades' default tier.

Each wrapper launches its kernel for tensors on a CUDA device and runs its
plain PyTorch version (``*_plain`` beside it) for tensors on the CPU; on
any other device it raises.  There is no fallback from a kernel to its
plain version.  Every launch adds one to the wrapper's ``launches``
counter, and every host fetch on the facades' add and query paths (a
device-to-host read, which waits for the stream) one to its site's count
(:func:`launch_counts`, :func:`reset_launch_counts`); nothing else touches
them.  The facade passes its call's spans (``telemetry.call_spans``, or
``None``) to ``add``, the plans and the tile and windowed query kernels
as ``spans=``: each names its layer inside the call (``ingest.k1_s``,
``ingest.fold_s``, ``query.plan_window_s``, ``query.plan_tiles_s``,
``query.operands_s``, ``query.kernel_s``).

The plans (``plan_window``, ``plan_state_window``, ``plan_tile_query``,
``tile_query_eligible``, ``choose_query_engine``) are the JAX package's,
so the port routes a query to the same tier for the same state.  The
overlap switch, ``SKETCHES_TPU_OVERLAP`` (:func:`overlap_enabled`), and the
packed-ingest switch, ``SKETCHES_TPU_INGEST_PACKED``
(:func:`packed_ingest_enabled`), both declared in ``analysis/registry.py``
with every other switch, are the environment variables the kernels read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sketches_tpu_torch import _build
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.batched import (
    SketchSpec,
    SketchState,
    _as_qs,
    _clip,
    _keys_and_masks,
    _weights_like,
    cumsum_f32,
)
from sketches_tpu_torch.resilience import EngineUnavailable, SketchValueError, SpecError

__all__ = [
    "supports",
    "select_engine",
    "INGEST_VARIANTS",
    "ingest_variant_supported",
    "packed_ingest_enabled",
    "INGEST_PACKED_ENV",
    "choose_ingest_engine",
    "ingest_histogram",
    "ingest_histogram_plain",
    "fused_quantile",
    "fused_quantile_plain",
    "floor_quantile",
    "fused_quantile_windowed",
    "fused_quantile_windowed_plain",
    "fused_quantile_tiles",
    "fused_quantile_tiles_plain",
    "fused_quantile_tiles_overlap",
    "fused_quantile_tiles_overlap_plain",
    "quantile_windowed_xla",
    "plan_window",
    "plan_state_window",
    "window_stats",
    "plan_tile_query",
    "tile_query_eligible",
    "choose_query_engine",
    "overlap_enabled",
    "OVERLAP_ENV",
    "launch_counts",
    "reset_launch_counts",
    "add",
]

LO = 128  # bins per column tile
_BN = 128  # stream quantum of the engine (kept for plan parity)
_BS = 128  # value quantum of a batch

#: The JAX package's four ingest construction rungs.  They are TPU answers
#: (how the one-hot matmul operands are built) with bit-identical outputs;
#: on Hopper one kernel serves all four.  Kept so variant names validate
#: exactly as there.
INGEST_VARIANTS = ("stock", "packed", "hifold", "cmpfree")

#: The packed-ingest kill switch's environment name.
INGEST_PACKED_ENV = registry.INGEST_PACKED.name


def ingest_variant_supported(spec: SketchSpec, variant: str, weighted: bool) -> bool:
    """Whether ``variant`` can serve this (spec, weightedness): ``stock``
    serves everything, the other rungs unit-weight calls only."""
    if variant not in INGEST_VARIANTS:
        raise SpecError(
            f"Unknown ingest variant {variant!r}; expected one of {INGEST_VARIANTS}"
        )
    return variant == "stock" or not weighted


def packed_ingest_enabled() -> bool:
    """Whether the facades may select a non-stock ingest rung: the
    ``SKETCHES_TPU_INGEST_PACKED`` kill switch (``0`` pins every auto pick
    to ``stock``), read at each call as the JAX package reads it."""
    return registry.enabled(registry.INGEST_PACKED)


def choose_ingest_engine(spec: SketchSpec, weighted: bool, variant: Optional[str] = None) -> str:
    """The JAX facades' rung policy: ``packed`` for unit-weight calls while
    the ``SKETCHES_TPU_INGEST_PACKED`` kill switch allows it, ``stock``
    otherwise; an explicit ``variant`` is validated and honoured.  K1
    computes every rung's contract, so the rung only labels the call."""
    if variant is not None:
        if not ingest_variant_supported(spec, variant, weighted):
            raise SpecError(
                f"ingest variant {variant!r} does not support"
                f" weighted={weighted} (unit-weight construction only)"
            )
        return variant
    if weighted or not packed_ingest_enabled():
        return "stock"
    return "packed"


def supports(spec: SketchSpec, n_streams: int, batch: Optional[int] = None) -> bool:
    """Whether the kernel path can run this configuration."""
    return (
        spec.n_bins % LO == 0
        and spec.n_bins >= LO
        and spec.dtype == torch.float32
        and n_streams % _BN == 0
        and (batch is None or batch % _BS == 0)
    )


def select_engine(spec: SketchSpec, n_streams: int, engine: str, device) -> bool:
    """Whether a facade takes the kernel path.

    ``auto`` takes it whenever :func:`supports` allows (on a CPU device the
    wrappers then run the plain versions); ``kernel`` demands it and a CUDA
    device, and raises ``SpecError`` otherwise; ``plain`` never takes it.
    """
    if engine not in ("auto", "kernel", "plain"):
        raise SpecError(f"Unknown engine {engine!r}; expected 'auto', 'kernel' or 'plain'")
    supported = supports(spec, n_streams)
    if engine == "kernel":
        if not supported:
            raise SpecError(
                "engine='kernel' requires f32 state, 128-aligned n_bins and a"
                f" 128-aligned stream count; got {spec} with n_streams={n_streams}"
            )
        if torch.device(device).type != "cuda":
            raise SpecError(f"engine='kernel' runs on a CUDA device, not on {device}")
    return engine == "kernel" or (engine == "auto" and supported)


# Packed scalar-column layout of the ingest's third output (kernels._COL).
_COL = {
    "zero": 0, "count": 1, "sum": 2, "min": 3, "max": 4,
    "clow": 5, "chigh": 6, "pos_lo": 7, "pos_hi": 8,
    "neg_lo": 9, "neg_hi": 10, "neg_total": 11,
}
_TILE0 = 16  # first tile-sum column (12 scalars + 4 pad)
# Shared memory one Hopper block may opt into (kSmemLimit in csrc/ingest.cu,
# quantile.cu and overlap.cu; analysis/kernel_audit.py holds them equal):
# the ingest keeps a stream's two histograms there, the overlap walk its ring.
_SMEM_BYTES = 232448


def _ncols(n_tiles: int) -> int:
    """Packed-cols width: 16 scalar columns + 2T tile columns, rounded up to
    a multiple of 8."""
    return _TILE0 + ((2 * n_tiles + 7) // 8) * 8


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

_ENTRY_ARGS = {
    "sk_ingest": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "sk_quantile": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "sk_windowed": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "sk_tiles": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "sk_overlap": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}
_ENTRY_SOURCE = {
    "sk_ingest": "ingest.cu",
    "sk_quantile": "quantile.cu",
    "sk_windowed": "windowed.cu",
    "sk_tiles": "tiles.cu",
    "sk_overlap": "overlap.cu",
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.library(_ENTRY_SOURCE[name]), name)
    fn.argtypes = _ENTRY_ARGS[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _mapping_consts(spec_mapping, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(spec_mapping.kernel_constants()).to(device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise SketchValueError(f"{name} lives on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise SketchValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise SketchValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise SketchValueError(f"{name} must be contiguous")


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise SpecError(f"{what} runs on CUDA or CPU tensors, not on {t.device}")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise EngineUnavailable(f"{name} launch failed with CUDA error {err}")


#: Host fetches since the last :func:`reset_launch_counts`, by site: the
#: device-to-host reads of the facades' add and query paths, each of which
#: waits for the stream to drain.  ``window_stats`` and ``plan_tile_query``
#: are the two plans' fetches, ``overlap_lists`` K5's check of its tile
#: lists on the card, ``add_policy`` the collapse re-read of an ``add`` that
#: recentres by ``maybe_recenter``'s policy, ``add_validated`` its weight
#: check.
_FETCHES = dict.fromkeys(
    ("window_stats", "plan_tile_query", "overlap_lists", "add_policy", "add_validated"), 0
)


def launch_counts() -> dict:
    """Kernel launches and host fetches since the last
    :func:`reset_launch_counts`: each kernel wrapper's launches under its
    name (K1's weighted ones also apart, in
    ``ingest_histogram.weighted_launches``), and each host fetch site's
    count under ``fetch.<site>`` (:data:`_FETCHES`)."""
    counts = {f.__name__: f.launches for f in _KERNEL_WRAPPERS}
    counts.update({"fetch." + site: n for site, n in _FETCHES.items()})
    return counts


def reset_launch_counts() -> None:
    for f in _KERNEL_WRAPPERS:
        f.launches = 0
    ingest_histogram.weighted_launches = 0
    for site in _FETCHES:
        _FETCHES[site] = 0


# ---------------------------------------------------------------------------
# K1: fused ingest
# ---------------------------------------------------------------------------


def ingest_histogram(
    spec: SketchSpec,
    values: torch.Tensor,
    weights: Optional[torch.Tensor],
    key_offset: torch.Tensor,
    *,
    weighted: bool = True,
    variant: str = "stock",
):
    """One pass over a value batch -> ``(hist_pos, hist_neg, cols)``.

    ``values``/``weights``: [n, S] f32 (``weights`` is ignored, and may be
    None, when ``weighted=False``); ``key_offset``: [n] int32 window edges.
    Returns this batch's two [n, n_bins] f32 histograms and the packed
    [n, ncols] f32 column block (layout ``_COL``, tile masses from
    ``_TILE0``).  CUDA tensors run ``csrc/ingest.cu``; CPU tensors run
    :func:`ingest_histogram_plain`.
    """
    if not ingest_variant_supported(spec, variant, weighted):
        raise SpecError(
            f"ingest variant {variant!r} does not support weighted calls"
            " (unit-weight construction only)"
        )
    if spec.n_bins % LO != 0:
        raise SpecError("the ingest kernel requires 128-aligned n_bins")
    if not _on_cuda(values, "ingest_histogram"):
        return ingest_histogram_plain(spec, values, weights, key_offset, weighted=weighted)
    if 2 * spec.n_bins * 4 > _SMEM_BYTES:
        raise SpecError(
            f"n_bins={spec.n_bins}: one stream's two histograms do not fit the"
            f" {_SMEM_BYTES} bytes of shared memory a block may use"
        )
    n, s = values.shape
    dev = values.device
    ncols = _ncols(spec.n_tiles)
    _check(values, "values", torch.float32, (n, s), dev)
    if weighted:
        _check(weights, "weights", torch.float32, (n, s), dev)
    _check(key_offset, "key_offset", torch.int32, (n,), dev)
    hist_pos = torch.empty((n, spec.n_bins), dtype=torch.float32, device=dev)
    hist_neg = torch.empty_like(hist_pos)
    cols = torch.empty((n, ncols), dtype=torch.float32, device=dev)
    _launch(
        "sk_ingest", dev,
        _ptr(values), _ptr(weights) if weighted else None, _ptr(key_offset),
        _ptr(hist_pos), _ptr(hist_neg), _ptr(cols),
        _ptr(_mapping_consts(spec.mapping, dev)),
        spec.mapping.kernel_id, n, s, spec.n_bins, ncols,
    )
    ingest_histogram.launches += 1
    ingest_histogram.weighted_launches += int(weighted)
    return hist_pos, hist_neg, cols


def ingest_histogram_plain(spec, values, weights, key_offset, *, weighted=True):
    """Plain PyTorch version of :func:`ingest_histogram`: ``scatter_add_``
    histograms and row reductions (the same outputs, any device)."""
    v = values.to(torch.float32)
    n = v.shape[0]
    w = _weights_like(spec, v, weights if weighted else None)
    idx, is_pos, is_neg, is_zero, clamped_low, clamped_high = _keys_and_masks(
        spec, key_offset, v
    )
    live = w > 0
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    w_pos = torch.where(is_pos & live, w, zero)
    w_neg = torch.where(is_neg & live, w, zero)
    w_zero = torch.where(is_zero & live, w, zero)
    w_live = w_pos + w_neg + w_zero
    signed = w_pos + w_neg
    finite_live = live & ~torch.isnan(v)
    idx64 = idx.to(torch.int64)
    hist_pos = torch.zeros((n, spec.n_bins), dtype=torch.float32, device=v.device)
    hist_neg = torch.zeros_like(hist_pos)
    hist_pos.scatter_add_(1, idx64, w_pos)
    hist_neg.scatter_add_(1, idx64, w_neg)
    idx_f = idx.to(torch.float32)
    nb = float(spec.n_bins)
    hits_pos, hits_neg = live & is_pos, live & is_neg
    inf = float("inf")
    cols = torch.zeros((n, _ncols(spec.n_tiles)), dtype=torch.float32, device=v.device)
    cols[:, _COL["zero"]] = w_zero.sum(-1)
    cols[:, _COL["count"]] = w_live.sum(-1)
    cols[:, _COL["sum"]] = (torch.where(live, v, zero) * w_live).sum(-1)
    cols[:, _COL["min"]] = torch.where(finite_live, v, inf).amin(-1)
    cols[:, _COL["max"]] = torch.where(finite_live, v, -inf).amax(-1)
    cols[:, _COL["clow"]] = torch.where(clamped_low, signed, zero).sum(-1)
    cols[:, _COL["chigh"]] = torch.where(clamped_high, signed, zero).sum(-1)
    cols[:, _COL["pos_lo"]] = torch.where(hits_pos, idx_f, nb).amin(-1)
    cols[:, _COL["pos_hi"]] = torch.where(hits_pos, idx_f, -1.0).amax(-1)
    cols[:, _COL["neg_lo"]] = torch.where(hits_neg, idx_f, nb).amin(-1)
    cols[:, _COL["neg_hi"]] = torch.where(hits_neg, idx_f, -1.0).amax(-1)
    cols[:, _COL["neg_total"]] = w_neg.sum(-1)
    t = spec.n_tiles
    cols[:, _TILE0 : _TILE0 + t] = hist_pos.reshape(n, t, LO).sum(-1)
    cols[:, _TILE0 + t : _TILE0 + 2 * t] = hist_neg.reshape(n, t, LO).sum(-1)
    return hist_pos, hist_neg, cols


def add(
    spec: SketchSpec,
    state: SketchState,
    values: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    variant: Optional[str] = None,
    spans=None,
) -> SketchState:
    """Drop-in replacement for ``batched.add`` through the fused ingest.

    The kernel emits f32 per-call deltas; they fold into the state here,
    in the state's own bin dtype.  Integer bins take unit-weight calls only
    (their f32 deltas are exact integers below 2**24).  ``spans`` (the
    facade's call spans, or None) names K1's preparation and launch
    ``ingest.k1_s`` and the fold ``ingest.fold_s``.
    """
    if spans is not None:
        spans.enter("ingest.k1_s")
    v = values.to(spec.dtype).contiguous()
    if spec.bins_integer:
        if weights is not None:
            raise NotImplementedError(
                "kernel add with integer bins supports unit-weight calls"
                " only; weighted integer-mode ingest uses batched.add"
            )
        if v.shape[-1] >= 1 << 24:
            raise NotImplementedError(
                "kernel add with integer bins needs per-call batch width"
                " < 2**24 to keep f32 deltas exact"
            )
    w = None if weights is None else _weights_like(spec, v, weights).contiguous()
    hist_pos, hist_neg, cols = ingest_histogram(
        spec, v, w, state.key_offset,
        weighted=weights is not None,
        variant=choose_ingest_engine(spec, weights is not None, variant),
    )
    if spans is not None:
        spans.exit()
        spans.enter("ingest.fold_s")

    def col(name):
        return cols[:, _COL[name]]

    bd = state.bins_pos.dtype
    out = SketchState(
        bins_pos=state.bins_pos + hist_pos.to(bd),
        bins_neg=state.bins_neg + hist_neg.to(bd),
        zero_count=state.zero_count + col("zero").to(bd),
        count=state.count + col("count").to(bd),
        sum=state.sum + col("sum"),
        min=torch.minimum(state.min, col("min")),
        max=torch.maximum(state.max, col("max")),
        collapsed_low=state.collapsed_low + col("clow").to(bd),
        collapsed_high=state.collapsed_high + col("chigh").to(bd),
        key_offset=state.key_offset,
        pos_lo=torch.minimum(state.pos_lo, col("pos_lo").to(torch.int32)),
        pos_hi=torch.maximum(state.pos_hi, col("pos_hi").to(torch.int32)),
        neg_lo=torch.minimum(state.neg_lo, col("neg_lo").to(torch.int32)),
        neg_hi=torch.maximum(state.neg_hi, col("neg_hi").to(torch.int32)),
        neg_total=state.neg_total + col("neg_total").to(bd),
        tile_sums=state.tile_sums + cols[:, _TILE0 : _TILE0 + 2 * spec.n_tiles].to(bd),
    )
    if spans is not None:
        spans.exit()
    return out


# ---------------------------------------------------------------------------
# K2: full-window multi-quantile query
# ---------------------------------------------------------------------------


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read 16-byte vectors: a view must start on a 16-byte
    boundary."""
    if t.data_ptr() % 16:
        raise SketchValueError(f"{name} must start on a 16-byte boundary")


def fused_quantile(spec: SketchSpec, state: SketchState, qs) -> torch.Tensor:
    """All requested quantiles for every stream, reading both stores whole
    -> [N, Q].

    Semantics of ``batched.quantile`` (NaN for empty streams or q outside
    [0, 1]), with the occupied bounds and the negative total taken from the
    bins themselves as the TPU kernel does.  CUDA tensors run
    ``csrc/quantile.cu``; CPU tensors run :func:`fused_quantile_plain`.
    Integer bins raise ``NotImplementedError`` (they query through
    ``batched.quantile``, whose integer compare never rounds).
    """
    n = state.n_streams
    if spec.bins_integer:
        raise NotImplementedError(
            "fused_quantile requires float bins; integer-bin specs query"
            " via batched.quantile (the facades route this automatically)"
        )
    qs = _as_qs(qs, state.device)
    q_total = qs.shape[0]
    if q_total == 0:
        return torch.zeros((n, 0), dtype=torch.float32, device=state.device)
    if not _on_cuda(state.bins_pos, "fused_quantile"):
        return fused_quantile_plain(spec, state, qs)
    dev = state.device
    shape = (n, spec.n_bins)
    for name in ("bins_pos", "bins_neg"):
        _check(getattr(state, name), name, torch.float32, shape, dev)
        _check_aligned(getattr(state, name), name)
    for name in ("zero_count", "count"):
        _check(getattr(state, name), name, torch.float32, (n,), dev)
    _check(state.key_offset, "key_offset", torch.int32, (n,), dev)
    qs = qs.contiguous()
    out = torch.empty((n, q_total), dtype=torch.float32, device=dev)
    _launch(
        "sk_quantile", dev,
        _ptr(state.bins_pos), _ptr(state.bins_neg), _ptr(state.zero_count),
        _ptr(state.count), _ptr(state.key_offset), _ptr(qs), _ptr(out),
        _ptr(_mapping_consts(spec.mapping, dev)),
        spec.mapping.kernel_id, n, spec.n_bins, q_total,
    )
    fused_quantile.launches += 1
    return out


def floor_quantile(spec: SketchSpec, state: SketchState, qs) -> torch.Tensor:
    """The ``xla`` floor of a dense state -> [N, Q], the one router for it:
    :func:`fused_quantile` (K2) for float bins on a CUDA device, at any
    stream count and width; ``batched.quantile`` on the CPU and for integer
    bins, which have no kernel in either package (the JAX package's
    ``fused_quantile`` refuses them too; their integer rank compare never
    rounds).  K2 and ``batched.quantile`` compute the same function bit for
    bit, so the choice moves no answer.  Both facades' ``xla`` tier, the
    serving tier's floor, hedge and stacked flush, and the window
    fold-decode answer here, where the JAX package dispatches its jitted
    ``batched.quantile``."""
    if state.device.type == "cuda" and not spec.bins_integer:
        return fused_quantile(spec, state, qs)
    from sketches_tpu_torch.batched import quantile

    return quantile(spec, state, qs)


def _first_last_occupied(bins: torch.Tensor):
    """First and last bin with mass > 0 per row -> ([N, 1], [N, 1]) int32;
    an empty row gives (n_bins, -1)."""
    n_bins = bins.shape[-1]
    occ = bins > 0.0
    iota = torch.arange(n_bins, dtype=torch.int32, device=bins.device)
    first = torch.where(occ, iota, n_bins).amin(-1, keepdim=True).to(torch.int32)
    last = torch.where(occ, iota, -1).amax(-1, keepdim=True).to(torch.int32)
    return first, last


def fused_quantile_plain(spec: SketchSpec, state: SketchState, qs: torch.Tensor):
    """Plain PyTorch version of the full-window kernel, step for step as
    ``_select_quantiles``: full-window ``cumsum`` of each store, occupied
    bounds from the bins, the negative total as the last running sum, rank
    masks, clip, decode, three-way select and NaN."""
    f32 = torch.float32
    cum_pos = cumsum_f32(state.bins_pos.to(f32))
    cum_neg = cumsum_f32(state.bins_neg.to(f32))
    first_pos, last_pos = _first_last_occupied(state.bins_pos)
    first_neg, last_neg = _first_last_occupied(state.bins_neg)
    neg_count = cum_neg[:, -1:]
    zero = state.zero_count.to(f32)[:, None]
    count = state.count.to(f32)[:, None]
    rank = qs[None, :] * (count - 1.0)
    rev = neg_count - 1.0 - rank
    pos_rank = rank - zero - neg_count

    def counts(cum, thr, strict):
        cmp = torch.lt if strict else torch.le
        return torch.stack(
            [cmp(cum, thr[:, qi : qi + 1]).sum(-1) for qi in range(thr.shape[1])], dim=1
        ).to(torch.int32)

    idx_neg = _clip(counts(cum_neg, rev + 1.0, True), first_neg, last_neg)
    idx_pos = _clip(counts(cum_pos, pos_rank, False), first_pos, last_pos)
    key_lo = state.key_offset[:, None].to(torch.int32)
    val_neg = -spec.mapping.value_array(idx_neg + key_lo)
    val_pos = spec.mapping.value_array(idx_pos + key_lo)
    zero_v = torch.zeros((), dtype=f32, device=qs.device)
    val = torch.where(
        rank < neg_count, val_neg, torch.where(rank < neg_count + zero, zero_v, val_pos)
    )
    valid = ((qs >= 0.0) & (qs <= 1.0))[None, :] & (count > 0.0)
    return torch.where(valid, val, float("nan"))


# ---------------------------------------------------------------------------
# Window plan
# ---------------------------------------------------------------------------


def plan_window(spec: SketchSpec, occ_lo_min: int, occ_hi_max: int):
    """Host-side window plan from globally folded occupied bounds ->
    ``(lo_wblock, n_wblocks, w_tiles)``: the block width in {4, 2, 1} tiles
    that reads the fewest tiles (ties to the wider block), aligned so the
    block index is exact.  An empty batch plans the minimal window at 0."""
    tiles_total = spec.n_bins // LO
    if occ_hi_max < 0:
        lo_t = hi_t = 0
    else:
        lo_t = max(0, min(occ_lo_min, occ_hi_max)) // LO
        hi_t = min(occ_hi_max // LO, tiles_total - 1)
    best = None
    for w in (4, 2, 1):
        if tiles_total % w:
            continue
        lo_w = lo_t // w
        n_w = hi_t // w - lo_w + 1
        if best is None or n_w * w < best[1] * best[2]:
            best = (lo_w, n_w, w)
    return best


def window_stats(state: SketchState):
    """(global occupied min, global occupied max, any negative mass) of a
    state, in one host fetch (``fetch.window_stats``)."""
    _FETCHES["window_stats"] += 1
    glo, ghi, neg_any = torch.stack(
        [
            state.occ_lo.amin(),
            state.occ_hi.amax(),
            (state.neg_total > 0).any().to(torch.int32),
        ]
    ).tolist()
    return int(glo), int(ghi), bool(neg_any)


def plan_state_window(spec: SketchSpec, state: SketchState, *, spans=None):
    """Window plan of a live state -> ``(lo_w, n_w, w_t, with_neg)``, with
    one host fetch (:func:`window_stats`); ``spans`` names it
    ``query.plan_window_s``."""
    if spans is not None:
        spans.enter("query.plan_window_s")
    glo, ghi, neg_any = window_stats(state)
    lo_w, n_w, w_t = plan_window(spec, glo, ghi)
    if spans is not None:
        spans.exit()
    return lo_w, n_w, w_t, neg_any


def _windowed_packed(state: SketchState, qs: torch.Tensor) -> torch.Tensor:
    """Per-stream thresholds packed as the windowed kernel reads them:
    pos_rank[Q] | rev_rank+1[Q] | key_offset | pos_lo | pos_hi | neg_lo |
    neg_hi, all f32 (exact for the integers involved)."""
    f32 = torch.float32
    neg_count = state.neg_total.to(f32)[:, None]
    rank = qs[None, :] * (state.count.to(f32)[:, None] - 1.0)
    pos_rank = rank - state.zero_count.to(f32)[:, None] - neg_count
    rev_p1 = neg_count - rank
    cols = [state.key_offset, state.pos_lo, state.pos_hi, state.neg_lo, state.neg_hi]
    return torch.cat([pos_rank, rev_p1] + [c.to(f32)[:, None] for c in cols], dim=1)


def _valid(state: SketchState, qs: torch.Tensor) -> torch.Tensor:
    return ((qs >= 0.0) & (qs <= 1.0))[None, :] & (state.count > 0)[:, None]


def fused_quantile_windowed(
    spec: SketchSpec,
    state: SketchState,
    qs,
    lo_wblock,
    *,
    n_wblocks: int,
    w_tiles: int = 1,
    with_neg: bool = True,
    spans=None,
) -> torch.Tensor:
    """Multi-quantile query reading only the occupied bin window -> [N, Q].

    The window is ``n_wblocks`` blocks of ``w_tiles`` 128-bin tiles from
    block ``lo_wblock`` (:func:`plan_window`); the caller guarantees every
    occupied bin lies inside.  ``with_neg=False`` (certified by
    ``neg_total == 0``) never reads the negative store.  CUDA tensors run
    ``csrc/windowed.cu``; CPU tensors run :func:`fused_quantile_windowed_plain`.
    ``spans`` names the packed operand ``query.operands_s`` and the kernel
    ``query.kernel_s``.
    """
    n = state.n_streams
    if spec.bins_integer:
        raise NotImplementedError(
            "windowed quantile requires float bins; integer-bin specs query"
            " via quantile_windowed_xla"
        )
    qs = _as_qs(qs, state.device)
    q_total = qs.shape[0]
    if q_total == 0:
        return torch.zeros((n, 0), dtype=torch.float32, device=state.device)
    # Static plan checks: CUDA reads out of bounds where TPU Pallas clamped
    # an out-of-range block, so a bad plan must never reach the kernel.
    if w_tiles not in (1, 2, 4) or spec.n_bins % (w_tiles * LO) != 0:
        raise SpecError(
            f"w_tiles={w_tiles} must divide the {spec.n_bins}-bin array"
            " into whole column blocks (and be one of 1/2/4)"
        )
    if not 1 <= n_wblocks <= spec.n_bins // (w_tiles * LO):
        raise SpecError(
            f"n_wblocks={n_wblocks} window ({n_wblocks * w_tiles * LO} bins)"
            f" exceeds the {spec.n_bins}-bin array"
        )
    # The window start clamps into range once, before the kernel reads it.
    max_lo = spec.n_bins // (w_tiles * LO) - n_wblocks
    lo = min(max(int(lo_wblock), 0), max_lo)
    lo_bin = lo * w_tiles * LO
    n_tiles_win = n_wblocks * w_tiles
    if spans is not None:
        spans.enter("query.operands_s")
    packed = _windowed_packed(state, qs)
    if spans is not None:
        spans.exit()
        spans.enter("query.kernel_s")
    if _on_cuda(packed, "fused_quantile_windowed"):
        dev = state.device
        _check(state.bins_pos, "bins_pos", torch.float32, (n, spec.n_bins), dev)
        if with_neg:
            _check(state.bins_neg, "bins_neg", torch.float32, (n, spec.n_bins), dev)
        out = torch.empty((n, q_total), dtype=torch.float32, device=dev)
        _launch(
            "sk_windowed", dev,
            _ptr(state.bins_pos), _ptr(state.bins_neg) if with_neg else None,
            _ptr(packed), _ptr(out), _ptr(_mapping_consts(spec.mapping, dev)),
            spec.mapping.kernel_id, n, spec.n_bins, q_total, packed.shape[1],
            lo_bin, n_tiles_win,
        )
        fused_quantile_windowed.launches += 1
    else:
        out = fused_quantile_windowed_plain(
            spec, state, packed, lo_bin, n_tiles_win, with_neg, q_total
        )
    if spans is not None:
        spans.exit()
    # Validity (q in [0, 1], non-empty stream) applies outside the kernel.
    return torch.where(_valid(state, qs), out, float("nan"))


def fused_quantile_windowed_plain(spec, state, packed, lo_bin, n_tiles_win, with_neg, q_total):
    """Plain PyTorch version of the windowed kernel (before validity):
    slice the window, ``cumsum``, mask counts, clip, decode."""
    width = n_tiles_win * LO
    pos_rank = packed[:, :q_total]
    rev_p1 = packed[:, q_total : 2 * q_total]
    bds = packed[:, 2 * q_total :].to(torch.int32)
    key_lo = bds[:, 0:1]
    first_pos = bds[:, 1:2]
    last_pos = torch.maximum(bds[:, 2:3], first_pos)

    def counts(bins, thr, strict):
        cum = cumsum_f32(bins[:, lo_bin : lo_bin + width])
        cmp = torch.lt if strict else torch.le
        return torch.stack(
            [cmp(cum, thr[:, qi : qi + 1]).sum(-1) for qi in range(q_total)], dim=1
        ).to(torch.int32)

    idx_pos = _clip(lo_bin + counts(state.bins_pos, pos_rank, False), first_pos, last_pos)
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    if not with_neg:
        val_pos = spec.mapping.value_array(idx_pos + key_lo)
        return torch.where(pos_rank < 0.0, zero, val_pos)
    first_neg = bds[:, 3:4]
    last_neg = torch.maximum(bds[:, 4:5], first_neg)
    idx_neg = _clip(lo_bin + counts(state.bins_neg, rev_p1, True), first_neg, last_neg)
    in_neg = rev_p1 > 0.0
    idx_sel = torch.where(in_neg, idx_neg, idx_pos)
    sign = torch.where(in_neg, -1.0, 1.0)
    dec = sign * spec.mapping.value_array(idx_sel + key_lo)
    return torch.where(~in_neg & (pos_rank < 0.0), zero, dec)


def quantile_windowed_xla(
    spec: SketchSpec,
    state: SketchState,
    qs,
    lo_tile,
    *,
    n_tiles_window: int,
    with_neg: bool = True,
) -> torch.Tensor:
    """Portable occupied-window query (the ``wxla`` tier, any bin dtype).

    Slice both stores to ``n_tiles_window`` tiles from tile ``lo_tile``, run
    the cumsum + mask-count walk, offset the decode by the window start.
    Integer bins compare in integer space (exact past 2**24).
    """
    n = state.n_streams
    qs = _as_qs(qs, state.device)
    q_total = qs.shape[0]
    if q_total == 0:
        return torch.zeros((n, 0), dtype=spec.dtype, device=state.device)
    if spec.n_bins % LO != 0:
        raise SpecError("windowed XLA query requires 128-aligned n_bins")
    tiles_total = spec.n_bins // LO
    if not 1 <= n_tiles_window <= tiles_total:
        raise SpecError(f"n_tiles_window={n_tiles_window} outside [1, {tiles_total}]")
    width = n_tiles_window * LO
    lo_bin = min(max(int(lo_tile), 0), tiles_total - n_tiles_window) * LO
    neg_count = state.neg_total
    count = state.count
    rank = qs[None, :] * (count[:, None].to(spec.dtype) - 1)
    int_mode = spec.bins_integer
    bd = state.bins_pos.dtype
    safe = float(2**31 - 256)

    def walk(bins, thr, strict):
        cum = cumsum_f32(bins[:, lo_bin : lo_bin + width])
        if int_mode:
            it = torch.ceil(thr) - 1 if strict else torch.floor(thr)
            thr, strict = torch.clamp(it, -safe, safe).to(bd), False
        cmp = torch.lt if strict else torch.le
        return torch.stack(
            [cmp(cum, thr[:, qi : qi + 1]).sum(-1) for qi in range(q_total)], dim=1
        ).to(torch.int32)

    pos_rank = rank - (state.zero_count + neg_count).to(spec.dtype)[:, None]
    idx_pos = _clip(
        lo_bin + walk(state.bins_pos, pos_rank, False),
        state.pos_lo[:, None],
        torch.maximum(state.pos_hi, state.pos_lo)[:, None],
    )
    key_lo = state.key_offset[:, None].to(torch.int32)
    val_pos = spec.mapping.value_array(idx_pos + key_lo)
    in_neg = rank < neg_count.to(spec.dtype)[:, None]
    in_zero = rank < (neg_count + state.zero_count).to(spec.dtype)[:, None]
    zero = torch.zeros((), dtype=spec.dtype, device=state.device)
    if with_neg:
        rev_p1 = neg_count.to(spec.dtype)[:, None] - rank
        idx_neg = _clip(
            lo_bin + walk(state.bins_neg, rev_p1, True),
            state.neg_lo[:, None],
            torch.maximum(state.neg_hi, state.neg_lo)[:, None],
        )
        val_neg = -spec.mapping.value_array(idx_neg + key_lo)
        out = torch.where(in_neg, val_neg, torch.where(in_zero, zero, val_pos))
    else:
        out = torch.where(in_zero, zero, val_pos)
    valid = ((qs >= 0) & (qs <= 1))[None, :] & (count > 0)[:, None]
    return torch.where(valid, out, float("nan"))


# ---------------------------------------------------------------------------
# Tile-list query: hierarchical rank selection
# ---------------------------------------------------------------------------


def _stream_block(n: int) -> int:
    """Stream-block width the tile plan judges needed-tile unions at."""
    return next((b for b in (1024, 512, 256, 128) if n % b == 0), _BN)


def _invalid_mask(state: SketchState, qs: torch.Tensor) -> torch.Tensor:
    """[N, Q] bool: ranks whose output is NaN (empty stream / q outside
    [0, 1])."""
    return ~_valid(state, qs)


def tile_query_eligible(spec: SketchSpec, q_total: int, window_plan) -> bool:
    """Whether the tile-list engine can serve this (spec, Q, window): Q <= 8,
    at least 2 tiles per store, 128-aligned bins, a window wider than one
    tile."""
    if window_plan is None:
        return False
    _, n_w, w_t, _ = window_plan
    return q_total <= 8 and spec.n_tiles >= 2 and spec.n_bins % LO == 0 and n_w * w_t > 1


#: The overlap engine's switch (``analysis/registry.py``), read with the
#: JAX package's convention: on unless set to the literal "0".
OVERLAP_ENV = registry.OVERLAP.name


def overlap_enabled() -> bool:
    """Whether the facades may route eligible queries to the overlap engine.

    True unless ``SKETCHES_TPU_OVERLAP`` is set to ``"0"``; switched off,
    every pick the overlap engine would take goes down the tiles/windowed
    ladder instead (the engines answer identically).
    """
    return registry.enabled(registry.OVERLAP)


def choose_query_engine(window_plan, tile_plan, overlap_ok: bool = False) -> str:
    """The windowed/tiles/overlap policy of the JAX package, verbatim: a
    single-tile window goes to ``windowed``; with ``overlap_ok``, every span
    the tile engine would take goes to ``overlap``, and so does the
    equal-byte positive-only tie; otherwise wider spans go to ``tiles``
    when its needed-tile bound strictly beats the span or the negative store
    participates.  The facades pass ``overlap_ok=overlap_enabled()`` unless
    the caller disabled the tier."""
    if tile_plan is None:
        return "windowed"
    _, n_w, w_t, with_neg_w = window_plan
    k_tiles, with_neg_t = tile_plan
    span = n_w * w_t
    if span <= 1:
        return "windowed"
    k_eff = k_tiles * (2 if with_neg_t else 1)
    win_eff = span * (2 if with_neg_w else 1)
    if overlap_ok and (with_neg_t or k_eff <= win_eff):
        return "overlap"
    return "tiles" if (with_neg_t or k_eff < win_eff) else "windowed"


def _tile_targets(spec: SketchSpec, state: SketchState, qs: torch.Tensor):
    """Per-(stream, q) crossing tiles and in-tile thresholds from the tile
    masses alone -> ``(utile, thr_adj, zflag, rank)``: ``utile`` in [0, 2T)
    (negative-store tiles offset by T), ``thr_adj`` with the tiles below
    subtracted, ``zflag`` (f32 0/1) for zero-bucket ranks."""
    t = spec.n_tiles
    f32 = torch.float32
    tiles = state.tile_sums.to(f32)
    tp, tn = tiles[:, :t], tiles[:, t:]
    cum_tp = cumsum_f32(tp)
    cum_tn = cumsum_f32(tn)
    excl_tp = cum_tp - tp
    excl_tn = cum_tn - tn
    neg_count = state.neg_total.to(f32)[:, None]
    rank = qs[None, :] * (state.count.to(f32)[:, None] - 1.0)
    pos_rank = rank - state.zero_count.to(f32)[:, None] - neg_count
    rev_p1 = neg_count - rank
    g_pos = torch.clamp((cum_tp[:, None, :] <= pos_rank[:, :, None]).sum(-1), 0, t - 1)
    g_neg = torch.clamp((cum_tn[:, None, :] < rev_p1[:, :, None]).sum(-1), 0, t - 1)
    carry_pos = excl_tp.gather(1, g_pos)
    carry_neg = excl_tn.gather(1, g_neg)
    in_neg = rev_p1 > 0.0
    in_zero = ~in_neg & (pos_rank < 0.0)
    utile = torch.where(in_neg, g_neg + t, g_pos).to(torch.int32)
    thr_adj = torch.where(in_neg, rev_p1 - carry_neg, pos_rank - carry_pos)
    return utile, thr_adj, in_zero.to(f32), rank


_WORD = 32  # tiles per needed-tile bitmask word


def _n_words(n_tiles: int) -> int:
    return -(-n_tiles // _WORD)


def _tile_bits(utile, zflag, nanflag, n_tiles):
    """Per-stream needed-tile bitmasks -> ([N, W], [N, W]) int64 words
    holding uint32 values (bit u % 32 of word u // 32), one set per store;
    zero-bucket and NaN ranks need no tile."""
    q_total = utile.shape[1]
    t = n_tiles
    nw = _n_words(t)
    live = (zflag < 0.5) & ~nanflag
    n = utile.shape[0]
    words = torch.arange(nw, device=utile.device)[None, :]
    bits_pos = torch.zeros((n, nw), dtype=torch.int64, device=utile.device)
    bits_neg = torch.zeros_like(bits_pos)
    for q in range(q_total):
        u = utile[:, q].to(torch.int64)
        is_neg = u >= t
        idx = u - torch.where(is_neg, t, 0)
        bit = (1 << (idx % _WORD))[:, None]
        hit = (idx // _WORD)[:, None] == words
        lp = (live[:, q] & ~is_neg)[:, None]
        ln = (live[:, q] & is_neg)[:, None]
        bits_pos |= torch.where(hit & lp, bit, 0)
        bits_neg |= torch.where(hit & ln, bit, 0)
    return bits_pos, bits_neg


def _block_or(bits: torch.Tensor, bn: int) -> torch.Tensor:
    """[N, W] words -> [N // bn, W]: bitwise OR over each stream block."""
    x = bits.reshape(bits.shape[0] // bn, bn, bits.shape[1])
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] | x[:, 1::2]
    return x[:, 0]


def _bit_planes(words: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """[nb, W] words -> [nb, n_tiles] bool: whether each tile's bit is set."""
    shifts = torch.arange(_WORD, device=words.device)
    planes = (words[:, :, None] >> shifts) & 1
    return planes.reshape(words.shape[0], -1)[:, :n_tiles] > 0


def _block_tile_lists(bits_pos, bits_neg, n_tiles, bn, k_tiles):
    """Per-stream-block sorted needed-tile lists -> ([nb, K], [nb, K]) int32,
    padded at the end by repeating the last real entry.  The overlap kernel
    walks these (the tile kernel reads each stream's tile directly)."""
    t = n_tiles

    def compact(bits):
        mask = _bit_planes(_block_or(bits, bn), t)
        iota = torch.arange(t, dtype=torch.int32, device=bits.device)
        ids = torch.sort(torch.where(mask, iota, t), dim=-1).values[:, :k_tiles]
        last = torch.where(mask, iota, -1).amax(-1)
        return torch.where(ids == t, torch.clamp(last, min=0)[:, None], ids).to(torch.int32)

    return compact(bits_pos), compact(bits_neg)


def plan_tile_query(
    spec: SketchSpec, state: SketchState, qs, bn: Optional[int] = None, *, spans=None
) -> tuple:
    """Host-side plan of the tile-list query -> ``(k_tiles, with_neg)``.

    ``k_tiles`` is the largest per-stream-block union of needed tiles (per
    store), rounded up to a power of two -- the JAX package's routing input
    (``choose_query_engine`` compares it with the window span).  One host
    fetch (``fetch.plan_tile_query``); ``spans`` names the plan
    ``query.plan_tiles_s``.
    """
    if spans is not None:
        spans.enter("query.plan_tiles_s")
    qs = _as_qs(qs, state.device)
    if bn is None:
        bn = _stream_block(state.n_streams)
    utile, _, zflag, _ = _tile_targets(spec, state, qs)
    nanflag = _invalid_mask(state, qs)
    bits_pos, bits_neg = _tile_bits(utile, zflag, nanflag, spec.n_tiles)

    def max_union(bits):
        return _bit_planes(_block_or(bits, bn), spec.n_tiles).sum(-1).amax()

    _FETCHES["plan_tile_query"] += 1
    k_pos, k_neg, neg_any = torch.stack(
        [max_union(bits_pos), max_union(bits_neg), (state.neg_total > 0).any().to(torch.int64)]
    ).tolist()
    with_neg = bool(neg_any)
    k = max(k_pos, k_neg if with_neg else 0, 1)
    k_tiles = 1 << (k - 1).bit_length()
    if spans is not None:
        spans.exit()
    return min(k_tiles, spec.n_tiles), with_neg


def _tiles_packed(spec: SketchSpec, state: SketchState, qs: torch.Tensor) -> torch.Tensor:
    """The tile kernels' per-stream operand (:func:`_pack_tile_operand`)."""
    utile, thr_adj, zflag, _ = _tile_targets(spec, state, qs)
    return _pack_tile_operand(state, utile, thr_adj, zflag, _invalid_mask(state, qs))


def _tile_query_operands(spec: SketchSpec, state: SketchState, qs, bn: int, k_tiles: int):
    """The tile-family kernels' shared inputs -> ``(lists_pos, lists_neg,
    packed)``: per-block sorted needed-tile lists ``[N // bn, k_tiles]``
    int32 and the packed per-stream operand."""
    t = spec.n_tiles
    utile, thr_adj, zflag, _ = _tile_targets(spec, state, qs)
    nanflag = _invalid_mask(state, qs)
    bits_pos, bits_neg = _tile_bits(utile, zflag, nanflag, t)
    lists_pos, lists_neg = _block_tile_lists(bits_pos, bits_neg, t, bn, k_tiles)
    packed = _pack_tile_operand(state, utile, thr_adj, zflag, nanflag)
    return lists_pos.contiguous(), lists_neg.contiguous(), packed


def _pack_tile_operand(state, utile, thr_adj, zflag, nanflag) -> torch.Tensor:
    """thr_adj[Q] | utile[Q] | zflag[Q] | nanflag[Q] | key_offset | pos_lo |
    pos_hi | neg_lo | neg_hi, f32, zero-padded to a multiple of 8 columns."""
    f32 = torch.float32
    cols = [state.key_offset, state.pos_lo, state.pos_hi, state.neg_lo, state.neg_hi]
    packed = torch.cat(
        [thr_adj, utile.to(f32), zflag, nanflag.to(f32)] + [c.to(f32)[:, None] for c in cols],
        dim=1,
    )
    w = packed.shape[1]
    wp = ((w + 7) // 8) * 8
    if wp != w:
        packed = torch.nn.functional.pad(packed, (0, wp - w))
    return packed.contiguous()


def fused_quantile_tiles(
    spec: SketchSpec,
    state: SketchState,
    qs,
    *,
    k_tiles: int,
    with_neg: bool = True,
    spans=None,
) -> torch.Tensor:
    """Hierarchical multi-quantile query -> [N, Q] final values.

    Each live (stream, q) reads only its crossing tile (``_tile_targets``).
    ``k_tiles`` is the plan's needed-tile bound (:func:`plan_tile_query`),
    validated as in the JAX package; ``with_neg=False`` (certified by
    ``neg_total == 0``) never reads the negative store.  CUDA tensors run
    ``csrc/tiles.cu``; CPU tensors run :func:`fused_quantile_tiles_plain`.
    ``spans`` names the packed operand ``query.operands_s`` and the kernel
    ``query.kernel_s``.
    """
    n = state.n_streams
    t = spec.n_tiles
    if spec.bins_integer:
        raise NotImplementedError(
            "fused_quantile_tiles requires float bins; integer-bin specs"
            " query via quantile_windowed_xla"
        )
    if spec.n_bins % LO != 0:
        raise SpecError("tile-list query requires 128-aligned n_bins")
    qs = _as_qs(qs, state.device)
    q_total = qs.shape[0]
    if q_total == 0:
        return torch.zeros((n, 0), dtype=torch.float32, device=state.device)
    if not 1 <= k_tiles <= t:
        raise SpecError(f"k_tiles={k_tiles} outside [1, {t}]")
    if spans is not None:
        spans.enter("query.operands_s")
    packed = _tiles_packed(spec, state, qs)
    if spans is not None:
        spans.exit()
        spans.enter("query.kernel_s")
    if not _on_cuda(packed, "fused_quantile_tiles"):
        out = fused_quantile_tiles_plain(spec, state, packed, with_neg, q_total)
    else:
        dev = state.device
        _check(state.bins_pos, "bins_pos", torch.float32, (n, spec.n_bins), dev)
        if with_neg:
            _check(state.bins_neg, "bins_neg", torch.float32, (n, spec.n_bins), dev)
        out = torch.empty((n, q_total), dtype=torch.float32, device=dev)
        _launch(
            "sk_tiles", dev,
            _ptr(state.bins_pos), _ptr(state.bins_neg) if with_neg else None,
            _ptr(packed), _ptr(out), _ptr(_mapping_consts(spec.mapping, dev)),
            spec.mapping.kernel_id, n, spec.n_bins, q_total, packed.shape[1],
        )
        fused_quantile_tiles.launches += 1
    if spans is not None:
        spans.exit()
    return out


def fused_quantile_tiles_plain(spec, state, packed, with_neg, q_total):
    """Plain PyTorch version of the tile kernel: gather each (stream, q)'s
    crossing tile, ``cumsum``, count, clip, decode, zero bucket and NaN."""
    blk = _crossing_tiles(spec, state, packed, with_neg, q_total)
    return _count_and_decode(spec, blk, packed, with_neg, q_total)


def _crossing_tiles(spec, state, packed, with_neg, q_total) -> torch.Tensor:
    """[N, Q, 128]: each (stream, q)'s crossing tile (zeros for a negative
    rank when the negative store is certified empty)."""
    n = state.n_streams
    t = spec.n_tiles
    ut = packed[:, q_total : 2 * q_total]
    is_neg = ut >= float(t)
    tiles_pos = state.bins_pos.reshape(n, t, LO)
    if with_neg:
        tiles = torch.cat([tiles_pos, state.bins_neg.reshape(n, t, LO)], dim=1)
        gidx = ut.to(torch.int64)
    else:
        tiles = tiles_pos
        gidx = torch.where(is_neg, 0.0, ut).to(torch.int64)
    blk = tiles.gather(1, gidx[:, :, None].expand(n, q_total, LO))
    if not with_neg:
        # The negative store is certified empty: such a rank reads zeros.
        blk = torch.where(is_neg[:, :, None], 0.0, blk)
    return blk


def _count_and_decode(spec, blk, packed, with_neg, q_total):
    """The tile kernels' finalization over [N, Q, 128] tiles: ``cumsum``,
    count (<= on the positive store, < on the negative one), clip into the
    occupied bounds, decode, zero bucket and NaN."""
    t = spec.n_tiles
    thr = packed[:, :q_total]
    ut = packed[:, q_total : 2 * q_total]
    zflag = packed[:, 2 * q_total : 3 * q_total]
    nanflag = packed[:, 3 * q_total : 4 * q_total]
    base = 4 * q_total
    koff = packed[:, base : base + 1]
    first_pos = packed[:, base + 1 : base + 2]
    last_pos = torch.maximum(packed[:, base + 2 : base + 3], first_pos)
    is_neg = ut >= float(t)
    tile_all = ut - torch.where(is_neg, float(t), 0.0)
    cum = cumsum_f32(blk)
    cmp = torch.where(is_neg[:, :, None], cum < thr[:, :, None], cum <= thr[:, :, None])
    cnt = cmp.sum(-1).to(torch.float32)
    idx = tile_all * 128.0 + cnt
    if with_neg:
        first_neg = packed[:, base + 3 : base + 4]
        last_neg = torch.maximum(packed[:, base + 4 : base + 5], first_neg)
        first = torch.where(is_neg, first_neg, first_pos)
        last = torch.where(is_neg, last_neg, last_pos)
        sign = torch.where(is_neg, -1.0, 1.0)
        dec = sign * spec.mapping.value_array(_clip(idx, first, last) + koff)
    else:
        dec = spec.mapping.value_array(_clip(idx, first_pos, last_pos) + koff)
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    val = torch.where(zflag > 0.5, zero, dec)
    return torch.where(nanflag > 0.5, float("nan"), val)


# ---------------------------------------------------------------------------
# K5: the tile-list walk through an asynchronous-copy ring
# ---------------------------------------------------------------------------

# Rows a CTA of the overlap kernel takes at a time and its most ring slots
# (csrc/overlap.cu kRows, kMaxSlots).
_OVERLAP_ROWS = 16
_OVERLAP_MAX_SLOTS = 4


def _overlap_depth(n_steps: int, requested: int) -> int:
    """Ring depth: the largest of 8, 4, 2, 1 that is at most ``requested``
    and divides ``n_steps`` (the JAX package's static-slot rule; the CUDA
    kernel takes it as its prefetch distance, at most 4 slots)."""
    for d in (8, 4, 2, 1):
        if d <= requested and d <= n_steps and n_steps % d == 0:
            return d
    return 1


def _overlap_smem_bytes(depth: int, q_total: int, pk_width: int) -> int:
    """Shared memory of one overlap CTA (csrc/overlap.cu smem_bytes): the
    ring of ``min(depth, 4)`` slots, two staging buffers of packed rows, the
    mbarriers, the slot headers and the [R, Q] counts."""
    r, slots = _OVERLAP_ROWS, min(depth, _OVERLAP_MAX_SLOTS)
    return (
        slots * r * LO * 4 + 2 * r * pk_width * 4 + (2 * slots + 4) * 8 + slots * 4
        + r * q_total * 4
    )


def fused_quantile_tiles_overlap(
    spec: SketchSpec,
    state: SketchState,
    qs,
    *,
    k_tiles: int,
    with_neg: bool = True,
    block_streams: int = 0,
    lookahead: int = 8,
    spans=None,
) -> torch.Tensor:
    """Tile-list multi-quantile query walked through a copy ring -> [N, Q].

    The plan contract of :func:`fused_quantile_tiles` (``k_tiles`` from
    :func:`plan_tile_query`, ``with_neg=False`` certified by
    ``neg_total == 0``), with the TPU overlap kernel's walk: each stream
    block of ``block_streams`` rows (default :func:`_stream_block`) copies
    the tiles of its sorted needed-tile list, positive steps then negative
    ones, through a ring of ``depth`` slots (the largest of 8/4/2/1 that is
    at most ``lookahead`` and divides the step count: the CUDA kernel's
    prefetch distance, capped at its 4-slot ring), and folds each tile only
    into the ranks that target it.  CUDA tensors run
    ``csrc/overlap.cu``; CPU tensors run
    :func:`fused_quantile_tiles_overlap_plain`.  ``spans`` names the tile
    lists, the packed operand and their check ``query.operands_s`` and the
    kernel ``query.kernel_s``.
    """
    n = state.n_streams
    t = spec.n_tiles
    if spec.bins_integer:
        raise NotImplementedError(
            "fused_quantile_tiles_overlap requires float bins; integer-bin"
            " specs query via quantile_windowed_xla (exact integer compare)"
        )
    if spec.n_bins % LO != 0:
        raise SpecError("tile-list query requires 128-aligned n_bins")
    qs = _as_qs(qs, state.device)
    q_total = qs.shape[0]
    if q_total == 0:
        return torch.zeros((n, 0), dtype=torch.float32, device=state.device)
    bn = block_streams or _stream_block(n)
    if n % bn != 0:
        raise SketchValueError(f"n_streams={n} must be a multiple of the stream block ({bn})")
    if not 1 <= k_tiles <= t:
        raise SpecError(f"k_tiles={k_tiles} outside [1, {t}]")
    if lookahead < 1:
        raise SpecError(f"lookahead={lookahead} must be >= 1")
    n_steps = (2 if with_neg else 1) * k_tiles
    depth = _overlap_depth(n_steps, lookahead)
    if spans is not None:
        spans.enter("query.operands_s")
    lists_pos, lists_neg, packed = _tile_query_operands(spec, state, qs, bn, k_tiles)
    on_cuda = _on_cuda(packed, "fused_quantile_tiles_overlap")
    if on_cuda:
        if _overlap_smem_bytes(depth, q_total, packed.shape[1]) > _SMEM_BYTES:
            raise SpecError(
                f"Q={q_total} at ring depth {depth} needs more than the"
                f" {_SMEM_BYTES} bytes of shared memory a block may use"
            )
        # CUDA reads out of bounds where the TPU's DMA faulted: every list
        # entry must name a tile of the store (one host fetch).
        _FETCHES["overlap_lists"] += 1
        lists = torch.cat([lists_pos, lists_neg], dim=1) if with_neg else lists_pos
        if bool(((lists < 0) | (lists >= t)).any()):
            raise SketchValueError(f"a needed-tile list names a tile outside [0, {t})")
    if spans is not None:
        spans.exit()
        spans.enter("query.kernel_s")
    if not on_cuda:
        out = fused_quantile_tiles_overlap_plain(
            spec, state, lists_pos, lists_neg, packed, bn, with_neg, q_total
        )
    else:
        dev = state.device
        for name in ("bins_pos",) + (("bins_neg",) if with_neg else ()):
            _check(getattr(state, name), name, torch.float32, (n, spec.n_bins), dev)
            _check_aligned(getattr(state, name), name)
        _check_aligned(packed, "packed")
        out = torch.empty((n, q_total), dtype=torch.float32, device=dev)
        _launch(
            "sk_overlap", dev,
            _ptr(state.bins_pos), _ptr(state.bins_neg) if with_neg else None,
            _ptr(lists_pos), _ptr(lists_neg) if with_neg else None,
            _ptr(packed), _ptr(out), _ptr(_mapping_consts(spec.mapping, dev)),
            spec.mapping.kernel_id, n, spec.n_bins, q_total, packed.shape[1],
            bn, k_tiles, depth,
        )
        fused_quantile_tiles_overlap.launches += 1
    if spans is not None:
        spans.exit()
    return out


def fused_quantile_tiles_overlap_plain(
    spec, state, lists_pos, lists_neg, packed, bn, with_neg, q_total
):
    """Plain PyTorch version of the overlap kernel: a (stream, q) folds its
    crossing tile only where that tile is an entry of its block's list (a
    repeated pad entry folds nothing more), and reads a zero tile
    otherwise; then the tile kernels' count and decode."""
    n = state.n_streams
    t = spec.n_tiles
    ut = packed[:, q_total : 2 * q_total].to(torch.int64)
    block = torch.arange(n, device=packed.device) // bn

    def listed(lists, tiles):
        entries = lists[block].to(torch.int64)  # [N, K]
        return (entries[:, None, :] == tiles[:, :, None]).any(-1)

    is_neg = ut >= t
    found = listed(lists_pos, ut)
    if with_neg:
        found = torch.where(is_neg, listed(lists_neg, ut - t), found)
    else:
        found = found & ~is_neg
    blk = _crossing_tiles(spec, state, packed, with_neg, q_total)
    blk = torch.where(found[:, :, None], blk, 0.0)
    return _count_and_decode(spec, blk, packed, with_neg, q_total)


_KERNEL_WRAPPERS = (
    ingest_histogram,
    fused_quantile,
    fused_quantile_windowed,
    fused_quantile_tiles,
    fused_quantile_tiles_overlap,
)
reset_launch_counts()
