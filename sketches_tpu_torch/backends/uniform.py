"""UDDSketch-style uniform-collapse backend: alpha degrades, tails don't
(PyTorch port of ``sketches_tpu/backends/uniform.py``).

The dense store clamps out-of-window keys into its edge bins: mass is
conserved but the tail quantiles corrupt.  Uniform collapse (UDDSketch,
arXiv:2004.08604) merges every adjacent bin pair instead, so gamma squares
(``gamma -> gamma**2``), resolution halves everywhere, and the guarantee
degrades predictably to

    alpha_eff(level) = (gamma**(2**level) - 1) / (gamma**(2**level) + 1)

Level algebra (logarithmic mapping only, enforced by ``SketchSpec``): the
base key of ``v`` is ``k0 = ceil(log_gamma v)`` and the level-L key is
``ceil(k0 / 2**L)``, so

* ingest rides the batched engines unchanged: values of a collapsed stream
  are first replaced by the base-mapping representative of their level key
  (:func:`premap_values`), then the stock ingest (the card's ingest kernel)
  bins them;
* collapse is a pure state transform (:func:`collapse_once`): level key
  ``k`` moves to ``ceil(k / 2)``.  Inside one window that is a pair sum
  whose pairing follows the parity of the window's low key, so the port
  writes it as one (no scatter, hence no atomics on the card: deterministic,
  and exact for integer bins), then recomputes the occupied bounds and tile
  sums from the new bins;
* queries post-correct the decode (:func:`correct_values`): the stock
  engines decode a level key with the base mapping, and one elementwise
  ``exp`` re-decodes it at the stream's level, whichever tier answered.

The JAX package jits its facade's closures; here they are plain functions
on tensors, run eagerly on the state's device.  Armed telemetry counts each
collapse (``backend.collapses``, ``backend.effective_alpha`` of up to 8
collapsed streams) and the armed flight recorder keeps a
``backend.collapse`` event, as in the JAX package.

Failure modes: a collapse (the pre-ingest guard, the post-ingest trigger,
an explicit :meth:`AdaptiveDDSketch.collapse` or a mixed-level merge) with
``SKETCHES_TPU_ADAPTIVE=0`` raises ``SpecError``; streams at
``spec.max_collapses`` stop collapsing and clamp at the edges (counted);
empty streams answer NaN; merging unequal specs raises
``UnequalSketchParametersError``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from sketches_tpu_torch import batched, integrity, parallel, telemetry, tracing
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.batched import (
    BatchedDDSketch,
    SketchSpec,
    SketchState,
    _map_stream_chunks,
    _occupied_bounds,
    _recenter_body,
    resolve_device,
    tile_sums_of,
)
from sketches_tpu_torch.mapping import _f32, zero_threshold
from sketches_tpu_torch.resilience import (
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

__all__ = [
    "AdaptiveState",
    "AdaptiveDDSketch",
    "ADAPTIVE_ENV",
    "adaptive_enabled",
    "init",
    "effective_gamma",
    "effective_alpha",
    "premap_values",
    "clamp_fraction",
    "level_auto_offset",
    "collapse_once",
    "collapse_to",
    "correct_values",
    "quantile",
    "align_for_merge",
    "merge",
    "psum_merge",
    "fold_hosts",
]

#: The collapse kill switch (``analysis/registry.py``), read with the JAX
#: package's convention: on unless set to the literal "0".
ADAPTIVE_ENV = registry.ADAPTIVE.name


def adaptive_enabled() -> bool:
    """Whether a uniform collapse may run (``SKETCHES_TPU_ADAPTIVE`` is not
    ``"0"``); switched off, every collapse trigger raises ``SpecError``."""
    return registry.enabled(registry.ADAPTIVE)


@dataclasses.dataclass
class AdaptiveState:
    """Uniform-collapse state: the dense base plus a per-stream level.

    ``base`` is a stock :class:`SketchState` whose bins hold mass at level
    keys (``ceil(base_key / 2**level)``); ``level`` is the int32 collapse
    count of each stream (0 = the base gamma).
    """

    base: SketchState
    level: torch.Tensor  # [n_streams] int32

    @property
    def n_streams(self) -> int:
        return self.base.n_streams

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def count(self) -> torch.Tensor:
        return self.base.count

    @property
    def zero_count(self) -> torch.Tensor:
        return self.base.zero_count

    @property
    def collapsed_low(self) -> torch.Tensor:
        return self.base.collapsed_low

    @property
    def collapsed_high(self) -> torch.Tensor:
        return self.base.collapsed_high

    @classmethod
    def cat(cls, states) -> "AdaptiveState":
        """The states stacked along the stream axis, leaf by leaf."""
        return cls(SketchState.cat([s.base for s in states]),
                   torch.cat([s.level for s in states]))


def init(spec: SketchSpec, n_streams: int, device=None) -> AdaptiveState:
    """An empty adaptive batch on ``device`` (the card by default): dense
    init and all-zero levels."""
    base = batched.init(spec, n_streams, device)
    return AdaptiveState(base, torch.zeros((n_streams,), dtype=torch.int32, device=base.device))


def effective_gamma(spec: SketchSpec, level: torch.Tensor) -> torch.Tensor:
    """Per-stream realized gamma, ``gamma ** (2 ** level)`` (f32)."""
    lng = _f32(math.log(spec.gamma))
    return torch.exp(torch.exp2(level.to(torch.float32)) * lng)


def effective_alpha(spec: SketchSpec, level: torch.Tensor) -> torch.Tensor:
    """Per-stream realized relative-accuracy bound ``(g - 1) / (g + 1)``
    with ``g = gamma ** (2 ** level)``, as ``tanh`` of the half-log (stable
    where ``g`` overflows f32)."""
    lng = _f32(math.log(spec.gamma))
    half = 0.5 * torch.exp2(level.to(torch.float32)) * lng
    return torch.tanh(half)


def _ceil_div(k: torch.Tensor, m) -> torch.Tensor:
    """Elementwise ``ceil(k / m)`` for int32 ``k`` of any sign, ``m > 0``."""
    return -((-k) // m)


def _level_keys(spec: SketchSpec, level: torch.Tensor, absv: torch.Tensor) -> torch.Tensor:
    """Level keys of positive values ``absv[N, S]`` at ``level[N]``."""
    k0 = spec.mapping.key_array(absv)
    m = torch.bitwise_left_shift(torch.ones_like(level), torch.clamp(level, max=30))
    return _ceil_div(k0, m[:, None])


def _as_values(spec: SketchSpec, values, device) -> torch.Tensor:
    v = torch.as_tensor(values, dtype=spec.dtype, device=device)
    return v[:, None] if v.ndim == 1 else v


def _as_weights(spec: SketchSpec, weights, v: torch.Tensor) -> torch.Tensor:
    if weights is None:
        return torch.ones_like(v)
    w = torch.as_tensor(weights, dtype=spec.dtype, device=v.device)
    if w.ndim == 1:
        w = w[:, None]
    return w.broadcast_to(v.shape)


def premap_values(spec: SketchSpec, level: torch.Tensor, values) -> torch.Tensor:
    """Raw values -> base-mapping stand-ins for their level keys.

    A value of a stream at level L becomes ``mapping.value(level_key)``,
    whose base key is the level key, so the stock ingest bins it where the
    level algebra puts it.  Level-0 streams, zeros, NaNs and subnormals pass
    through untouched; signs are kept.
    """
    v = _as_values(spec, values, level.device)
    lam = level.to(torch.int32)
    tiny = zero_threshold(v.dtype)
    absv = v.abs()
    routable = absv >= tiny  # NaN fails -> passes through untouched
    neutral = torch.where(routable, absv, torch.ones_like(v))
    rep = spec.mapping.value_array(_level_keys(spec, lam, neutral))
    return torch.where(routable & (lam[:, None] > 0), torch.sign(v) * rep, v)


def clamp_fraction(spec: SketchSpec, key_offset: torch.Tensor, level: torch.Tensor,
                   values, weights=None) -> torch.Tensor:
    """Weighted fraction of a batch's live nonzero lanes whose level key
    falls outside each stream's window -> ``[n_streams]`` (0 where a stream
    has no such lane): the pre-ingest guard's predictor."""
    v = _as_values(spec, values, level.device)
    w = _as_weights(spec, weights, v)
    live = w > 0
    tiny = zero_threshold(v.dtype)
    absv = v.abs()
    routable = live & (absv >= tiny)
    neutral = torch.where(routable, absv, torch.ones_like(v))
    k_level = _level_keys(spec, level.to(torch.int32), neutral)
    lo = key_offset.to(torch.int32)[:, None]
    hi = lo + (spec.n_bins - 1)
    out = routable & ((k_level < lo) | (k_level > hi))
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w_out = torch.where(out, w, zero).sum(-1)
    w_all = torch.where(routable, w, zero).sum(-1)
    return w_out / torch.clamp(w_all, min=1.0)


def level_auto_offset(spec: SketchSpec, level: torch.Tensor, key_offset: torch.Tensor,
                      values, weights=None) -> torch.Tensor:
    """Window offsets centring each stream on a batch's median level key
    (``batched.auto_offset`` at the stream's level) -> [N] int32; streams
    with no live nonzero value keep ``key_offset``."""
    v = _as_values(spec, values, level.device)
    tiny = zero_threshold(v.dtype)
    nonzero = v.abs() >= tiny  # NaN fails -> excluded
    if weights is not None:
        nonzero = nonzero & (_as_weights(spec, weights, v) > 0)
    absv = torch.where(nonzero, v.abs(), torch.ones_like(v))
    keys = _level_keys(spec, level.to(torch.int32), absv)
    ksort = torch.sort(torch.where(nonzero, keys, 2**30), dim=-1).values
    n_live = nonzero.sum(-1)
    mid = torch.clamp((n_live - 1) // 2, min=0)
    med = ksort.gather(1, mid[:, None])[:, 0]
    centered = med - batched._center_bin(spec)
    return torch.where(n_live > 0, centered, key_offset.to(torch.int32)).to(torch.int32)


def _pair_sums(bins: torch.Tensor, lead: int) -> torch.Tensor:
    """``new[j] = t[2j] + t[2j + 1]`` over ``t = [0] * lead ++ bins ++
    zeros``, cut back to the window's width: one collapse of every row."""
    n, b = bins.shape
    tail = (lead + b) % 2
    t = torch.nn.functional.pad(bins, (lead, tail))
    pairs = t[:, 0::2] + t[:, 1::2]
    out = torch.zeros_like(bins)
    out[:, : pairs.shape[1]] = pairs
    return out


def _collapse_body(spec: SketchSpec, state: SketchState, mask: torch.Tensor) -> SketchState:
    """One uniform collapse of the masked streams' bins.

    Level key ``k = koff + i`` moves to ``ceil(k / 2) - ceil(koff / 2)``:
    for an even ``koff`` bin 0 stays and bins ``2j - 1, 2j`` sum into bin
    ``j``; for an odd one bins ``2j, 2j + 1`` do.  The target never passes
    ``n_bins / 2``, so nothing clamps and mass is conserved exactly.
    Unmasked rows pass through; the occupied bounds and tile sums are
    recomputed from the bins for every row (as the JAX package does).
    """
    koff = state.key_offset
    even = (koff % 2 == 0)[:, None]
    m = mask[:, None]

    def collapse(bins):
        new = torch.where(even, _pair_sums(bins, 1), _pair_sums(bins, 0))
        return torch.where(m, new, bins)

    new_pos = collapse(state.bins_pos)
    new_neg = collapse(state.bins_neg)
    pos_lo, pos_hi = _occupied_bounds(new_pos)
    neg_lo, neg_hi = _occupied_bounds(new_neg)
    return dataclasses.replace(
        state,
        bins_pos=new_pos,
        bins_neg=new_neg,
        key_offset=torch.where(mask, _ceil_div(koff, 2), koff).to(torch.int32),
        pos_lo=pos_lo,
        pos_hi=pos_hi,
        neg_lo=neg_lo,
        neg_hi=neg_hi,
        tile_sums=tile_sums_of(new_pos, new_neg),
    )


def _collapse_mask(spec: SketchSpec, astate: AdaptiveState, mask) -> torch.Tensor:
    if mask is None:
        mask = torch.ones((astate.n_streams,), dtype=torch.bool, device=astate.device)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=astate.device)
    return mask & (astate.level < spec.max_collapses)


def collapse_once(spec: SketchSpec, astate: AdaptiveState, mask=None) -> AdaptiveState:
    """Collapse the masked streams one level (default: every stream).

    Streams already at ``spec.max_collapses`` are left out: they keep their
    level and clamp at the edges.  Pure; chunked over streams at large
    sizes; mass exactly conserved.
    """
    mask = _collapse_mask(spec, astate, mask)
    base = _map_stream_chunks(
        functools.partial(_collapse_body, spec), astate.n_streams, spec.n_bins,
        astate.base, mask,
    )
    return AdaptiveState(base, astate.level + mask.to(torch.int32))


def collapse_to(spec: SketchSpec, astate: AdaptiveState, target_level) -> AdaptiveState:
    """Collapse each stream up to ``target_level`` (scalar or [N]); streams
    at or past their target are untouched (levels never decrease).  Runs
    ``spec.max_collapses`` single collapses, as the JAX package unrolls
    them."""
    target = torch.as_tensor(target_level, dtype=torch.int32, device=astate.device)
    target = target.broadcast_to(astate.level.shape)
    for _ in range(spec.max_collapses):
        astate = collapse_once(spec, astate, astate.level < target)
    return astate


def correct_values(spec: SketchSpec, level: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Re-decode base-mapping query output at each stream's level.

    The stock engines answer ``gamma**k * 2/(1+gamma)`` for a level key
    ``k``; the level-true value is ``gamma_L**k * 2/(1+gamma_L)``, computed
    as one ``exp`` of ``k*m*ln(g) + ln 2 - log1p(g**m)`` (``logaddexp``,
    saturating like ``value_array``).  Level-0 rows, zeros and NaNs pass
    through untouched.
    """
    v = vals
    lam = level.to(torch.int32).reshape(level.shape + (1,) * (v.ndim - 1))
    tiny = zero_threshold(v.dtype)
    absv = v.abs()
    routable = absv >= tiny  # NaN fails -> untouched
    neutral = torch.where(routable, absv, torch.ones_like(v))
    k = spec.mapping.key_array(neutral).to(torch.float32)
    m = torch.exp2(torch.clamp(lam, max=64).to(torch.float32))
    lng = _f32(math.log(spec.gamma))
    ml = m * lng
    log_out = k * m * lng + _f32(math.log(2.0)) - torch.logaddexp(torch.zeros_like(ml), ml)
    fin = torch.finfo(v.dtype)
    corrected = torch.clamp(torch.exp(log_out), fin.tiny, fin.max).to(v.dtype)
    return torch.where(routable & (lam > 0), torch.sign(v) * corrected, v)


def quantile(spec: SketchSpec, astate: AdaptiveState, qs) -> torch.Tensor:
    """Level-corrected plain multi-quantile -> ``[n_streams, Q]``: the dense
    rank selection on the base, then :func:`correct_values`.  Answers lie
    within ``effective_alpha(spec, level)``; empty streams and q outside
    [0, 1] answer NaN."""
    return correct_values(spec, astate.level, batched.quantile(spec, astate.base, qs))


def _union_span(spec: SketchSpec, sa: SketchState, sb: SketchState):
    """Combined occupied absolute-key bounds of two bases -> ``(lo, hi,
    occupied)``, each [N]."""
    big = 2**30

    def bounds(st):
        has = st.occ_hi >= 0
        return (torch.where(has, st.key_offset + st.occ_lo, big),
                torch.where(has, st.key_offset + st.occ_hi, -big))

    la, ha = bounds(sa)
    lb, hb = bounds(sb)
    return (torch.minimum(la, lb), torch.maximum(ha, hb),
            (sa.occ_hi >= 0) | (sb.occ_hi >= 0))


def align_for_merge(spec: SketchSpec, a: AdaptiveState, b: AdaptiveState):
    """Two operands onto one (level, window) per stream -> ``(a', b')``.

    The finer operand collapses to the pairwise max level; while the
    operands' combined occupied span does not fit one window, both collapse
    further (streams at the cap stop and will fold, counted); both then
    recenter onto a shared union-centred window.  Pure; mass conserved.
    """
    target = torch.maximum(a.level, b.level)
    a = collapse_to(spec, a, target)
    b = collapse_to(spec, b, target)
    for _ in range(spec.max_collapses):
        lo, hi, occupied = _union_span(spec, a.base, b.base)
        need = occupied & (hi - lo + 1 > spec.n_bins) & (a.level < spec.max_collapses)
        a = collapse_once(spec, a, need)
        b = collapse_once(spec, b, need)
    lo, hi, occupied = _union_span(spec, a.base, b.base)
    span = torch.clamp(hi - lo + 1, 0, spec.n_bins)
    koff = torch.where(occupied, lo - (spec.n_bins - span) // 2, a.base.key_offset)
    koff = koff.to(torch.int32)
    return (AdaptiveState(batched.recenter(spec, a.base, koff), a.level),
            AdaptiveState(batched.recenter(spec, b.base, koff), b.level))


def merge(spec: SketchSpec, a: AdaptiveState, b: AdaptiveState) -> AdaptiveState:
    """Merge operands of mixed levels: align (:func:`align_for_merge`),
    then merge the bases elementwise.  Collapse is linear in the bins, so
    this equals collapsing after the merge.  Pure; mass conserved."""
    a2, b2 = align_for_merge(spec, a, b)
    return AdaptiveState(batched.merge_aligned(spec, a2.base, b2.base), a2.level)


def psum_merge(spec: SketchSpec, astates: Sequence[AdaptiveState], n_hosts: int = 1,
               device=None) -> AdaptiveState:
    """Fold one stream shard's adaptive partials (a list, as the port's
    ``parallel.psum_merge`` takes them) onto ``device``.

    Levels align first: every partial collapses to the elementwise max
    level, so the finer operands collapse before any mass moves; then the
    bases fold through ``parallel.psum_merge`` (hierarchical with
    ``n_hosts > 1``).  Partials share one init and are never recentred
    independently, as the distributed tier requires.
    """
    if not astates:
        raise SketchValueError("psum_merge needs at least one partial")
    dev = astates[0].device if device is None else torch.device(device)
    target = torch.stack([st.level.to(dev) for st in astates]).amax(0)
    aligned = [collapse_to(spec, st, target.to(st.device)) for st in astates]
    base = parallel.psum_merge([st.base for st in aligned], n_hosts=n_hosts, device=dev)
    return AdaptiveState(base, target)


def fold_hosts(spec: SketchSpec, astates: Sequence[AdaptiveState], reachable=None):
    """Cross-host fold of adaptive per-host partials -> ``(folded state,
    ShardLossReport)``.

    Levels align to the elementwise max over the reachable hosts (an
    unreachable host's level must not make survivors collapse), then the
    bases fold through ``parallel.fold_hosts``: the same partition
    accounting, ``ShardLossError`` when no host is reachable and
    ``SketchValueError`` for an empty or mismatched list.
    """
    n_hosts = len(astates)
    levels = np.stack([st.level.cpu().numpy() for st in astates]) if n_hosts else None
    live = (np.ones((n_hosts,), bool) if reachable is None
            else np.asarray(reachable, bool).reshape(-1))
    if n_hosts and live.shape[0] == n_hosts and live.any():
        target = levels[live].max(0)
    else:
        target = levels.max(0) if n_hosts else None
    aligned = [
        collapse_to(spec, st, torch.from_numpy(target).to(st.device)) for st in astates
    ]
    folded, report = parallel.fold_hosts(spec, [st.base for st in aligned], reachable=reachable)
    return AdaptiveState(folded, torch.from_numpy(target).to(folded.device)), report


class AdaptiveDDSketch:
    """Stateful facade of the uniform-collapse backend.

    Wraps a stock :class:`BatchedDDSketch` (the ingest kernel and the
    overlap/tiles/windowed/wxla/xla query ladder ride unchanged) and adds
    the level machinery: values of collapsed streams are premapped before
    ingest, two triggers collapse streams whose edge-clamped mass crosses
    ``spec.collapse_threshold``, and queries post-correct the decode.  Runs
    on the card unless ``device="cpu"``; ``engine`` is the wrapped facade's
    (``"auto" | "kernel" | "plain"``).

    Failure modes: a firing trigger, an explicit :meth:`collapse` or a
    merge that needs a collapse, with ``SKETCHES_TPU_ADAPTIVE=0``, raises
    ``SpecError``; merging unequal specs raises
    ``UnequalSketchParametersError``; empty streams answer NaN.
    """

    def __init__(
        self,
        n_streams: int,
        relative_accuracy: float = batched.DEFAULT_REL_ACC,
        n_bins: int = batched.DEFAULT_N_BINS,
        key_offset: Optional[int] = None,
        spec: Optional[SketchSpec] = None,
        state: Optional[AdaptiveState] = None,
        engine: str = "auto",
        auto_recenter: Optional[bool] = None,
        bin_dtype=None,
        collapse_threshold: Optional[float] = None,
        device=None,
    ):
        if spec is None:
            spec = SketchSpec(
                relative_accuracy=relative_accuracy,
                mapping_name="logarithmic",
                n_bins=n_bins,
                key_offset=key_offset,
                bin_dtype=bin_dtype,
                backend="uniform_collapse",
                collapse_threshold=0.01 if collapse_threshold is None else collapse_threshold,
            )
        if spec.backend != "uniform_collapse":
            raise SpecError(
                f"AdaptiveDDSketch needs backend='uniform_collapse'; got {spec.backend!r}"
            )
        self.spec = spec
        if auto_recenter is None:
            # The adaptive facade always carries a spec, so "auto-centre
            # unless the caller pinned the window or restored a state".
            auto_recenter = key_offset is None and state is None
        dev = resolve_device(device, None if state is None else state.base)
        self._inner = BatchedDDSketch(
            n_streams,
            spec=spec,
            state=None if state is None else state.base,
            engine=engine,
            auto_recenter=auto_recenter,
            device=dev,
        )
        if state is None:
            self._level = torch.zeros((n_streams,), dtype=torch.int32, device=dev)
        else:
            self._level = state.level.to(device=dev, dtype=torch.int32)
        # Host-cached "any stream collapsed yet": the premap is an exact
        # no-op at level 0, so fresh facades skip it.
        self._any_level = state is not None and bool((self._level > 0).any())
        # Trigger baseline: the edge-clamp counters at the last collapse (or
        # construction); the trigger compares their growth since then.
        self._trigger_collapsed = self._collapsed_host()

    def _collapsed_host(self) -> np.ndarray:
        st = self._inner.state
        return (st.collapsed_low + st.collapsed_high).to(torch.float64).cpu().numpy()

    # -- core API ----------------------------------------------------------
    def add(self, values, weights=None) -> "AdaptiveDDSketch":
        """Ingest ``values[n_streams, S]``; returns self.

        The pre-ingest guard (:meth:`_preguard`) slides or collapses streams
        whose batch would edge-clamp more than ``spec.collapse_threshold``;
        collapsed streams' values are premapped; the wrapped facade
        ingests; the post-ingest trigger (:meth:`_maybe_collapse`) collapses
        streams whose clamped mass grew past the threshold anyway.  Padding
        (``weights <= 0``) and NaN follow ``BatchedDDSketch.add``.  Raises
        ``SpecError`` when a collapse is needed while
        ``SKETCHES_TPU_ADAPTIVE=0``.
        """
        varr = torch.as_tensor(values, dtype=self.spec.dtype, device=self.device)
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=self.spec.dtype, device=self.device)
        self._preguard(varr, weights)
        v = varr if not self._any_level else premap_values(self.spec, self._level, varr)
        self._inner.add(v, weights)
        self._maybe_collapse()
        return self

    def _guard_stats(self, koff, values, weights):
        """Clamp fraction against the current windows, the batch-median
        offsets, and the clamp fraction against those offsets."""
        spec, level = self.spec, self._level
        frac_now = clamp_fraction(spec, koff, level, values, weights)
        offs = level_auto_offset(spec, level, koff, values, weights)
        frac_ctr = clamp_fraction(spec, offs, level, values, weights)
        return frac_now, offs, frac_ctr

    def _preguard(self, varr, weights) -> None:
        """Pre-ingest collapse guard.

        Per over-threshold stream the cheaper fix wins: where a recentre at
        the current level would hold the batch, the window slides (no alpha
        lost); only where even a centred window cannot hold it does the
        stream collapse.  Up to ``max_collapses + 2`` passes, each with one
        host fetch.  Raises ``SpecError`` when a collapse is needed while
        the kill switch is 0 (recentring alone stays allowed).
        """
        st = self._inner.state
        has_mass = (st.count - st.zero_count).to(torch.float64).cpu().numpy() > 0
        thr = self.spec.collapse_threshold
        for _ in range(self.spec.max_collapses + 2):
            st = self._inner.state
            frac_now_d, offs, frac_ctr_d = self._guard_stats(st.key_offset, varr, weights)
            frac_now, frac_centered = (x.cpu().double().numpy() for x in (frac_now_d, frac_ctr_d))
            level = self._level.cpu().numpy()
            # Empty streams judge against the window their first batch will
            # auto-centre; occupied streams against the window they have.
            relevant = np.where(has_mass, frac_now, frac_centered)
            bad = relevant > thr
            if not bad.any():
                return
            collapse_mask = bad & (frac_centered > thr) & (level < self.spec.max_collapses)
            recenter_mask = bad & has_mass & (frac_centered <= thr)
            if collapse_mask.any():
                if not adaptive_enabled():
                    raise SpecError(
                        "pre-ingest uniform collapse triggered on streams"
                        f" {np.nonzero(collapse_mask)[0].tolist()[:8]} but"
                        f" {ADAPTIVE_ENV}=0: refusing to degrade alpha (widen the"
                        " window or re-enable the switch)"
                    )
                self._apply_collapse(collapse_mask)
            elif recenter_mask.any():
                mask_d = torch.from_numpy(recenter_mask).to(self.device)
                self._inner.recenter(torch.where(mask_d, offs, st.key_offset))
            else:
                return  # only at-cap streams remain: they clamp, counted

    def _maybe_collapse(self) -> bool:
        """Post-ingest trigger -> whether any stream collapsed: a stream
        collapses when its edge-clamped mass grew, since the last collapse,
        by more than ``spec.collapse_threshold`` of its binned mass.  Raises
        ``SpecError`` when it fires while ``SKETCHES_TPU_ADAPTIVE=0``."""
        st = self._inner.state
        collapsed, binned, level = (
            x.to(torch.float64).cpu().numpy()
            for x in (st.collapsed_low + st.collapsed_high, st.count - st.zero_count,
                      self._level)
        )
        growth = collapsed - self._trigger_collapsed
        mask = (growth > self.spec.collapse_threshold * np.maximum(binned, 1.0)) & (
            level < self.spec.max_collapses
        )
        if not mask.any():
            return False
        if not adaptive_enabled():
            raise SpecError(
                f"uniform collapse triggered on streams {np.nonzero(mask)[0].tolist()[:8]}"
                f" but {ADAPTIVE_ENV}=0: refusing to degrade alpha (raise the window,"
                " recenter, or re-enable the switch)"
            )
        self._apply_collapse(mask)
        return True

    def _apply_collapse(self, mask: np.ndarray) -> None:
        """Collapse the masked streams one level and recentre them on their
        binned-mass median (``ceil(key_offset / 2)`` alone leaves the halved
        occupancy off-centre), in place, chunk by chunk."""
        spec = self.spec
        mask_d = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        mask_d = mask_d & (self._level < spec.max_collapses)

        def body(st, m):
            new = _collapse_body(spec, st, m)
            offs = batched.data_center_offsets(spec, new)
            return _recenter_body(spec, new, torch.where(m, offs, new.key_offset))

        inner = self._inner
        inner._stream_op(body, mask_d)
        inner.state = inner.state  # the setter: plans and recenter policy reset
        self._level = self._level + mask_d.to(torch.int32)
        self._any_level = True
        self._trigger_collapsed = self._collapsed_host()
        mask = np.asarray(mask, bool)
        n = int(mask.sum())
        if telemetry._ACTIVE:
            telemetry.counter_inc("backend.collapses", float(n))
            alpha = effective_alpha(spec, self._level).cpu().numpy()
            for s in np.nonzero(mask)[0][:8]:
                telemetry.gauge_set(
                    "backend.effective_alpha", float(alpha[s]), stream=int(s)
                )
        if tracing._ACTIVE:
            tracing.record_event("backend.collapse", n_streams=n, component="adaptive")

    def collapse(self, mask=None) -> "AdaptiveDDSketch":
        """Collapse the masked streams (default: all) one level; streams at
        ``spec.max_collapses`` are left out.  Raises ``SpecError`` when
        ``SKETCHES_TPU_ADAPTIVE=0``.  Returns self."""
        if not adaptive_enabled():
            raise SpecError(f"explicit collapse refused: {ADAPTIVE_ENV}=0")
        m = np.ones((self.n_streams,), bool) if mask is None else np.asarray(mask, bool)
        self._apply_collapse(m)
        return self

    def get_quantile_value(self, q: float) -> torch.Tensor:
        """Per-stream value at ``q`` -> ``[n_streams]`` (NaN if empty)."""
        return self.get_quantile_values([q])[:, 0]

    def get_quantile_values(self, quantiles: Sequence[float]) -> torch.Tensor:
        """Level-corrected multi-quantile -> ``[n_streams, Q]``, within
        :meth:`effective_alpha` of the true quantiles; NaN for empty
        streams or q outside [0, 1]."""
        return correct_values(self.spec, self._level, self._inner.get_quantile_values(quantiles))

    def get_quantile_values_resolved(self, quantiles: Sequence[float],
                                     disabled_tiers: Sequence[str] = ()):
        """:meth:`get_quantile_values` naming the wrapped facade's tier ->
        ``(tier, [n_streams, Q])``."""
        tier, vals = self._inner.get_quantile_values_resolved(
            quantiles, disabled_tiers=disabled_tiers
        )
        return tier, correct_values(self.spec, self._level, vals)

    def _query_choice(self, qs_tuple, disabled=frozenset()):
        """The wrapped facade's resolved ``(tier, fn)``; the level
        correction rides :meth:`get_quantile_values_resolved`."""
        return self._inner._query_choice(qs_tuple, disabled)

    def merge(self, other: "AdaptiveDDSketch") -> "AdaptiveDDSketch":
        """Fold ``other`` in, collapsing the finer operand first (per stream
        to the pairwise max level, further while the union does not fit one
        window).  Raises ``UnequalSketchParametersError`` on a spec
        mismatch, and ``SpecError`` when the merge needs a collapse while
        ``SKETCHES_TPU_ADAPTIVE=0`` (nothing is changed then)."""
        if not self.mergeable(other):
            raise UnequalSketchParametersError(
                "Cannot merge two adaptive sketches with different specs"
            )
        mine, theirs = align_for_merge(
            self.spec, self.state, AdaptiveState(other._inner.state, other._level.to(self.device))
        )
        target = mine.level
        if not adaptive_enabled():
            deepened = (target > self._level) | (target > other._level.to(self.device))
            if bool(deepened.any()):
                raise SpecError(
                    "mixed-gamma merge needs a collapse on streams"
                    f" {torch.nonzero(deepened)[:, 0].tolist()[:8]} but"
                    f" {ADAPTIVE_ENV}=0: refusing to degrade alpha"
                )
        # Guarded integrity seam on the level-aligned bases: collapse
        # changes content, so the accounting starts after alignment.
        _ipre = (
            integrity.premerge(self.spec, mine.base, theirs.base)
            if integrity._ACTIVE
            else None
        )
        inner = self._inner
        inner.state = mine.base
        inner._stream_op(functools.partial(batched._merge_aligned_body, self.spec), theirs.base)
        inner._invalidate_plans()
        self._level = target
        self._any_level = self._any_level or other._any_level or bool((target > 0).any())
        if _ipre is not None:
            integrity.postmerge(self.spec, inner.state, _ipre, seam="adaptive.merge")
        self._trigger_collapsed = self._collapsed_host()
        return self

    def mergeable(self, other) -> bool:
        return getattr(other, "spec", None) == self.spec

    # -- observability -----------------------------------------------------
    def effective_alpha(self) -> torch.Tensor:
        """Per-stream realized relative-accuracy bound -> ``[n_streams]``."""
        return effective_alpha(self.spec, self._level)

    def collapsed_fraction(self) -> torch.Tensor:
        """Per-stream edge-clamped fraction of the binned mass."""
        return self._inner.collapsed_fraction()

    @property
    def level(self) -> torch.Tensor:
        return self._level

    @property
    def state(self) -> AdaptiveState:
        return AdaptiveState(self._inner.state, self._level)

    @state.setter
    def state(self, new_state: AdaptiveState) -> None:
        # The external choke point (checkpoint restore): the wrapped setter
        # drops its caches; the trigger re-baselines.
        self._inner.state = new_state.base
        self._level = new_state.level.to(device=self.device, dtype=torch.int32)
        self._any_level = bool((self._level > 0).any())
        self._trigger_collapsed = self._collapsed_host()

    @property
    def device(self) -> torch.device:
        return self._inner.device

    @property
    def engine(self) -> str:
        return self._inner.engine

    @property
    def n_streams(self) -> int:
        return self._inner.n_streams

    @property
    def count(self) -> torch.Tensor:
        return self._inner.count

    @property
    def relative_accuracy(self) -> float:
        return self.spec.relative_accuracy

    def __repr__(self) -> str:
        return (
            f"AdaptiveDDSketch(n_streams={self.n_streams}, n_bins={self.spec.n_bins},"
            f" relative_accuracy={self.spec.relative_accuracy},"
            f" threshold={self.spec.collapse_threshold}, device={self.device})"
        )
