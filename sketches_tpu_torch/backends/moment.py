"""Compact moment-summary backend: ~100 bytes a stream, maxent quantiles
(PyTorch port of ``sketches_tpu/backends/moment.py``).

The moments sketch (arXiv:1803.01969): per stream ``count``,
``zero_count``, ``neg_count``, ``sum``, ``min``, ``max`` plus ``k`` power
sums of the nonzero values and ``k`` power sums of ``ln |v|``, all f32 on
the device: ``(6 + 2k) * 4`` bytes a stream (120 at the default k = 12).

* **Ingest** (:func:`add`) is plain torch: the JAX package computes it
  outside any Pallas kernel, as one fused pass of ``k``
  multiply-accumulates.  Lanes route as in the dense tier: ``weights <= 0``
  is padding, ``|v|`` under the smallest normal and NaN take the zero path,
  NaN poisons ``sum``.  The f32 sums follow torch's reduction order, so
  they agree with the JAX package's to a few ulps, not bit for bit.
* **Merge** is elementwise addition (min/min, max/max).
* **Query** (:func:`quantile`) runs on the host: the JAX package's numpy
  maximum-entropy solve, copied as it is, so equal f32 states answer bit
  for bit alike in both packages.

Armed telemetry counts the host solves (``backend.moment_solves``,
``backend.moment_fallbacks``) and times the facade's ``add``; the armed
accuracy audit samples it, as in the JAX package.

Failure modes: empty streams answer NaN; a failed maxent solve falls back
to fewer moments (then a uniform density), never raises; merging unequal
specs raises ``UnequalSketchParametersError``; a non-moment spec raises
``SpecError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sketches_tpu_torch import accuracy, faults, integrity, resilience, telemetry
from sketches_tpu_torch.batched import DEFAULT_REL_ACC, SketchSpec, resolve_device
from sketches_tpu_torch.mapping import zero_threshold
from sketches_tpu_torch.resilience import (
    ShardLossError,
    ShardLossReport,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

__all__ = [
    "MomentState",
    "MomentDDSketch",
    "FIELDS",
    "init",
    "add",
    "merge",
    "merge_axis",
    "psum_merge",
    "fold_hosts",
    "quantile",
    "bytes_per_stream",
]

#: CDF grid resolution of the maxent solve.
_GRID = 512

_MAX_NEWTON = 60

#: The state's leaves, in field order (the checkpoint members too).
FIELDS = ("count", "zero_count", "neg_count", "sum", "min", "max", "powers", "log_powers")


@dataclasses.dataclass
class MomentState:
    """Per-batch moment-summary state, one f32 tensor per leaf.

    ``powers[:, i]`` is the weighted sum of ``v**(i+1)`` over nonzero
    finite values (either sign); ``log_powers[:, i]`` that of
    ``ln|v| ** (i+1)``.  ``min``/``max`` are +-inf for empty streams.
    """

    count: torch.Tensor  # [n_streams] total weight (zeros and NaN included)
    zero_count: torch.Tensor  # [n_streams]
    neg_count: torch.Tensor  # [n_streams] weight of v < 0 lanes
    sum: torch.Tensor  # [n_streams]
    min: torch.Tensor  # [n_streams]
    max: torch.Tensor  # [n_streams]
    powers: torch.Tensor  # [n_streams, k]
    log_powers: torch.Tensor  # [n_streams, k]

    @property
    def n_streams(self) -> int:
        return self.count.shape[-1]

    @property
    def n_moments(self) -> int:
        return self.powers.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.count.device

    def map(self, fn) -> "MomentState":
        """A new state with ``fn`` applied to every leaf."""
        return MomentState(**{f: fn(getattr(self, f)) for f in FIELDS})

    @classmethod
    def cat(cls, states) -> "MomentState":
        """The states stacked along the stream axis, leaf by leaf."""
        return cls(**{f: torch.cat([getattr(s, f) for s in states]) for f in FIELDS})


def init(spec: SketchSpec, n_streams: int, device=None) -> MomentState:
    """An empty moment batch of ``spec.n_moments`` power sums on ``device``
    (the card by default)."""
    dev = resolve_device(device)
    k, dt = spec.n_moments, spec.dtype

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    n = n_streams
    return MomentState(
        count=full((n,), 0.0),
        zero_count=full((n,), 0.0),
        neg_count=full((n,), 0.0),
        sum=full((n,), 0.0),
        min=full((n,), float("inf")),
        max=full((n,), float("-inf")),
        powers=full((n, k), 0.0),
        log_powers=full((n, k), 0.0),
    )


def bytes_per_stream(spec: SketchSpec) -> int:
    """Device bytes per stream of the moment state (``<= 256`` at every
    legal ``n_moments``)."""
    itemsize = torch.finfo(spec.dtype).bits // 8
    return (6 + 2 * spec.n_moments) * itemsize


def add(spec: SketchSpec, mstate: MomentState, values, weights=None) -> MomentState:
    """Ingest ``values[n_streams, S]`` -> a new state: masks, then ``k``
    multiply-accumulates per basis (no scatter, no bins)."""
    v = torch.as_tensor(values, dtype=spec.dtype, device=mstate.device)
    if v.ndim == 1:
        v = v[:, None]
    if v.shape[-1] == 0:
        return mstate
    if weights is None:
        w = torch.ones_like(v)
    else:
        w = torch.as_tensor(weights, dtype=spec.dtype, device=v.device)
        if w.ndim == 1:
            w = w[:, None]
        w = w.broadcast_to(v.shape)
    live = w > 0
    tiny = zero_threshold(v.dtype)
    absv = v.abs()
    routable = live & (absv >= tiny)  # NaN fails -> zero path
    zeroish = live & ~(absv >= tiny)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    wl = torch.where(routable, w, zero)
    x = torch.where(routable, v, zero)
    lx = torch.log(torch.where(routable, absv, torch.ones_like(v)))
    p_terms, l_terms = [], []
    xt = torch.ones_like(v)
    lt = torch.ones_like(v)
    for _ in range(spec.n_moments):
        xt = xt * x
        lt = lt * lx
        p_terms.append((wl * xt).sum(-1))
        l_terms.append((wl * lt).sum(-1))
    inf = float("inf")
    finite_live = live & ~torch.isnan(v)
    w_live = torch.where(live, w, zero)
    return MomentState(
        count=mstate.count + w_live.sum(-1),
        zero_count=mstate.zero_count + torch.where(zeroish, w, zero).sum(-1),
        neg_count=mstate.neg_count + torch.where(routable & (v < 0), w, zero).sum(-1),
        sum=mstate.sum + (torch.where(live, v, zero) * w_live).sum(-1),
        min=torch.minimum(mstate.min, torch.where(finite_live, v, inf).amin(-1)),
        max=torch.maximum(mstate.max, torch.where(finite_live, v, -inf).amax(-1)),
        powers=mstate.powers + torch.stack(p_terms, dim=-1),
        log_powers=mstate.log_powers + torch.stack(l_terms, dim=-1),
    )


def merge(spec: SketchSpec, a: MomentState, b: MomentState) -> MomentState:
    """The state of having ingested both operands' streams: elementwise
    adds, min/min, max/max.  Empty operands are exact identities."""
    return MomentState(
        count=a.count + b.count,
        zero_count=a.zero_count + b.zero_count,
        neg_count=a.neg_count + b.neg_count,
        sum=a.sum + b.sum,
        min=torch.minimum(a.min, b.min),
        max=torch.maximum(a.max, b.max),
        powers=a.powers + b.powers,
        log_powers=a.log_powers + b.log_powers,
    )


def merge_axis(spec: SketchSpec, mstate: MomentState, axis: int = 0) -> MomentState:
    """Reduce stacked ``[K, n_streams, ...]`` partials over ``axis``."""
    return MomentState(
        count=mstate.count.sum(axis),
        zero_count=mstate.zero_count.sum(axis),
        neg_count=mstate.neg_count.sum(axis),
        sum=mstate.sum.sum(axis),
        min=mstate.min.amin(axis),
        max=mstate.max.amax(axis),
        powers=mstate.powers.sum(axis),
        log_powers=mstate.log_powers.sum(axis),
    )


def psum_merge(spec: SketchSpec, mstates: Sequence[MomentState], n_hosts: int = 1,
               device=None) -> MomentState:
    """Fold one stream shard's moment partials (a list, as the port's
    ``parallel.psum_merge`` takes them) onto ``device``: each host's
    contiguous group first when ``n_hosts > 1``, then the host partials."""
    if not mstates:
        raise SketchValueError("psum_merge needs at least one partial")
    dev = mstates[0].device if device is None else torch.device(device)
    k = len(mstates)
    if k % max(n_hosts, 1):
        raise SpecError(f"{k} partials do not divide into {n_hosts} hosts")
    per = k // max(n_hosts, 1)

    def fold(group):
        out = group[0].map(lambda x: x.to(dev))
        for st in group[1:]:
            out = merge(spec, out, st.map(lambda x: x.to(dev)))
        return out

    return fold([fold(mstates[h * per : (h + 1) * per]) for h in range(k // per)])


def fold_hosts(spec: SketchSpec, mstates: Sequence[MomentState], reachable=None):
    """Cross-host fold of per-host moment partials -> ``(folded state,
    ShardLossReport)``: unreachable hosts (``reachable``, or the armed
    ``dcn.partition`` fault site when it is None) are folded around, their
    mass accounted in the report and counted (``dcn.partitions``); no host
    reachable raises ``ShardLossError``; an empty or shape-mismatched list
    raises ``SketchValueError``."""
    n_hosts = len(mstates)
    if n_hosts == 0:
        raise SketchValueError("fold_hosts needs at least one host state")
    shapes = {tuple(st.powers.shape) for st in mstates}
    if len(shapes) != 1:
        raise SketchValueError(f"fold_hosts needs equal-shape host states; got {shapes}")
    if reachable is None:
        reach = np.ones((n_hosts,), bool)
        part = faults.partitioned_hosts(n_hosts) if faults._ACTIVE else ()
        if part:
            reach[list(part)] = False
    else:
        reach = np.asarray(reachable, bool).reshape(-1)
        if reach.shape[0] != n_hosts:
            raise SketchValueError(f"reachable mask length {reach.shape[0]} != {n_hosts} hosts")
    if not reach.any():
        raise ShardLossError(f"all {n_hosts} hosts unreachable across DCN; nothing to fold")
    live = [st for st, r in zip(mstates, reach) if r]
    folded = live[0]
    for st in live[1:]:
        folded = merge(spec, folded, st.map(lambda x: x.to(folded.device)))
    counts = np.stack([st.count.double().cpu().numpy() for st in mstates])
    report = ShardLossReport(
        live=reach,
        surviving_count=counts[reach].sum(0),
        dropped_count=counts[~reach].sum(0),
    )
    if not reach.all():
        resilience.bump("dcn.partitions", int((~reach).sum()))
    return folded, report


# ---------------------------------------------------------------------------
# Host-side maximum-entropy quantile solve (the JAX package's, as it is)
# ---------------------------------------------------------------------------


def _std_power_moments(sums: np.ndarray, mass: float, c: float, s: float,
                       k: int) -> np.ndarray:
    """Raw power sums -> standardized moments ``E[((t-c)/s)**j]``,
    ``j = 0..k`` (f64 binomial shift; the classic msketch conversion).
    Returns NaN-free prefix only -- the caller trims at the first
    non-finite entry."""
    e = np.empty(k + 1, np.float64)
    e[0] = 1.0
    e[1:] = sums[:k] / mass
    out = np.empty(k + 1, np.float64)
    for j in range(k + 1):
        acc = 0.0
        for i in range(j + 1):
            acc += math.comb(j, i) * e[i] * (-c) ** (j - i)
        out[j] = acc / s**j
    return out


def _cheb_moments(std: np.ndarray) -> np.ndarray:
    """Standardized power moments -> Chebyshev moments ``E[T_j(y)]``
    (exact linear map; f64)."""
    from numpy.polynomial import chebyshev as C

    k = std.shape[0] - 1
    out = np.empty(k + 1, np.float64)
    for j in range(k + 1):
        coef = C.cheb2poly(np.eye(j + 1, dtype=np.float64)[j])
        out[j] = float((coef * std[: coef.shape[0]]).sum())
    return out


def _maxent_density(mu: np.ndarray) -> Optional[np.ndarray]:
    """Newton-solve the maxent dual for Chebyshev moments ``mu`` ->
    grid density ``[|_GRID|]`` (normalized to sum 1), or None when the
    solve fails to converge (the caller falls back to fewer moments)."""
    from numpy.polynomial import chebyshev as C

    k = mu.shape[0] - 1
    y = (np.arange(_GRID, dtype=np.float64) + 0.5) / _GRID * 2.0 - 1.0
    dy = 2.0 / _GRID
    t = C.chebvander(y, k)  # [_GRID, k+1]
    del dy  # normalization is explicit below; the measure scale cancels
    lam = np.zeros(k, np.float64)  # lambda_1..k; T_0's weight = log Z
    t1 = t[:, 1:]
    for _ in range(_MAX_NEWTON):
        logp = t1 @ lam
        logp -= logp.max()  # overflow guard
        p = np.exp(logp)
        p /= p.sum()  # probability masses on the grid
        e_t = (t1 * p[:, None]).sum(0)  # E_p[T_j], j=1..k
        g = e_t - mu[1:]
        if not np.all(np.isfinite(g)):
            return None
        if np.abs(g).max() < 1e-9:
            return p
        # Newton on the normalized dual: Hessian = Cov_p[T_i, T_j].
        h = (t1.T * p) @ t1 - np.outer(e_t, e_t)
        h += np.eye(k) * 1e-10
        try:
            step = np.linalg.solve(h, g)
        except np.linalg.LinAlgError:
            return None
        norm = np.abs(step).max()
        if norm > 4.0:  # damping: long steps overshoot the dual
            step *= 4.0 / norm
        lam -= step
    logp = t1 @ lam
    p = np.exp(logp - logp.max())
    if not np.all(np.isfinite(p)) or p.sum() <= 0:
        return None
    return p / p.sum()


def _finite_prefix(arr: np.ndarray) -> int:
    """Length of the leading finite run (f32 power sums can saturate at
    high orders; the solver uses only the trustworthy prefix)."""
    bad = ~np.isfinite(arr)
    return int(np.argmax(bad)) if bad.any() else arr.shape[0]


#: Relative error budget of the f32-accumulated power sums (rounding
#: per fused add, batch reductions, merges; measured ~1e-6 end to end,
#: budgeted with slack).
_F32_SUM_ERR = 3e-6

#: Largest Chebyshev-moment absolute error the maxent solve tolerates
#: before a moment order does more harm than good.
_MOMENT_TOL = 5e-3


def _trusted_order(a: float, b: float, k: int) -> int:
    """Highest moment order whose Chebyshev moment survives f32 noise.

    Two amplifiers sit between the device's f32 power sums and the
    solver's Chebyshev moments: the binomial standardization shift
    (``((M + |c|) / s) ** j`` with ``M = max(|a|, |b|)``) and the
    power->Chebyshev conversion (leading coefficient ``2**(j-1)``).
    Orders whose amplified noise exceeds :data:`_MOMENT_TOL` are noise,
    not signal -- fitting them makes the density strictly worse (the
    observed failure mode on log-asymmetric supports like
    ``uniform(1, 100)``).  Symmetric supports (``c ~ 0``, e.g.
    lognormal in log space) keep their full order.  Always >= 2.
    """
    c, s = (a + b) / 2.0, (b - a) / 2.0
    if s <= 0:
        return 2
    amp = (max(abs(a), abs(b)) + abs(c)) / s
    order = 2
    for j in range(2, k + 1):
        if _F32_SUM_ERR * (amp**j) * (2.0 ** max(j - 1, 0)) > _MOMENT_TOL:
            break
        order = j
    return order


def _stream_quantiles(
    k: int, count: float, zero: float, neg: float, vmin: float,
    vmax: float, powers: np.ndarray, log_powers: np.ndarray,
    qs: np.ndarray,
) -> Tuple[np.ndarray, bool]:
    """One stream's maxent quantiles -> ``(values[Q], used_fallback)``.

    NaN row for an empty stream; zero-only streams answer 0; constant
    streams answer the constant.  The basis is log-moments for
    all-positive streams (the accurate choice for long tails), raw
    power moments otherwise.
    """
    if not count > 0:
        return np.full(qs.shape, np.nan), False
    nz = count - zero
    if not nz > 0:  # all mass in the zero bucket
        return np.zeros(qs.shape), False
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return np.full(qs.shape, np.nan), False
    use_log = vmin > 0.0
    if use_log:
        a, b = math.log(vmin), math.log(vmax)
        sums = log_powers
    else:
        a, b = vmin, vmax
        sums = powers
    fallback = False
    if b - a < 1e-12 * max(1.0, abs(a)):
        density = np.full(_GRID, 1.0 / _GRID)
        a = b = (a + b) / 2.0
        grid = np.full(_GRID, a)
    else:
        c, s = (a + b) / 2.0, (b - a) / 2.0
        kk = min(k, _finite_prefix(sums), _trusted_order(a, b, k))
        density = None
        while kk >= 2:
            std = _std_power_moments(sums, nz, c, s, kk)
            if np.all(np.isfinite(std)):
                mu = _cheb_moments(std)
                density = _maxent_density(mu)
                if density is not None:
                    break
            fallback = True
            kk //= 2
        if density is None:  # 0-moment maxent: uniform on [a, b]
            fallback = True
            density = np.full(_GRID, 1.0 / _GRID)
        y = (np.arange(_GRID, dtype=np.float64) + 0.5) / _GRID * 2.0 - 1.0
        grid = c + s * y
    if use_log:
        grid = np.exp(grid)
    # Mixture CDF over sorted support: continuous part (weight nz) plus
    # a point mass at 0 (weight zero).  ``grid`` is increasing in value
    # space for both bases (exp is monotone).
    w = density * nz
    if zero > 0:
        pos = int(np.searchsorted(grid, 0.0))
        grid = np.insert(grid, pos, 0.0)
        w = np.insert(w, pos, zero)
    cdf = np.cumsum(w) / count
    idx = np.searchsorted(cdf, np.clip(qs, 0.0, 1.0), side="left")
    idx = np.clip(idx, 0, grid.shape[0] - 1)
    out = grid[idx]
    valid = (qs >= 0.0) & (qs <= 1.0)
    return np.where(valid, out, np.nan), fallback




def quantile(spec: SketchSpec, mstate: MomentState, qs) -> np.ndarray:
    """Quantile values for ``qs[Q]`` across the batch -> ``[n_streams, Q]``
    (numpy f32): one maxent Newton solve per nonempty stream on the host.
    Empty streams and q outside [0, 1] answer NaN; failed solves fall back
    down the moment ladder, never raise.  Accuracy is the moment-truncation
    envelope, not the dense alpha contract."""
    qs_arr = np.atleast_1d(np.asarray(qs, np.float64))
    count, zero, neg, vmin, vmax, powers, log_powers = (
        getattr(mstate, f).cpu().numpy().astype(np.float64)
        for f in ("count", "zero_count", "neg_count", "min", "max", "powers", "log_powers")
    )
    n = count.shape[0]
    out = np.empty((n, qs_arr.shape[0]), np.float64)
    n_fallback = 0
    for i in range(n):
        out[i], fb = _stream_quantiles(
            int(mstate.n_moments), float(count[i]), float(zero[i]),
            float(neg[i]), float(vmin[i]), float(vmax[i]), powers[i],
            log_powers[i], qs_arr,
        )
        n_fallback += bool(fb)
    if telemetry._ACTIVE:
        telemetry.counter_inc("backend.moment_solves", float(n))
        if n_fallback:
            telemetry.counter_inc("backend.moment_fallbacks", float(n_fallback))
    return out.astype(np.float32)


class MomentDDSketch:
    """Stateful facade of the moment-summary backend.

    ``add`` / ``merge`` / ``get_quantile_values`` over :class:`MomentState`
    on the card (``device="cpu"`` for the CPU); ingest is one plain-torch
    pass, queries run the host maxent solve.  The single engine reports the
    tier ``"moment"`` and ignores tier exclusions.

    Failure modes: empty streams answer NaN; failed solves fall back, never
    raise; merging unequal specs raises ``UnequalSketchParametersError``;
    invalid construction raises ``SpecError``.
    """

    def __init__(
        self,
        n_streams: int,
        relative_accuracy: float = DEFAULT_REL_ACC,
        n_moments: Optional[int] = None,
        spec: Optional[SketchSpec] = None,
        state: Optional[MomentState] = None,
        engine: str = "auto",  # accepted for facade parity; one engine
        device=None,
    ):
        if spec is None:
            spec = SketchSpec(
                relative_accuracy=relative_accuracy,
                backend="moment",
                n_moments=12 if n_moments is None else n_moments,
            )
        if spec.backend != "moment":
            raise SpecError(f"MomentDDSketch needs backend='moment'; got {spec.backend!r}")
        self.spec = spec
        self.device = resolve_device(device, state)
        if state is not None and state.device != self.device:
            raise SpecError(f"state lives on {state.device}, not on {self.device}")
        self._state = init(spec, n_streams, self.device) if state is None else state

    def add(self, values, weights=None) -> "MomentDDSketch":
        """Ingest ``values[n_streams, S]``; padding and NaN follow the dense
        tier.  Returns self."""
        _t0 = telemetry.clock() if telemetry._ACTIVE else None
        self._state = add(self.spec, self._state, values, weights)
        if _t0 is not None:
            telemetry.finish_span("ingest_s", _t0, component="moment", engine="moment")
        if accuracy._ACTIVE:
            accuracy.observe_ingest(self, values, weights)
        return self

    def get_quantile_value(self, q: float) -> np.ndarray:
        """Per-stream value at ``q`` -> ``[n_streams]`` (NaN if empty)."""
        return self.get_quantile_values([q])[:, 0]

    def get_quantile_values(self, quantiles: Sequence[float]) -> np.ndarray:
        """Maxent multi-quantile -> ``[n_streams, Q]`` (numpy f32)."""
        return quantile(self.spec, self._state, [float(q) for q in quantiles])

    def get_quantile_values_resolved(self, quantiles: Sequence[float],
                                     disabled_tiers: Sequence[str] = ()):
        """-> ``("moment", values)``; the one engine is its own floor, so
        ``disabled_tiers`` is ignored."""
        return "moment", self.get_quantile_values(quantiles)

    def _query_choice(self, qs_tuple, disabled=frozenset()):
        """The resolved ``(tier, fn)``: always the ``"moment"`` engine."""
        return "moment", lambda state, qs_arr: quantile(self.spec, state, np.asarray(qs_arr))

    def merge(self, other: "MomentDDSketch") -> "MomentDDSketch":
        """Fold ``other`` in (elementwise).  Raises
        ``UnequalSketchParametersError`` on a spec mismatch."""
        if not self.mergeable(other):
            raise UnequalSketchParametersError(
                "Cannot merge two moment sketches with different specs"
            )
        theirs = other._state.map(lambda x: x.to(self.device))
        _fp_pre = None
        if integrity._ACTIVE:
            _fp_pre = integrity.fingerprint(self.spec, self._state) + integrity.fingerprint(
                other.spec, theirs
            )
        self._state = merge(self.spec, self._state, theirs)
        if _fp_pre is not None:
            integrity.verify_moment_merge(self.spec, self._state, _fp_pre, seam="moment.merge")
        return self

    def mergeable(self, other) -> bool:
        return getattr(other, "spec", None) == self.spec

    @property
    def state(self) -> MomentState:
        return self._state

    @state.setter
    def state(self, new_state: MomentState) -> None:
        if new_state.device != self.device:
            raise SpecError(f"state lives on {new_state.device}, not on {self.device}")
        self._state = new_state

    @property
    def n_streams(self) -> int:
        return self._state.count.shape[0]

    @property
    def count(self) -> torch.Tensor:
        return self._state.count

    @property
    def sum(self) -> torch.Tensor:  # noqa: A003 - reference API name
        return self._state.sum

    @property
    def relative_accuracy(self) -> float:
        return self.spec.relative_accuracy

    def bytes_per_stream(self) -> int:
        """Device bytes per stream (120 at the default k = 12)."""
        return bytes_per_stream(self.spec)

    def __repr__(self) -> str:
        return (
            f"MomentDDSketch(n_streams={self.n_streams}, n_moments={self.spec.n_moments},"
            f" bytes_per_stream={self.bytes_per_stream()}, device={self.device})"
        )
