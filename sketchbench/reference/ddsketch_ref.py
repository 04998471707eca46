"""Plain reference of the benchmark's DDSketch deployments.

Written from the published definitions in DataDog/sketches-py and nothing
else: ``ddsketch/mapping.py`` (``LogarithmicMapping``,
``CubicallyInterpolatedMapping``), ``ddsketch/store.py``
(``CollapsingLowestDenseStore``: a window of ``bin_limit`` bins whose edge
bins take the mass that falls outside) and ``ddsketch/ddsketch.py``
(``get_quantile_value``: rank ``q * (count - 1)``, the positive store's
lowest key whose running count exceeds the rank).  It imports torch alone:
nothing of the program under test, whose outputs it only judges.

Keys are computed in float64.  A program that keys in float32 may round a
value that lies within ``DELTA`` key units of a bucket edge to either side
of it, so every value carries two candidate keys, ``ceil(x - DELTA)`` and
``ceil(x + DELTA)``, equal for all but those values.  Each leaf of the
state then has an interval of sound readings: a count, a bound or a
running sum of the bins must lie between what all low candidates and all
high candidates give.  Outside that interval a reading is wrong.

The control (``reference/bf16_system.py``) keys with the same functions
in bfloat16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

#: Key units by which a float32 program's key arithmetic may miss the exact
#: one (f32 log, a rounded multiplier and product: at most about 3e-4 at
#: the keys these deployments reach, |key| < 2000).
DELTA = 1e-3

#: Below this magnitude a value lands in the zero bucket: the smallest
#: positive normal float32 (the f32 deployments' ``min_possible``
#: convention), and NaN with it.
ZERO_THRESHOLD = 1.1754943508222875e-38

#: The positive store's window is centred on the middle of a 128-bin tile
#: at ``n_bins // 2 - 64`` (windows of 512 bins or more).
TILE = 128


class Mapping:
    """``KeyMapping`` of sketches-py: ``key(v) = ceil(log_gamma(v))`` and
    ``value(k) = pow_gamma(k) * 2 / (1 + gamma)``, with
    ``gamma = (1 + a) / (1 - a)`` and the multiplier ``1 / ln(gamma)``
    (the cubic mapping divides it by ``C = 10 / 7``)."""

    A = 6.0 / 35.0
    B = -3.0 / 5.0
    C = 10.0 / 7.0

    def __init__(self, name: str, relative_accuracy: float):
        if name not in ("logarithmic", "cubic_interpolated"):
            raise ValueError(f"no reference for mapping {name!r}")
        self.name = name
        gamma_mantissa = 2.0 * relative_accuracy / (1.0 - relative_accuracy)
        self.gamma = 1.0 + gamma_mantissa
        self.multiplier = 1.0 / math.log1p(gamma_mantissa)
        if name == "cubic_interpolated":
            self.multiplier /= self.C

    def log_gamma(self, v: torch.Tensor) -> torch.Tensor:
        """``log_gamma`` of positive values, in ``v``'s own dtype."""
        if self.name == "logarithmic":
            return torch.log(v) * self.multiplier
        mantissa, exponent = torch.frexp(v)
        s = 2.0 * mantissa - 1.0
        cubic = ((self.A * s + self.B) * s + self.C) * s
        return (cubic + (exponent - 1).to(v.dtype)) * self.multiplier

    def pow_gamma(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`log_gamma` (float64; the cubic by Cardano's
        formula, as ``_cubic_exp2`` has it)."""
        x = x.to(torch.float64) / self.multiplier
        if self.name == "logarithmic":
            return torch.exp(x)
        a, b, c = self.A, self.B, self.C
        exponent = torch.floor(x)
        delta_0 = b * b - 3.0 * a * c
        delta_1 = 2.0 * b ** 3 - 9.0 * a * b * c - 27.0 * a * a * (x - exponent)
        inner = (delta_1 - torch.sqrt(delta_1 * delta_1 - 4.0 * delta_0 ** 3)) / 2.0
        cardano = torch.sign(inner) * inner.abs() ** (1.0 / 3.0)
        plus_one = -(b + cardano + delta_0 / cardano) / (3.0 * a) + 1.0
        return torch.ldexp(plus_one / 2.0, exponent + 1.0)

    def value(self, key: torch.Tensor) -> torch.Tensor:
        return self.pow_gamma(key.to(torch.float64)) * (2.0 / (1.0 + self.gamma))

    def key_of_value(self, value: torch.Tensor) -> torch.Tensor:
        """The real key whose representative is ``value`` (> 0): an
        integer, to the decode's rounding, for any value a sketch returns."""
        return self.log_gamma(value.to(torch.float64) * ((1.0 + self.gamma) / 2.0))


def center_bin(n_bins: int) -> int:
    return n_bins // 2 - TILE // 2 if n_bins >= 512 else n_bins // 2


@dataclasses.dataclass
class Keyed:
    """One value batch, keyed: candidate keys and masks, ``[R, W]``."""

    values: torch.Tensor  # float64 (or the control's dtype)
    weights: torch.Tensor
    live: torch.Tensor
    is_pos: torch.Tensor
    is_neg: torch.Tensor
    is_zero: torch.Tensor
    k_lo: torch.Tensor  # int64
    k_hi: torch.Tensor


def key_batch(mapping: Mapping, values: torch.Tensor, weights: Optional[torch.Tensor],
              dtype=torch.float64, delta: float = DELTA) -> Keyed:
    """Key a batch ``values[R, W]`` (``weights`` 0 marks padding)."""
    v = values.to(dtype)
    w = torch.ones_like(v) if weights is None else weights.to(dtype).broadcast_to(v.shape)
    live = w > 0
    is_pos = v >= ZERO_THRESHOLD
    is_neg = v <= -ZERO_THRESHOLD
    is_zero = ~(is_pos | is_neg)
    x = mapping.log_gamma(torch.where(is_zero, torch.ones_like(v), v.abs()))
    k_lo = torch.ceil(x - delta).to(torch.int64)
    k_hi = torch.ceil(x + delta).to(torch.int64)
    return Keyed(v, w, live, is_pos, is_neg, is_zero, k_lo, k_hi)


def offset_interval(kb: Keyed, n_bins: int):
    """Each stream's window offset from its first batch by the median rule
    (the median key of the live nonzero values, lower median, minus
    :func:`center_bin`; a stream with none keeps ``-(n_bins // 2)``)
    -> ``(lo [R], hi [R])`` int64 over the candidate keys."""
    nonzero = kb.live & ~kb.is_zero
    n_live = nonzero.sum(-1)
    mid = torch.clamp((n_live - 1) // 2, min=0)[:, None]
    big = 1 << 40

    def med(k):
        return torch.sort(torch.where(nonzero, k, big), dim=-1).values.gather(1, mid)[:, 0]

    default = torch.full_like(n_live, -(n_bins // 2))
    lo = torch.where(n_live > 0, med(kb.k_lo) - center_bin(n_bins), default)
    hi = torch.where(n_live > 0, med(kb.k_hi) - center_bin(n_bins), default)
    return lo, hi


@dataclasses.dataclass
class RefState:
    """Reference state of ``R`` streams: each leaf as a pair of bounds
    (``*_lo``, ``*_hi``) where float32 keying may move it, exact otherwise.
    ``cum_*`` are running sums of the bins, ``[R, n_bins]``."""

    offset: torch.Tensor  # the window offsets the leaves are keyed against
    count: torch.Tensor
    zero_count: torch.Tensor
    neg_total: torch.Tensor
    sum: torch.Tensor
    abs_sum: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    cum_pos_lo: torch.Tensor
    cum_pos_hi: torch.Tensor
    cum_neg_lo: torch.Tensor
    cum_neg_hi: torch.Tensor
    bounds: Dict[str, torch.Tensor]  # pos_lo_lo, pos_lo_hi, ..., clow_lo, ...
    offset_lo: Optional[torch.Tensor] = None  # the median rule's sound offsets
    offset_hi: Optional[torch.Tensor] = None

    def scaled_add(self, other: "RefState", m: float) -> None:
        """``self += m * other`` for the additive leaves; min/max/bounds
        fold by min and max (``m`` > 0)."""
        for f in ("count", "zero_count", "neg_total", "sum", "abs_sum", "cum_pos_lo",
                  "cum_pos_hi", "cum_neg_lo", "cum_neg_hi"):
            getattr(self, f).add_(getattr(other, f), alpha=m)
        self.min = torch.minimum(self.min, other.min)
        self.max = torch.maximum(self.max, other.max)
        for k, v in other.bounds.items():
            if k.startswith(("pos_lo", "neg_lo")):
                self.bounds[k] = torch.minimum(self.bounds[k], v)
            elif k.startswith(("pos_hi", "neg_hi")):
                self.bounds[k] = torch.maximum(self.bounds[k], v)
            else:
                self.bounds[k] = self.bounds[k] + m * v


def batch_state(kb: Keyed, offset: torch.Tensor, n_bins: int) -> RefState:
    """One batch ingested into empty windows at ``offset [R]``."""
    dt = kb.values.dtype
    r = kb.values.shape[0]
    off = offset[:, None]
    w = torch.where(kb.live, kb.weights, torch.zeros_like(kb.weights))
    w_pos = torch.where(kb.is_pos, w, torch.zeros_like(w))
    w_neg = torch.where(kb.is_neg, w, torch.zeros_like(w))
    w_sig = w_pos + w_neg

    def hist(k, wt):
        idx = torch.clamp(k - off, 0, n_bins - 1)
        h = torch.zeros((r, n_bins), dtype=dt, device=kb.values.device)
        return torch.cumsum(h.scatter_add_(1, idx, wt), dim=-1)

    def rowsum(x):
        return x.sum(-1)

    bounds = {}
    for store, hits in (("pos", kb.live & kb.is_pos), ("neg", kb.live & kb.is_neg)):
        for side, k in (("lo", kb.k_lo), ("hi", kb.k_hi)):
            idx = torch.clamp(k - off, 0, n_bins - 1)
            bounds[f"{store}_lo_{side}"] = torch.where(hits, idx, n_bins).amin(-1)
            bounds[f"{store}_hi_{side}"] = torch.where(hits, idx, -1).amax(-1)
    # Mass outside the window: surely (both candidates out) and possibly.
    bounds["clow_lo"] = rowsum(torch.where(kb.k_hi - off < 0, w_sig, 0.0))
    bounds["clow_hi"] = rowsum(torch.where(kb.k_lo - off < 0, w_sig, 0.0))
    bounds["chigh_lo"] = rowsum(torch.where(kb.k_lo - off > n_bins - 1, w_sig, 0.0))
    bounds["chigh_hi"] = rowsum(torch.where(kb.k_hi - off > n_bins - 1, w_sig, 0.0))
    finite = kb.live & ~torch.isnan(kb.values)
    return RefState(
        offset=offset,
        count=rowsum(w),
        zero_count=rowsum(torch.where(kb.is_zero, w, torch.zeros_like(w))),
        neg_total=rowsum(w_neg),
        sum=rowsum(torch.where(kb.live, kb.values, torch.zeros_like(kb.values)) * w),
        abs_sum=rowsum(torch.where(kb.live, kb.values.abs(), torch.zeros_like(kb.values)) * w),
        min=torch.where(finite, kb.values, math.inf).amin(-1),
        max=torch.where(finite, kb.values, -math.inf).amax(-1),
        cum_pos_lo=hist(kb.k_lo, w_pos),
        cum_pos_hi=hist(kb.k_hi, w_pos),
        cum_neg_lo=hist(kb.k_lo, w_neg),
        cum_neg_hi=hist(kb.k_hi, w_neg),
        bounds=bounds,
    )


def empty_state(offset: torch.Tensor, n_bins: int, dtype=torch.float64) -> RefState:
    r = offset.shape[0]
    dev = offset.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    bounds = {}
    for store in ("pos", "neg"):
        for side in ("lo", "hi"):
            bounds[f"{store}_lo_{side}"] = torch.full((r,), n_bins, dtype=torch.int64, device=dev)
            bounds[f"{store}_hi_{side}"] = torch.full((r,), -1, dtype=torch.int64, device=dev)
    for k in ("clow_lo", "clow_hi", "chigh_lo", "chigh_hi"):
        bounds[k] = zeros(r)
    return RefState(
        offset=offset, count=zeros(r), zero_count=zeros(r), neg_total=zeros(r),
        sum=zeros(r), abs_sum=zeros(r),
        min=torch.full((r,), math.inf, dtype=dtype, device=dev),
        max=torch.full((r,), -math.inf, dtype=dtype, device=dev),
        cum_pos_lo=zeros(r, n_bins), cum_pos_hi=zeros(r, n_bins),
        cum_neg_lo=zeros(r, n_bins), cum_neg_hi=zeros(r, n_bins), bounds=bounds,
    )


def rank_interval(q: float, count: torch.Tensor):
    """The rank ``q * (count - 1)`` as a float32 program may compute it
    (``q`` and the product rounded to float32) -> ``(lo, hi)``."""
    q32 = float(torch.tensor(q, dtype=torch.float32))
    base = count - 1.0
    r = q * base
    slack = abs(q32 - q) * base.abs() + 4.0 * 2.0 ** -23 * torch.clamp(r.abs(), min=1.0)
    return r - slack, r + slack


def answer_ok(mapping: Mapping, st: RefState, qs: Sequence[float], answers: torch.Tensor,
              decode_tol: float = 0.01) -> torch.Tensor:
    """``[R, Q]`` bool: whether each answer is one a sound program can give
    for this state.  An answer decodes to a bucket key (within
    ``decode_tol`` key units of an integer), which has to lie between the
    keys that the rank's low and high readings select from the low and high
    running sums (``get_quantile_value``; the negative store by its
    reversed rank, ``lower=False``); zero ranks answer 0, empty streams NaN.
    """
    off = st.offset[:, None]
    ans = answers.to(torch.float64)
    neg, zero, cnt = st.neg_total[:, None], st.zero_count[:, None], st.count[:, None]
    cols = []
    for qi, q in enumerate(qs):
        r_lo, r_hi = rank_interval(q, st.count)
        r_lo, r_hi = r_lo[:, None], r_hi[:, None]
        a = ans[:, qi : qi + 1]
        real = mapping.key_of_value(torch.where(a != 0, a.abs(), torch.ones_like(a)))
        near = torch.round(real)
        decodes = (real - near).abs() <= decode_tol
        key = near.to(torch.int64)

        def between(cum_lo, cum_hi, t_lo, t_hi, right):
            k_low = torch.searchsorted(cum_lo.contiguous(), t_lo.contiguous(), right=right)
            k_high = torch.searchsorted(cum_hi.contiguous(), t_hi.contiguous(), right=right)
            return (key >= k_low + off) & (key <= k_high + off)

        pos_ok = (a > 0) & decodes & between(
            st.cum_pos_lo, st.cum_pos_hi, r_lo - zero - neg, r_hi - zero - neg, True)
        neg_ok = (a < 0) & decodes & between(
            st.cum_neg_lo, st.cum_neg_hi, neg - r_hi, neg - r_lo, False)
        zero_ok = a == 0
        can_neg = r_lo < neg
        can_zero = (r_hi >= neg) & (r_lo < neg + zero)
        can_pos = r_hi >= neg + zero
        ok = (can_pos & pos_ok) | (can_neg & neg_ok) | (can_zero & zero_ok)
        cols.append(torch.where(cnt > 0, ok, torch.isnan(a)))
    return torch.cat(cols, dim=1)


def leaves_ok(st: RefState, prog: Dict[str, torch.Tensor], n_bins: int) -> Dict[str, torch.Tensor]:
    """Per leaf, ``[R]`` bool: whether the program's reading lies in the
    reference's interval.  ``prog`` holds the program's leaves for the same
    rows (any float or int dtype; ``sum`` is judged apart, by
    :func:`sum_gap`)."""
    f64 = torch.float64

    def g(name):
        return prog[name].to(f64)

    def cum_between(bins, lo, hi):
        cum = torch.cumsum(bins.to(f64), dim=-1)
        return ((cum >= hi) & (cum <= lo)).all(-1) & (bins.to(f64) >= 0).all(-1)

    def tiles_between(tiles, lo, hi):
        cum = torch.cumsum(tiles.to(f64), dim=-1)
        edge = slice(TILE - 1, None, TILE)
        return ((cum >= hi[:, edge]) & (cum <= lo[:, edge])).all(-1)

    b = st.bounds
    n_tiles = n_bins // TILE
    tiles = prog["tile_sums"]
    out = {
        "key_offset": (g("key_offset") >= st.offset_lo) & (g("key_offset") <= st.offset_hi),
        "count": g("count") == st.count,
        "zero_count": g("zero_count") == st.zero_count,
        "neg_total": g("neg_total") == st.neg_total,
        "min": g("min") == st.min,
        "max": g("max") == st.max,
        "bins_pos": cum_between(prog["bins_pos"], st.cum_pos_lo, st.cum_pos_hi),
        "bins_neg": cum_between(prog["bins_neg"], st.cum_neg_lo, st.cum_neg_hi),
        "tile_sums": tiles_between(tiles[:, :n_tiles], st.cum_pos_lo, st.cum_pos_hi)
        & tiles_between(tiles[:, n_tiles:], st.cum_neg_lo, st.cum_neg_hi),
        "collapsed_low": (g("collapsed_low") >= b["clow_lo"])
        & (g("collapsed_low") <= b["clow_hi"]),
        "collapsed_high": (g("collapsed_high") >= b["chigh_lo"])
        & (g("collapsed_high") <= b["chigh_hi"]),
    }
    for store in ("pos", "neg"):
        for edge in ("lo", "hi"):
            x = g(f"{store}_{edge}")
            a, c = b[f"{store}_{edge}_lo"], b[f"{store}_{edge}_hi"]
            out[f"{store}_{edge}"] = (x >= torch.minimum(a, c)) & (x <= torch.maximum(a, c))
    return out


def sum_gap(st: RefState, prog_sum: torch.Tensor) -> torch.Tensor:
    """``[R]``: the program's ``sum`` against the exact one, as a share of
    the sum of magnitudes (which bounds any order's rounding)."""
    return (prog_sum.to(torch.float64) - st.sum).abs() / torch.clamp(st.abs_sum, min=1e-300)


def accumulate(states: List[RefState], mults: Sequence[int]) -> RefState:
    """``sum(m_k * states[k])`` over the batches with ``m_k > 0``."""
    first = next(k for k, m in enumerate(mults) if m > 0)
    acc = empty_state(states[first].offset, states[first].cum_pos_lo.shape[1],
                      states[first].cum_pos_lo.dtype)
    for s, m in zip(states, mults):
        if m > 0:
            acc.scaled_add(s, float(m))
    return acc
