"""Self-verifying sketch state of the PyTorch port: invariant checks,
fingerprints, repair (counterpart of ``sketches_tpu.integrity``).

The resilience layer can *inject* faults and *degrade* gracefully,
but a silently corrupted sketch -- a bit-flipped bin vector, a desynced
``count`` -- propagates through ``merge()``/psum folds and quietly
violates the paper's relative-error guarantee (the alpha-contract
UDDSketch, arXiv:2004.08604, and SplineSketch, arXiv:2504.01206, treat
as the invariant worth defending).  This module makes corruption
*detectable*:

* **Invariant checker** (:func:`check_state` / :func:`check_host` /
  :func:`check`): total-mass conservation (``count == zero_count +
  sum(bins)`` across both stores), non-negative masses, derived-counter
  agreement (``neg_total``, ``tile_sums``, occupied bounds), window/
  bounds sanity, the empty-stream identity, and the sum magnitude bound
  ``|sum| <= count * max(|min|, |max|)``.  Runs against host
  ``DDSketch``/``BaseDDSketch``, ``TorchDDSketch``, batched device
  state, and stacked distributed partials (``[K, n_streams, ...]`` pytrees).
* **Cross-boundary fingerprints** (:func:`fingerprint`): a cheap content
  checksum -- each stream's masses weighted by deterministic pseudo-
  random coefficients keyed on the *absolute* bin key -- that is
  invariant under window recentering (keys are preserved) and *additive*
  under merge/fold.  The guarded seams compare fingerprints across the
  boundary (merge operands vs result, per-shard partials vs the psum
  fold's parallel checksum lane, checkpoint save vs restore), so a shard
  corrupted in flight is caught at the fold rather than averaged into
  the answer.
* **Detect -> quarantine -> repair**: violations raise
  :class:`~sketches_tpu_torch.resilience.IntegrityError` (mode
  ``"raise"``) or land in an :class:`IntegrityReport` (mode
  ``"quarantine"``) and are counted in the ``resilience.health()``
  ledger, the declared ``integrity.*`` telemetry metrics and (armed) the
  flight recorder.  :func:`repair` rewrites
  what is *provably* repairable from the bins (the ground truth): clips
  negative masses, recounts ``count``/``neg_total``, recomputes
  ``tile_sums`` and the occupied bounds, and restores the empty-stream
  identities.  ``min``/``max``/``sum`` corruption beyond the magnitude
  bound is detectable but not repairable (the values are gone).

Arming: OFF by default.  ``SKETCHES_TPU_INTEGRITY=1`` (raise mode) or
``SKETCHES_TPU_INTEGRITY=quarantine`` (report mode), declared in
``analysis/registry.py`` and shared with the JAX package; :func:`arm` /
:func:`disarm` switch it programmatically.  Every guarded seam checks
``integrity._ACTIVE`` first, so the disarmed layer costs one attribute
read + bool test per dispatch -- no device fetch, no checksum (the
booby-trap test in ``tests/test_torch_integrity.py`` proves it).

Host numpy, by design: every check and fingerprint fetches the state to
the host (``.cpu().numpy()``, one copy per leaf it reads) and runs the
JAX package's arithmetic on it: the same f64 products, summed by the same
numpy reductions in the same order.  The fingerprint of the same state is
then bit-equal in both packages -- what content-addressed caches and
replica gates rely on.  (The coefficients come from a table over the
keys' span instead of one mix a bin: the same values, faster.)  The
host cost grows with the state: an armed check of 1M x 512 streams
fetches 4 GB.  The windowed checks (``check_window`` /
``verify_window``) come with the windowed sketch (ROADMAP A10).

Detection floor: checks on float (f32) device masses compare within a
rounding tolerance (``_RTOL``/``_ATOL``), so corruption smaller than
the accumulated rounding noise -- a low-order mantissa bit of a heavy
bin -- is below the detection floor; integer-bin specs check exactly.
Corruption that *preserves* every invariant (e.g. consistent forgery of
bins and count together) is detectable only across a fingerprinted
boundary, not by the standalone checker.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from sketches_tpu_torch import telemetry
from sketches_tpu_torch.analysis import registry
from sketches_tpu_torch.resilience import IntegrityError, SketchValueError, bump

__all__ = [
    "INTEGRITY_ENV",
    "IntegrityViolation",
    "IntegrityReport",
    "arm",
    "disarm",
    "enabled",
    "mode",
    "reports",
    "reset",
    "check",
    "check_state",
    "check_host",
    "verify",
    "verify_state",
    "fingerprint",
    "fingerprint_host",
    "verify_fold",
    "verify_reshard",
    "verify_restore",
    "premerge",
    "postmerge",
    "repair",
    "verify_moment_merge",
]

#: Declared in ``analysis/registry.py`` (the kill-switch inventory).
INTEGRITY_ENV = registry.INTEGRITY.name

#: Fast-path guard: guarded seams check this module flag before doing
#: any integrity work, so the disarmed layer costs one bool test.
_ACTIVE = False

#: Armed behavior on a violation: ``"raise"`` (IntegrityError) or
#: ``"quarantine"`` (record a report, keep going).
_MODE = "raise"

_lock = threading.Lock()

#: Bounded ring of reports that carried violations (newest dropped when
#: full).
_MAX_REPORTS = 1024
_reports: List["IntegrityReport"] = []
_reports_dropped = 0

#: Detailed violations kept per report; the rest are counted only.
_MAX_DETAILED = 32

# Float-mode comparison tolerances: f32 device masses accumulate rounding
# (count is a running f32 accumulator; sum(bins) re-sums in f64), so
# derived-counter agreement is judged within atol + rtol * scale.
# Corruption below this floor is undetectable by construction; integer
# bins compare with a half-unit tolerance (exact accumulation).
_RTOL = 1e-4
_ATOL = 1e-2
_HOST_RTOL = 1e-9
_HOST_ATOL = 1e-9


@dataclasses.dataclass(frozen=True)
class IntegrityViolation:
    """One detected violation: the stream it hit, a stable ``invariant``
    slug (``mass_conservation`` / ``negative_mass`` / ``nonfinite`` /
    ``neg_total`` / ``tile_sums`` / ``occupied_bounds`` / ``sum_bound``
    / ``empty_identity`` / ``fingerprint`` / ``facade_desync``), and a
    human-readable detail."""

    stream: int
    invariant: str
    detail: str


@dataclasses.dataclass
class IntegrityReport:
    """Accounting for one integrity verification.

    ``violations`` lists up to ``_MAX_DETAILED`` detailed findings;
    ``n_violations`` counts every one (truncation never hides the
    total).  An empty report (falsy) means the state verified clean;
    in ``"raise"`` mode a non-empty report rides on the raised
    ``IntegrityError`` as ``.report``.
    """

    seam: str
    n_streams: int
    violations: List[IntegrityViolation] = dataclasses.field(
        default_factory=list
    )
    n_violations: int = 0

    def add(self, stream: int, invariant: str, detail: str) -> None:
        self.n_violations += 1
        if len(self.violations) < _MAX_DETAILED:
            self.violations.append(
                IntegrityViolation(int(stream), invariant, str(detail)[:300])
            )

    @property
    def counters(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.invariant] = out.get(v.invariant, 0) + 1
        return out

    @property
    def indices(self) -> List[int]:
        return sorted({v.stream for v in self.violations})

    def __bool__(self) -> bool:  # truthy iff anything was caught
        return self.n_violations > 0


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------


def arm(mode: str = "raise") -> None:
    """Arm the integrity layer.

    ``mode="raise"`` makes the guarded seams raise ``IntegrityError`` on
    a violation; ``mode="quarantine"`` records an ``IntegrityReport``
    (ring-bounded, ledger counters bumped) and keeps going.  Raises
    ``SketchValueError`` on an unknown mode.
    """
    global _ACTIVE, _MODE
    if mode not in ("raise", "quarantine"):
        raise SketchValueError(
            f"Unknown integrity mode {mode!r}; expected 'raise' or"
            " 'quarantine'"
        )
    _MODE = mode
    _ACTIVE = True


def disarm() -> None:
    """Disarm the layer (guarded seams go back to one bool test each;
    recorded reports are kept, never lost)."""
    global _ACTIVE
    _ACTIVE = False


def enabled() -> bool:
    """Whether the layer is armed (env switch or :func:`arm`); False --
    the default -- means no seam checks anything."""
    return _ACTIVE


def mode() -> str:
    """The armed violation behavior: ``"raise"`` or ``"quarantine"``."""
    return _MODE


def reports() -> List[IntegrityReport]:
    """Reports that carried violations, oldest first (bounded ring;
    empty list is the healthy steady state)."""
    with _lock:
        return list(_reports)


def reset() -> None:
    """Clear the recorded reports (test isolation hook).  Never raises;
    the arming state is kept (use :func:`disarm`)."""
    global _reports_dropped
    with _lock:
        _reports.clear()
        _reports_dropped = 0


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_SALT_POS = np.uint64(0x736B706F73)  # "skpos"
_SALT_NEG = np.uint64(0x736B6E6567)  # "skneg"
_SALT_ZERO = np.uint64(0x736B7A65726F)  # "skzero"
_SALT_LEVEL = np.uint64(0x736B6C766C)  # "sklvl" (adaptive collapse level)
_SALT_MOM_P = np.uint64(0x736B6D6F6D)  # "skmom" (moment power sums)
_SALT_MOM_L = np.uint64(0x736B6D6C67)  # "skmlg" (moment log-power sums)
_SALT_MOM_C = np.uint64(0x736B6D6374)  # "skmct" (moment counters)

#: Fingerprint comparison tolerance: additivity holds exactly in real
#: arithmetic; the f32 bin adds of a merge/fold and the f64 dot-product
#: order introduce rounding, so equality is judged within this.
_FP_RTOL = 1e-5
_FP_ATOL = 1e-3


def _host(x):
    """A tensor (or a tuple of them) fetched to host numpy, dtype kept --
    the same arrays the JAX package's checks fetch."""
    if isinstance(x, tuple):
        return tuple(_host(a) for a in x)
    return x.detach().cpu().numpy()


def _coeff(keys: np.ndarray, salt: np.uint64) -> np.ndarray:
    """Deterministic pseudo-random coefficient in [1, 2) per key
    (splitmix64 finalizer); vectorized, no RNG state, replay-exact."""
    with np.errstate(over="ignore"):  # uint64 wrap is the mix, not a bug
        x = (np.asarray(keys, np.int64).view(np.uint64) * _GOLDEN) ^ salt
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        x = x ^ (x >> np.uint64(31))
    return 1.0 + (x >> np.uint64(11)).astype(np.float64) * 2.0**-53


def fingerprint(spec, state) -> np.ndarray:
    """Content checksum per stream -> f64 ``[n_streams]`` (or
    ``[K, n_streams]`` for a stacked partials pytree).

    Each store bin's mass is weighted by a deterministic coefficient
    keyed on its **absolute** key (``key_offset + index``), plus a
    zero-bucket term -- so the fingerprint is invariant under window
    recentering (keys are preserved; collapse changes it, by design:
    collapse changes content) and additive under merge/fold.  Two states
    with the same logical content fingerprint equal (within
    ``_FP_RTOL`` float rounding); a bit-flipped bin does not.  Never
    raises on any well-shaped state; costs one host fetch of the bins.
    """

    if hasattr(state, "powers"):  # MomentState (backends.moment)
        return _fingerprint_moment(state)
    if hasattr(state, "base") and hasattr(state, "level"):
        # AdaptiveState (backends.uniform): the dense lane plus a level
        # term, so two states whose bins coincide at different levels
        # (different content!) fingerprint apart.  The level term is
        # NOT merge-additive -- adaptive merge seams fingerprint the
        # level-ALIGNED bases instead (backends.uniform.merge).
        base_fp = fingerprint(spec, state.base)
        lvl = np.asarray(_host(state.level), np.int64)
        return base_fp + lvl * _coeff(lvl, _SALT_LEVEL)
    bins_pos, bins_neg, zero, koff = (
        np.asarray(a)
        for a in _host(
            (state.bins_pos, state.bins_neg, state.zero_count,
             state.key_offset)
        )
    )
    return _fingerprint_arrays(bins_pos, bins_neg, zero, koff)


def _window_coeffs(koff: np.ndarray, n_bins: int, salt: np.uint64) -> np.ndarray:
    """:func:`_coeff` of each stream's keys ``koff + [0, n_bins)`` ->
    ``koff.shape + (n_bins,)``.  Where the windows overlap (their span is
    shorter than all their keys together), one coefficient a distinct key
    is mixed and each stream's row is read from that table: the same
    values as mixing every key, at a fraction of the host time."""
    off = koff.astype(np.int64)
    span = int(off.max()) - int(off.min()) + n_bins if off.size else 0
    if not off.size or span >= off.size * n_bins:
        return _coeff(off[..., None] + np.arange(n_bins, dtype=np.int64), salt)
    lo = int(off.min())
    table = _coeff(np.arange(lo, lo + span, dtype=np.int64), salt)
    return np.lib.stride_tricks.sliding_window_view(table, n_bins)[off - lo]


def _fingerprint_arrays(bins_pos, bins_neg, zero, koff) -> np.ndarray:
    n_bins = bins_pos.shape[-1]
    # f32 and int32 masses widen to f64 exactly inside the multiply: the
    # products, and so the sums, are the JAX package's to the bit.
    fp = np.multiply(bins_pos, _window_coeffs(koff, n_bins, _SALT_POS), dtype=np.float64).sum(-1)
    fp += np.multiply(bins_neg, _window_coeffs(koff, n_bins, _SALT_NEG), dtype=np.float64).sum(-1)
    fp += zero.astype(np.float64) * _coeff(np.zeros((), np.int64), _SALT_ZERO)
    return fp


def _fingerprint_moment(mstate) -> np.ndarray:
    """Merge-additive content checksum of a moment state -> f64 [N].

    Coefficients key on the moment ORDER (the moment analog of the
    absolute-bin-key scheme); every term is a sum, so the fingerprint
    is additive under merge/psum exactly like the dense lane.  ``sum``
    and min/max are excluded: a NaN-poisoned sum (live-NaN ingest,
    documented) would make every comparison fail, and extrema are not
    additive.  Saturated (inf) power sums propagate inf -- such states
    compare unequal to everything, which degrades to cache misses, not
    wrong answers.  Never raises on a well-shaped state.
    """

    count, zero, neg, powers, log_powers = (
        np.asarray(a, np.float64)
        for a in _host(
            (mstate.count, mstate.zero_count, mstate.neg_count,
             mstate.powers, mstate.log_powers)
        )
    )
    orders = np.arange(1, powers.shape[-1] + 1, dtype=np.int64)
    fp = (powers * _coeff(orders, _SALT_MOM_P)).sum(-1)
    fp += (log_powers * _coeff(orders, _SALT_MOM_L)).sum(-1)
    fp += count * _coeff(np.asarray(1, np.int64), _SALT_MOM_C)
    fp += zero * _coeff(np.asarray(2, np.int64), _SALT_MOM_C)
    fp += neg * _coeff(np.asarray(3, np.int64), _SALT_MOM_C)
    return fp


def verify_moment_merge(
    spec, merged, fp_pre, seam: str = "moment.merge"
) -> "IntegrityReport":
    """The moment backend's merge conservation lane: the merged state's
    (additive) fingerprint must equal the operands' sum; also runs the
    moment invariants.  Violations raise ``IntegrityError``/quarantine
    per the armed mode."""
    report = check_state(spec, merged, seam=seam)
    fp_post = _fingerprint_moment(merged)
    pre = np.asarray(fp_pre, np.float64)
    ok_shape = pre.shape == fp_post.shape
    if not ok_shape:
        report.add(0, "fingerprint",
                   "pre-merge fingerprint has the wrong shape")
    else:
        finite = np.isfinite(pre) & np.isfinite(fp_post)
        bad = finite & (
            np.abs(fp_post - pre) > _FP_ATOL + _FP_RTOL * np.abs(pre)
        )
        _flag(report, bad, "fingerprint",
              lambda i: f"merged moment fingerprint {fp_post[i]:g} !="
              f" operand sum {pre[i]:g}")
    return _record(report, None)


def fingerprint_host(sketch) -> float:
    """:func:`fingerprint` for a host-tier sketch -> one f64 scalar.

    Same coefficient scheme keyed on absolute store keys, so a host
    sketch and its device lift fingerprint equal (up to f32/f64 mass
    rounding).  Empty sketches fingerprint 0.0; never raises.
    """
    fp = 0.0
    for store, salt in ((sketch.store, _SALT_POS),
                        (sketch.negative_store, _SALT_NEG)):
        bins = np.asarray(store.bins, np.float64)
        if bins.size:
            keys = np.arange(bins.size, dtype=np.int64) + int(store.offset)
            fp += float((bins * _coeff(keys, salt)).sum())
    fp += float(sketch.zero_count) * float(
        _coeff(np.zeros((), np.int64), _SALT_ZERO)
    )
    return fp


# ---------------------------------------------------------------------------
# Invariant checker
# ---------------------------------------------------------------------------


def _tols(spec) -> Tuple[float, float]:
    if spec is not None and getattr(spec, "bins_integer", False):
        return (0.0, 0.5)  # exact accumulation: half-unit slack only
    return (_RTOL, _ATOL)


def _flag(report, mask, invariant, detail_fn) -> None:
    for i in np.nonzero(mask)[0]:
        report.add(int(i), invariant, detail_fn(int(i)))


def check_state(spec, state, seam: str = "state") -> IntegrityReport:
    """Run every invariant against a batched device state (pure check:
    no raise, no recording -- :func:`verify_state` wraps this with the
    armed policy).

    Accepts a ``[n_streams, n_bins]`` state or a stacked
    ``[K, n_streams, n_bins]`` partials pytree (each partial is itself a
    sketch, so the slices check independently).  Violations land in the
    returned report with per-stream indices (stacked states index as
    ``k * n_streams + n``); an empty report means the state is
    self-consistent down to the documented rounding floor.
    """

    if hasattr(state, "powers"):  # MomentState (backends.moment)
        return _check_moment(state, seam=seam)
    if hasattr(state, "base") and hasattr(state, "level"):
        # AdaptiveState: the base IS a dense state; the level array
        # adds two invariants of its own.
        report = check_state(spec, state.base, seam=seam)
        lvl = np.asarray(_host(state.level))
        _flag(report, lvl < 0, "level_nonnegative",
              lambda i: f"collapse level {lvl[i]} < 0")
        cap = getattr(spec, "max_collapses", None)
        if cap is not None:
            _flag(report, lvl > cap, "level_cap",
                  lambda i: f"collapse level {lvl[i]} > max_collapses"
                  f" {cap}")
        return report
    fields = (
        state.bins_pos, state.bins_neg, state.zero_count, state.count,
        state.sum, state.min, state.max, state.collapsed_low,
        state.collapsed_high, state.key_offset, state.pos_lo, state.pos_hi,
        state.neg_lo, state.neg_hi, state.neg_total, state.tile_sums,
    )
    (bins_pos, bins_neg, zero, count, total, vmin, vmax, clow, chigh,
     koff, pos_lo, pos_hi, neg_lo, neg_hi, neg_total, tile_sums) = (
        np.asarray(a) for a in _host(fields)
    )
    if bins_pos.ndim == 3:  # stacked partials: flatten the shard axis
        k, n, b = bins_pos.shape
        reshape2 = lambda a: a.reshape(k * n, -1)
        reshape1 = lambda a: a.reshape(k * n)
        bins_pos, bins_neg, tile_sums = (
            reshape2(bins_pos), reshape2(bins_neg), reshape2(tile_sums)
        )
        (zero, count, total, vmin, vmax, clow, chigh, koff,
         pos_lo, pos_hi, neg_lo, neg_hi, neg_total) = (
            reshape1(a)
            for a in (zero, count, total, vmin, vmax, clow, chigh, koff,
                      pos_lo, pos_hi, neg_lo, neg_hi, neg_total)
        )
    return _check_state_arrays(
        spec, seam, bins_pos, bins_neg, zero, count, total, vmin, vmax,
        clow, chigh, koff, pos_lo, pos_hi, neg_lo, neg_hi, neg_total,
        tile_sums,
    )


def _check_state_arrays(
    spec, seam, bins_pos, bins_neg, zero, count, total, vmin, vmax,
    clow, chigh, koff, pos_lo, pos_hi, neg_lo, neg_hi, neg_total,
    tile_sums,
) -> IntegrityReport:
    from sketches_tpu_torch.batched import occupied_bounds_np, tile_sums_np

    n, n_bins = bins_pos.shape
    report = IntegrityReport(seam=seam, n_streams=n)
    rtol, atol = _tols(spec)

    bp64 = bins_pos.astype(np.float64)
    bn64 = bins_neg.astype(np.float64)
    z64 = zero.astype(np.float64)
    c64 = count.astype(np.float64)
    nt64 = neg_total.astype(np.float64)

    # 1. Non-finite masses/counters: corruption can forge NaN/inf, and
    # NaN would silently pass every magnitude comparison below.
    bad_bins = ~np.isfinite(bp64).all(-1) | ~np.isfinite(bn64).all(-1)
    nonfin = (
        bad_bins
        | ~np.isfinite(z64) | ~np.isfinite(c64) | ~np.isfinite(nt64)
        | ~np.isfinite(clow.astype(np.float64))
        | ~np.isfinite(chigh.astype(np.float64))
        | np.isnan(vmin.astype(np.float64))
        | np.isnan(vmax.astype(np.float64))
        | ~np.isfinite(tile_sums.astype(np.float64)).all(-1)
    )
    _flag(report, nonfin, "nonfinite",
          lambda i: "non-finite mass/counter (NaN or inf)")

    # 2. Negative masses: every mass accumulator is a sum of positive
    # weights; a negative bin or counter can only be corruption.
    negmass = (
        (bp64 < 0).any(-1) | (bn64 < 0).any(-1)
        | (z64 < 0) | (c64 < 0) | (nt64 < 0)
        | (clow.astype(np.float64) < 0) | (chigh.astype(np.float64) < 0)
        | (tile_sums.astype(np.float64) < 0).any(-1)
    )
    _flag(report, negmass & ~nonfin, "negative_mass",
          lambda i: "negative bin mass or counter")

    ok = ~(nonfin | negmass)  # masks below only fire on otherwise-sane rows

    # 3. Total-mass conservation across both stores + the zero bucket.
    pos_mass = bp64.sum(-1)
    neg_mass = bn64.sum(-1)
    expect = z64 + pos_mass + neg_mass
    tol = atol + rtol * np.maximum(c64, expect)
    bad = ok & (np.abs(c64 - expect) > tol)
    _flag(report, bad, "mass_conservation",
          lambda i: f"count={c64[i]:g} != zero+sum(bins)={expect[i]:g}")

    # 4. neg_total is the one shared definition of the negative-store
    # mass (engines plan rank thresholds off it).
    bad = ok & (np.abs(nt64 - neg_mass) > atol + rtol * np.maximum(nt64, neg_mass))
    _flag(report, bad, "neg_total",
          lambda i: f"neg_total={nt64[i]:g} != sum(bins_neg)={neg_mass[i]:g}")

    # 5. Tile summaries agree with the bins (up to the documented
    # float-mode ULP drift, covered by the same tolerance).
    ts = tile_sums_np(bp64, bn64)
    bad = ok & (
        np.abs(tile_sums.astype(np.float64) - ts).max(-1)
        > atol + rtol * np.maximum(c64, 1.0)
    )
    _flag(report, bad, "tile_sums",
          lambda i: "tile_sums disagree with the bins")

    # 6. Occupied bounds are conservative supersets of true occupancy
    # and stay inside the sentinel ranges.
    for name, bins64, lo, hi in (
        ("pos", bp64, pos_lo, pos_hi), ("neg", bn64, neg_lo, neg_hi)
    ):
        tlo, thi = occupied_bounds_np(bins64)
        occupied = thi >= 0
        bad = ok & (
            (lo < 0) | (lo > n_bins) | (hi < -1) | (hi > n_bins - 1)
            | (occupied & ((tlo < lo) | (thi > hi)))
        )
        _flag(report, bad, "occupied_bounds",
              lambda i, name=name: f"{name} store occupancy outside"
              " the tracked [lo, hi] span")

    # 7. Sum magnitude bound: |sum| <= count * max(|min|, |max|).  Holds
    # for any weighted stream; an inf/garbage sum with finite extrema
    # violates it.  (A NaN sum with count > 0 is accepted: NaN input
    # values legitimately poison sum while leaving min/max untouched --
    # the documented limit.)
    t64 = total.astype(np.float64)
    maxabs = np.maximum(np.abs(vmin.astype(np.float64)),
                        np.abs(vmax.astype(np.float64)))
    with np.errstate(invalid="ignore", over="ignore"):
        bound = c64 * maxabs
        bad = ok & np.isfinite(bound) & (
            np.abs(t64) > bound * (1 + rtol) + atol
        )
    _flag(report, bad, "sum_bound",
          lambda i: f"|sum|={abs(t64[i]):g} exceeds count*max|value|"
          f"={bound[i]:g}")

    # 8. Empty-stream identity: zero mass everywhere, sum 0, +-inf
    # extrema -- what init() and every fold identity guarantee.
    empty = ok & (c64 == 0)
    bad = empty & (
        (pos_mass != 0) | (neg_mass != 0) | (z64 != 0)
        | (t64 != 0) | (vmin.astype(np.float64) != np.inf)
        | (vmax.astype(np.float64) != -np.inf)
    )
    _flag(report, bad, "empty_identity",
          lambda i: "count == 0 but mass/sum/extrema are not identities")
    return report


def _check_moment(mstate, seam: str = "moment") -> IntegrityReport:
    """Invariant check for a moment-summary state (pure; no raise).

    Invariants: non-negative counters, ``zero + neg <= count`` (f32
    rounding slack), finite extrema with ``min <= max`` wherever a
    stream holds nonzero mass, and the +/-inf empty-stream sentinels.
    Violations land in the returned report; poisoned sums (live-NaN
    ingest) and saturated power sums are DOCUMENTED states, not
    violations.
    """

    count, zero, neg, vmin, vmax = (
        np.asarray(a, np.float64)
        for a in _host(
            (mstate.count, mstate.zero_count, mstate.neg_count,
             mstate.min, mstate.max)
        )
    )
    n = count.shape[-1]
    if count.ndim == 2:  # stacked partials: flatten the shard axis
        k2 = count.shape[0]
        count, zero, neg, vmin, vmax = (
            a.reshape(k2 * n) for a in (count, zero, neg, vmin, vmax)
        )
        n = count.shape[0]
    report = IntegrityReport(seam=seam, n_streams=n)
    for name, arr in (("count", count), ("zero_count", zero),
                      ("neg_count", neg)):
        _flag(report, arr < -_ATOL, f"{name}_nonnegative",
              lambda i, a=arr, nm=name: f"{nm} {a[i]:g} < 0")
    _flag(report, zero + neg > count * (1 + _RTOL) + _ATOL,
          "mass_partition",
          lambda i: f"zero {zero[i]:g} + neg {neg[i]:g} > count"
          f" {count[i]:g}")
    nonzero = count - zero > _ATOL
    bad_extrema = nonzero & ~(
        np.isfinite(vmin) & np.isfinite(vmax) & (vmin <= vmax)
    )
    _flag(report, bad_extrema, "extrema",
          lambda i: f"min {vmin[i]:g} / max {vmax[i]:g} invalid for a"
          " stream with nonzero mass")
    return report


def check_host(sketch, seam: str = "host") -> IntegrityReport:
    """Invariant check for a host-tier ``BaseDDSketch``/``DDSketch``
    (pure check: no raise, no recording).

    Verifies per-store mass agreement (``store.count == sum(bins)``),
    non-negative bins, total-mass conservation, and the sum magnitude
    bound, within host (f64) rounding.  An empty report means clean.
    """
    report = IntegrityReport(seam=seam, n_streams=1)
    count = float(sketch.count)
    zero = float(sketch.zero_count)
    if not math.isfinite(count) or not math.isfinite(zero):
        report.add(0, "nonfinite", "non-finite count/zero_count")
        return report
    if count < 0 or zero < 0:
        report.add(0, "negative_mass", "negative count/zero_count")
    masses = []
    for name, store in (("pos", sketch.store),
                        ("neg", sketch.negative_store)):
        bins = np.asarray(store.bins, np.float64)
        if bins.size and not np.isfinite(bins).all():
            report.add(0, "nonfinite", f"{name} store holds non-finite bins")
            return report
        if bins.size and (bins < 0).any():
            report.add(0, "negative_mass", f"{name} store holds a negative bin")
        mass = float(bins.sum())
        masses.append(mass)
        sc = float(store.count)
        if abs(sc - mass) > _HOST_ATOL + _HOST_RTOL * max(abs(sc), mass):
            report.add(
                0, "mass_conservation",
                f"{name} store.count={sc:g} != sum(bins)={mass:g}",
            )
    expect = zero + masses[0] + masses[1]
    if abs(count - expect) > _HOST_ATOL + _HOST_RTOL * max(count, expect):
        report.add(
            0, "mass_conservation",
            f"count={count:g} != zero+store masses={expect:g}",
        )
    total = float(sketch.sum)
    maxabs = max(abs(float(sketch._min)), abs(float(sketch._max)))
    bound = count * maxabs
    if (
        not math.isnan(total)
        and math.isfinite(bound)
        and abs(total) > bound * (1 + _HOST_RTOL) + _HOST_ATOL
    ):
        report.add(
            0, "sum_bound",
            f"|sum|={abs(total):g} exceeds count*max|value|={bound:g}",
        )
    if count == 0 and (total != 0 or masses[0] or masses[1] or zero):
        report.add(0, "empty_identity",
                   "count == 0 but mass/sum are not identities")
    return report


def check(obj, seam: str = "check") -> IntegrityReport:
    """Invariant-check any sketch object (pure check, no raise).

    Dispatches on type: host ``BaseDDSketch``/presets ->
    :func:`check_host`; ``TorchDDSketch`` -> settle, then the device state
    checker plus a facade/device ``count`` cross-check
    (``facade_desync``); ``BatchedDDSketch`` -> its state;
    ``DistributedDDSketch`` -> its stacked partials (each partial is
    itself a sketch).  A bare ``SketchState`` needs its spec -- use
    :func:`check_state`.  Raises ``SketchValueError`` for an object it
    cannot dispatch.
    """
    from sketches_tpu_torch.batched import BatchedDDSketch
    from sketches_tpu_torch.ddsketch import BaseDDSketch, TorchDDSketch
    from sketches_tpu_torch.parallel import DistributedDDSketch

    if isinstance(obj, TorchDDSketch):
        obj._settle()
        report = check_state(obj._spec, obj._state, seam=seam)
        dev_count = float(_host(obj._state.count)[0])
        host_count = obj._count
        if abs(dev_count - host_count) > _ATOL + _RTOL * max(
            abs(dev_count), abs(host_count)
        ):
            report.add(
                0, "facade_desync",
                f"facade count={host_count:g} != device count={dev_count:g}",
            )
        return report
    if isinstance(obj, BaseDDSketch):
        return check_host(obj, seam=seam)
    if isinstance(obj, BatchedDDSketch):
        return check_state(obj.spec, obj.state, seam=seam)
    if isinstance(obj, DistributedDDSketch):
        return check_state(obj.spec, obj.partials, seam=seam)
    raise SketchValueError(
        f"integrity.check cannot dispatch {type(obj).__name__}; pass a"
        " sketch facade, or use check_state(spec, state)"
    )


# ---------------------------------------------------------------------------
# Armed policy: record + raise/quarantine
# ---------------------------------------------------------------------------


def _record(report: IntegrityReport, errors: Optional[str]) -> IntegrityReport:
    """Apply the armed policy to a finished check: count it, and on
    violations feed the ledger/telemetry and raise or quarantine."""
    global _reports_dropped
    if telemetry._ACTIVE:
        telemetry.counter_inc("integrity.checks")
    if not report:
        return report
    bump("integrity.violations", report.n_violations)
    for kind, k in report.counters.items():
        bump(f"integrity.violations.{kind}", k)
    if telemetry._ACTIVE:
        telemetry.counter_inc(
            "integrity.violations", float(report.n_violations)
        )
    # Flight-recorder feed: an integrity violation is forensic evidence
    # by definition (lazy import: tracing loads this module's reports).
    from sketches_tpu_torch import tracing

    if tracing._ACTIVE:
        tracing.record_event(
            "integrity.violation", seam=report.seam,
            n_violations=report.n_violations,
            first=str(report.violations[0].invariant) if report.violations
            else None,
        )
    with _lock:
        if len(_reports) < _MAX_REPORTS:
            _reports.append(report)
        else:
            _reports_dropped += 1
    err = _MODE if errors is None else errors
    if err == "raise":
        first = report.violations[0]
        raise IntegrityError(
            f"integrity violation at seam {report.seam!r}:"
            f" {report.n_violations} violation(s), first: stream"
            f" {first.stream} {first.invariant} ({first.detail})",
            report=report,
        )
    return report


def verify_state(
    spec, state, *, seam: str = "user", errors: Optional[str] = None
) -> IntegrityReport:
    """Check a device state and apply the armed policy.

    Raises :class:`IntegrityError` on violations in ``"raise"`` mode
    (the default armed mode); in ``"quarantine"`` mode the report is
    recorded (ring + ledger counters + telemetry) and returned.  A clean
    state returns a falsy report either way.
    """
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    report = check_state(spec, state, seam=seam)
    if _t0 is not None:
        telemetry.finish_span("integrity.check_s", _t0, seam=seam)
    return _record(report, errors)


def verify(
    obj, *, seam: str = "user", errors: Optional[str] = None
) -> IntegrityReport:
    """Check any sketch object (:func:`check` dispatch) and apply the
    armed policy -- raises :class:`IntegrityError` on violations in
    ``"raise"`` mode, records and returns the report in
    ``"quarantine"`` mode."""
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    report = check(obj, seam=seam)
    if _t0 is not None:
        telemetry.finish_span("integrity.check_s", _t0, seam=seam)
    return _record(report, errors)


# ---------------------------------------------------------------------------
# Seam helpers: merge conservation + the fold checksum lane
# ---------------------------------------------------------------------------


def premerge(spec, a_state, b_state) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Snapshot the merge operands for :func:`postmerge`: combined
    fingerprints, combined collapse counters, combined counts.  Also
    catches a corrupted *operand* before it is averaged in (both sides
    are checked).  Never raises on a clean pair; armed-mode policy
    applies via the embedded :func:`verify_state` calls."""

    verify_state(spec, b_state, seam="merge.operand")
    fp = fingerprint(spec, a_state) + fingerprint(spec, b_state)
    coll = sum(
        np.asarray(x, np.float64)
        for x in _host(
            (a_state.collapsed_low, a_state.collapsed_high,
             b_state.collapsed_low, b_state.collapsed_high)
        )
    )
    count = np.asarray(
        _host(a_state.count), np.float64
    ) + np.asarray(_host(b_state.count), np.float64)
    return fp, coll, count


def postmerge(spec, merged_state, pre, seam: str = "merge") -> IntegrityReport:
    """Verify a merge result against its :func:`premerge` snapshot.

    The fingerprint lane (additive under aligned merge) applies to
    streams whose collapse counters did not move; streams that collapsed
    mass during window alignment legitimately changed content, so they
    fall back to total-count conservation.  Violations raise
    ``IntegrityError``/quarantine per the armed mode.
    """

    fp_pre, coll_pre, count_pre = pre
    report = check_state(spec, merged_state, seam=seam)
    fp_post = fingerprint(spec, merged_state)
    coll_post = sum(
        np.asarray(x, np.float64)
        for x in _host(
            (merged_state.collapsed_low, merged_state.collapsed_high)
        )
    )
    count_post = np.asarray(
        _host(merged_state.count), np.float64
    )
    no_collapse = coll_post <= coll_pre + _ATOL
    fp_bad = no_collapse & (
        np.abs(fp_post - fp_pre) > _FP_ATOL + _FP_RTOL * np.abs(fp_pre)
    )
    _flag(report, fp_bad, "fingerprint",
          lambda i: f"merged fingerprint {fp_post[i]:g} != operand sum"
          f" {fp_pre[i]:g}")
    cnt_bad = ~no_collapse & (
        np.abs(count_post - count_pre)
        > _ATOL + _RTOL * np.maximum(count_post, count_pre)
    )
    _flag(report, cnt_bad, "mass_conservation",
          lambda i: f"merged count {count_post[i]:g} != operand sum"
          f" {count_pre[i]:g}")
    return _record(report, None)


def verify_fold(
    spec, partials, folded, live=None, seam: str = "fold"
) -> IntegrityReport:
    """The psum fold's parallel checksum lane.

    Fingerprints every (live) partial shard, sums them -- merge is
    elementwise on equal windows, so the fingerprint is additive -- and
    compares against the folded state's fingerprint; also invariant-
    checks the folded result.  A shard corrupted in flight fails here,
    at the fold, instead of being averaged into the answer.  Violations
    raise ``IntegrityError``/quarantine per the armed mode.
    """
    report = check_state(spec, folded, seam=seam)
    fp_shards = fingerprint(spec, partials)  # [K, N]
    if live is not None:
        lv = np.asarray(live, bool).reshape(-1)
        fp_shards = fp_shards * lv[:, None]
    fp_sum = fp_shards.sum(0)
    fp_fold = fingerprint(spec, folded)
    bad = np.abs(fp_fold - fp_sum) > _FP_ATOL + _FP_RTOL * np.abs(fp_sum)
    _flag(report, bad, "fingerprint",
          lambda i: f"folded fingerprint {fp_fold[i]:g} != shard-lane sum"
          f" {fp_sum[i]:g}")
    return _record(report, None)


def verify_reshard(
    spec, pre_fp, post_state, seam: str = "reshard"
) -> IntegrityReport:
    """The elastic-reshard boundary's fingerprint lane.

    ``pre_fp`` is the surviving mass's fingerprint (the live partials'
    shard-lane sum, or the folded survivors' fingerprint -- additive, so
    the two are equal); the regrown fleet's folded state must carry the
    SAME per-stream fingerprint, because a reshard moves mass across
    topologies without changing content (fingerprints are keyed on
    absolute bin keys -- topology- and recenter-free by construction).
    Also invariant-checks the regrown state.  Violations raise
    ``IntegrityError``/quarantine per the armed mode.
    """
    report = check_state(spec, post_state, seam=seam)
    fp_post = fingerprint(spec, post_state)
    pre = np.asarray(pre_fp, np.float64)
    if pre.shape != fp_post.shape:
        report.add(0, "fingerprint",
                   "pre-reshard fingerprint has the wrong shape")
    else:
        bad = np.abs(fp_post - pre) > _FP_ATOL + _FP_RTOL * np.abs(pre)
        _flag(report, bad, "fingerprint",
              lambda i: f"resharded fingerprint {fp_post[i]:g} != surviving"
              f" mass {pre[i]:g}")
    return _record(report, None)


def verify_restore(
    spec, state, stored_fp=None, seam: str = "checkpoint.restore"
) -> IntegrityReport:
    """Verify a restored state: full invariant check plus, when the
    checkpoint carried a content fingerprint (armed save), the
    save->restore fingerprint comparison.  Violations raise
    ``IntegrityError``/quarantine per the armed mode."""
    _t0 = telemetry.clock() if telemetry._ACTIVE else None
    report = check_state(spec, state, seam=seam)
    if stored_fp is not None:
        fp_now = fingerprint(spec, state)
        sf = np.asarray(stored_fp, np.float64)
        if sf.shape != fp_now.shape:
            report.add(0, "fingerprint",
                       "stored fingerprint has the wrong shape")
        else:
            # Saturated (inf) moment fingerprints subtract to NaN; the
            # comparison is only meaningful where both sides are finite
            # (documented degraded comparison for inf-poisoned sums).
            with np.errstate(invalid="ignore"):
                bad = (
                    np.isfinite(fp_now) & np.isfinite(sf)
                    & (np.abs(fp_now - sf) > _FP_ATOL + _FP_RTOL * np.abs(sf))
                )
            _flag(report, bad, "fingerprint",
                  lambda i: f"restored fingerprint {fp_now[i]:g} != saved"
                  f" {sf[i]:g}")
    if _t0 is not None:
        telemetry.finish_span("integrity.check_s", _t0, seam=seam)
    return _record(report, None)


# ---------------------------------------------------------------------------
# Repair
# ---------------------------------------------------------------------------


def repair(spec, state) -> Tuple[Any, IntegrityReport]:
    """Rewrite what is provably repairable -> ``(state, repairs)``.

    The bins are the ground truth; everything derivable from them is
    recomputed: negative/non-finite bin masses clip to zero
    (resolution already lost -- same contract as collapse), ``count``
    recounts as ``zero_count + sum(bins)`` when desynced, ``neg_total``
    / ``tile_sums`` / occupied bounds recompute exactly, and empty
    streams get their identities (``sum=0``, ``min=+inf``,
    ``max=-inf``) back.  ``min``/``max``/``sum`` corruption on occupied
    streams is NOT repairable (the exact values are gone); a sum beyond
    its magnitude bound clamps to it so downstream ``avg`` stays sane.
    The returned report lists each field rewritten (empty = nothing to
    repair); the repaired state always passes :func:`check_state`.
    The repaired state is a new state on the input's device.
    """

    from sketches_tpu_torch.batched import (
        SketchState,
        occupied_bounds_np,
        tile_sums_np,
    )

    fields = {
        f.name: np.array(_host(getattr(state, f.name)))  # writable copies
        for f in dataclasses.fields(SketchState)
    }
    squeeze = fields["bins_pos"].ndim == 3
    if squeeze:
        raise SketchValueError(
            "repair() takes a folded [n_streams, n_bins] state; fold"
            " stacked partials first (fold_live_partials)"
        )
    n = fields["bins_pos"].shape[0]
    report = IntegrityReport(seam="repair", n_streams=n)
    rtol, atol = _tols(spec)

    bp = fields["bins_pos"].astype(np.float64)
    bn = fields["bins_neg"].astype(np.float64)
    zero = fields["zero_count"].astype(np.float64)
    for name, arr in (("bins_pos", bp), ("bins_neg", bn)):
        bad = ~np.isfinite(arr) | (arr < 0)
        if bad.any():
            rows = np.unique(np.nonzero(bad)[0])
            arr[bad] = 0.0
            for i in rows:
                report.add(int(i), name, "clipped negative/non-finite bins")
    badz = ~np.isfinite(zero) | (zero < 0)
    if badz.any():
        zero[badz] = 0.0
        _flag(report, badz, "zero_count", lambda i: "clipped to 0")

    pos_mass = bp.sum(-1)
    neg_mass = bn.sum(-1)
    count = fields["count"].astype(np.float64)
    expect = zero + pos_mass + neg_mass
    badc = ~np.isfinite(count) | (
        np.abs(count - expect) > atol + rtol * np.maximum(np.abs(count), expect)
    )
    if badc.any():
        count = np.where(badc, expect, count)
        _flag(report, badc, "count", lambda i: "recounted from the bins")

    neg_total = fields["neg_total"].astype(np.float64)
    badn = ~np.isfinite(neg_total) | (
        np.abs(neg_total - neg_mass)
        > atol + rtol * np.maximum(np.abs(neg_total), neg_mass)
    )
    if badn.any():
        neg_total = np.where(badn, neg_mass, neg_total)
        _flag(report, badn, "neg_total", lambda i: "recomputed from bins_neg")

    ts = tile_sums_np(bp, bn)
    old_ts = fields["tile_sums"].astype(np.float64)
    badt = (
        ~np.isfinite(old_ts).all(-1)
        | (np.abs(old_ts - ts).max(-1) > atol + rtol * np.maximum(count, 1.0))
    )
    if badt.any():
        _flag(report, badt, "tile_sums", lambda i: "recomputed from the bins")
    tile_sums = np.where(badt[:, None], ts, old_ts)

    plo, phi = occupied_bounds_np(bp)
    nlo, nhi = occupied_bounds_np(bn)
    n_bins = bp.shape[-1]
    for name, lo, hi, tlo, thi in (
        ("pos", fields["pos_lo"], fields["pos_hi"], plo, phi),
        ("neg", fields["neg_lo"], fields["neg_hi"], nlo, nhi),
    ):
        occupied = thi >= 0
        bad = (
            (lo < 0) | (lo > n_bins) | (hi < -1) | (hi > n_bins - 1)
            | (occupied & ((tlo < lo) | (thi > hi)))
        )
        if bad.any():
            lo[:] = np.where(bad, tlo, lo)
            hi[:] = np.where(bad, thi, hi)
            _flag(report, bad, f"{name}_bounds",
                  lambda i, name=name: f"{name} occupied span re-derived")

    total = fields["sum"].astype(np.float64)
    vmin = fields["min"].astype(np.float64)
    vmax = fields["max"].astype(np.float64)
    clow = fields["collapsed_low"].astype(np.float64)
    chigh = fields["collapsed_high"].astype(np.float64)
    for name, arr in (("collapsed_low", clow), ("collapsed_high", chigh)):
        bad = ~np.isfinite(arr) | (arr < 0)
        if bad.any():
            arr[bad] = 0.0
            _flag(report, bad, name, lambda i, name=name: "clipped to 0")
    empty = count == 0
    bad = empty & ((total != 0) | (vmin != np.inf) | (vmax != -np.inf))
    if bad.any():
        total = np.where(bad, 0.0, total)
        vmin = np.where(empty & (vmin != np.inf), np.inf, vmin)
        vmax = np.where(empty & (vmax != -np.inf), -np.inf, vmax)
        _flag(report, bad, "empty_identity", lambda i: "identities restored")
    maxabs = np.maximum(np.abs(vmin), np.abs(vmax))
    with np.errstate(invalid="ignore", over="ignore"):
        bound = count * maxabs
        bads = ~empty & np.isfinite(bound) & ~np.isnan(total) & (
            np.abs(total) > bound * (1 + rtol) + atol
        )
    if bads.any():
        total = np.where(bads, np.sign(total) * bound, total)
        _flag(report, bads, "sum", lambda i: "clamped to count*max|value|")

    if report and telemetry._ACTIVE:
        telemetry.counter_inc("integrity.repairs", float(report.n_violations))

    dev = state.bins_pos.device
    bd = np.dtype(str(spec.bin_dtype).rsplit(".", 1)[-1])
    dt = np.dtype(str(spec.dtype).rsplit(".", 1)[-1])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if np.issubdtype(bd, np.integer):
        castb = lambda a: put(np.rint(a).astype(bd))
    else:
        castb = lambda a: put(a.astype(bd))
    new = SketchState(
        bins_pos=castb(bp),
        bins_neg=castb(bn),
        zero_count=castb(zero),
        count=castb(count),
        sum=put(total.astype(dt)),
        min=put(vmin.astype(dt)),
        max=put(vmax.astype(dt)),
        collapsed_low=castb(clow),
        collapsed_high=castb(chigh),
        key_offset=put(fields["key_offset"].astype(np.int32)),
        pos_lo=put(fields["pos_lo"].astype(np.int32)),
        pos_hi=put(fields["pos_hi"].astype(np.int32)),
        neg_lo=put(fields["neg_lo"].astype(np.int32)),
        neg_hi=put(fields["neg_hi"].astype(np.int32)),
        neg_total=castb(neg_total),
        tile_sums=castb(tile_sums),
    )
    return new, report


# ---------------------------------------------------------------------------
# Environment arming (process-level, for CI chaos-soak jobs)
# ---------------------------------------------------------------------------

_env = registry.get(registry.INTEGRITY)
if _env and _env != "0":  # pragma: no cover - exercised via subprocess in CI
    arm("quarantine" if _env in ("quarantine", "report") else "raise")
