"""Backend-tagged wire envelope: the ``SketchPayload`` message (PyTorch port
of ``sketches_tpu/backends/wirefmt.py``).

The DDSketch protobuf has no slot for a backend kind, a collapse level or a
moment vector, and its first byte is always ``0x0a`` (field 1, the
length-delimited ``mapping``).  A ``SketchPayload`` starts with field 1 as
a varint (``0x08``), so the two formats tell apart from the first byte and
dense blobs stay the classic bytes.  Hand-rolled proto3::

    message SketchPayload {
      enum Backend { DENSE = 0; UNIFORM_COLLAPSE = 1; MOMENT = 2;
                     WINDOWED = 3; }
      Backend backend = 1;          // varint, always emitted
      bytes   dense   = 2;          // classic DDSketch blob (uniform_collapse)
      uint32  level   = 3;          // uniform_collapse: the stream's level
      bytes   moment  = 4;          // MomentPayload submessage
      bytes   windowed = 5;         // a whole windowed ring
    }
    message MomentPayload {
      uint32 k                   = 1;
      repeated double scalars    = 2;  // packed [count, zero_count,
                                       //   neg_count, sum, min, max]
      repeated double powers     = 3;  // packed, k raw power sums
      repeated double log_powers = 4;  // packed, k log power sums
    }

Both packages write the same bytes for the same state and read each
other's blobs.  The windowed envelope (``windowed_to_bytes`` /
``windowed_from_bytes``) comes with the windowed sketch (ROADMAP A10) and
raises ``SpecError`` until then.  Armed telemetry counts each native
scan (``wire.native.decode_calls``) and its careful-path handoffs
(``wire.native.careful_fallbacks``), as in the JAX package.

Failure modes: an unknown backend enum value raises ``WireDecodeError``
naming it; truncated or garbled blobs, wrong wire types, a level outside
``[0, spec.max_collapses]``, a moment payload whose vector lengths disagree
with its ``k`` (or whose ``k`` is not the spec's), and backend/spec
mismatches raise ``WireDecodeError`` naming the blob; encoding a state
type that disagrees with ``spec.backend`` raises ``SpecError``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from sketches_tpu_torch import telemetry
from sketches_tpu_torch.backends import BACKEND_ENUM, BACKEND_NAMES
from sketches_tpu_torch.resilience import SpecError, WireDecodeError

__all__ = [
    "payload_to_bytes",
    "payload_from_bytes",
    "windowed_to_bytes",
    "windowed_from_bytes",
]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(blob: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if i >= len(blob):
            raise WireDecodeError("SketchPayload truncated inside a varint")
        b = blob[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise WireDecodeError("SketchPayload varint overflows 64 bits")


def _field(tag: int, wire_type: int) -> bytes:
    return _varint((tag << 3) | wire_type)


def _ld(tag: int, payload: bytes) -> bytes:
    return _field(tag, 2) + _varint(len(payload)) + payload


def _packed_doubles(vals) -> bytes:
    return np.ascontiguousarray(np.asarray(vals, np.float64)).tobytes()


def _moment_payload(k: int, scalars, powers, log_powers) -> bytes:
    return (
        _field(1, 0)
        + _varint(k)
        + _ld(2, _packed_doubles(scalars))
        + _ld(3, _packed_doubles(powers))
        + _ld(4, _packed_doubles(log_powers))
    )


def payload_to_bytes(spec, state) -> List[bytes]:
    """Every stream of a backend state as one blob.

    ``spec.backend`` picks the layout: ``dense`` is the classic encoder's
    output (no envelope); ``uniform_collapse`` wraps each stream's dense
    blob with its collapse level; ``moment`` emits the moment payload.
    Raises ``SpecError`` when the state type disagrees with the backend.
    """
    from sketches_tpu_torch.pb.wire import state_to_bytes

    backend = spec.backend
    enum = BACKEND_ENUM[backend]
    if backend == "dense":
        if not hasattr(state, "bins_pos"):
            raise SpecError(
                f"dense backend serialization needs a SketchState; got {type(state).__name__}"
            )
        return state_to_bytes(spec, state)
    head = _field(1, 0) + _varint(enum)
    if backend == "uniform_collapse":
        if not hasattr(state, "base") or not hasattr(state, "level"):
            raise SpecError(
                "uniform_collapse serialization needs an AdaptiveState;"
                f" got {type(state).__name__}"
            )
        dense_blobs = state_to_bytes(spec, state.base)
        levels = state.level.cpu().numpy().astype(np.int64)
        return [
            head + _ld(2, blob) + _field(3, 0) + _varint(int(levels[i]))
            for i, blob in enumerate(dense_blobs)
        ]
    if not hasattr(state, "powers"):
        raise SpecError(f"moment serialization needs a MomentState; got {type(state).__name__}")
    count, zero, neg, total, vmin, vmax, powers, log_powers = (
        getattr(state, f).cpu().numpy().astype(np.float64)
        for f in ("count", "zero_count", "neg_count", "sum", "min", "max", "powers",
                  "log_powers")
    )
    k = powers.shape[-1]
    return [
        head + _ld(4, _moment_payload(
            k, [count[i], zero[i], neg[i], total[i], vmin[i], vmax[i]],
            powers[i], log_powers[i],
        ))
        for i in range(count.shape[0])
    ]


def _skip_field(blob: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:
        _, i = _read_varint(blob, i)
        return i
    if wire_type == 1:
        return i + 8
    if wire_type == 2:
        n, i = _read_varint(blob, i)
        return i + n
    if wire_type == 5:
        return i + 4
    raise WireDecodeError(f"SketchPayload wire type {wire_type} unsupported")


def _parse_payload(blob: bytes):
    """One envelope blob -> ``(backend_enum, dense, level, moment)``.
    Unknown fields are skipped (proto3); an unknown backend enum refuses by
    value; structural damage raises ``WireDecodeError``."""
    i = 0
    backend = 0
    dense = None
    level = 0
    moment = None
    n_total = len(blob)
    while i < n_total:
        key, i = _read_varint(blob, i)
        tag, wt = key >> 3, key & 7
        if tag == 1 and wt == 0:
            backend, i = _read_varint(blob, i)
        elif tag == 2 and wt == 2:
            n, i = _read_varint(blob, i)
            if i + n > n_total:
                raise WireDecodeError("SketchPayload.dense truncated")
            dense = blob[i : i + n]
            i += n
        elif tag == 3 and wt == 0:
            level, i = _read_varint(blob, i)
        elif tag == 4 and wt == 2:
            n, i = _read_varint(blob, i)
            if i + n > n_total:
                raise WireDecodeError("SketchPayload.moment truncated")
            moment = blob[i : i + n]
            i += n
        else:
            i = _skip_field(blob, i, wt)
        if i > n_total:
            raise WireDecodeError("SketchPayload truncated mid-field")
    if backend not in BACKEND_NAMES:
        raise WireDecodeError(
            f"unknown SketchPayload.Backend enum value {backend}: refusing to decode"
            " (emitter is newer than this reader; known values"
            f" {sorted(BACKEND_NAMES)})"
        )
    return backend, dense, level, moment


def _parse_moment(payload: bytes):
    """MomentPayload bytes -> ``(k, scalars[6], powers[k], log_powers[k])``;
    length or structure damage raises ``WireDecodeError``."""
    i = 0
    k = None
    scalars = powers = log_powers = None
    n_total = len(payload)
    while i < n_total:
        key, i = _read_varint(payload, i)
        tag, wt = key >> 3, key & 7
        if tag == 1 and wt == 0:
            k, i = _read_varint(payload, i)
        elif tag in (2, 3, 4) and wt == 2:
            n, i = _read_varint(payload, i)
            if i + n > n_total or n % 8:
                raise WireDecodeError("MomentPayload packed-double run truncated")
            arr = np.frombuffer(payload[i : i + n], np.float64)
            if tag == 2:
                scalars = arr
            elif tag == 3:
                powers = arr
            else:
                log_powers = arr
            i += n
        else:
            i = _skip_field(payload, i, wt)
    if k is None or scalars is None or powers is None or log_powers is None:
        raise WireDecodeError(
            "MomentPayload missing required fields (k/scalars/powers/log_powers)"
        )
    if scalars.shape[0] != 6 or powers.shape[0] != k or log_powers.shape[0] != k:
        raise WireDecodeError(
            f"MomentPayload vector lengths disagree with k={k}: scalars={scalars.shape[0]},"
            f" powers={powers.shape[0]}, log_powers={log_powers.shape[0]}"
        )
    return k, scalars, powers, log_powers


def _pack_blobs(blobs):
    """Concatenate ``blobs`` for a native scan -> (buf, offsets int64[n+1])."""
    n = len(blobs)
    lens = np.fromiter((len(b) for b in blobs), np.int64, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return b"".join(blobs), offsets


def _wrong_backend(idx: int, backend: int, want: str) -> WireDecodeError:
    return WireDecodeError(
        f"blob {idx} carries backend {BACKEND_NAMES.get(backend, backend)!r},"
        f" spec wants {want!r}"
    )


def _native_scan_counters(n_careful: int) -> None:
    if telemetry._ACTIVE:
        telemetry.counter_inc("wire.native.decode_calls")
        if n_careful:
            telemetry.counter_inc("wire.native.careful_fallbacks", float(n_careful))


def payload_from_bytes(spec, blobs, *, assume_native_linear: bool = False, device=None):
    """Decode envelope (or, under a dense spec, classic) blobs into one
    backend state on ``device`` (the card by default).

    Returns a ``SketchState`` (dense spec), an ``AdaptiveState``
    (uniform_collapse) or a ``MomentState`` (moment).  Each envelope's dense
    blob decodes through ``pb.wire.bytes_to_state`` onto the spec's window,
    as the dense decode does.  The native scanner
    (``ddsk_wire_scan_envelope`` / ``ddsk_wire_scan_moment``) splits
    canonical envelopes when it loads; anything it hands back, and every
    blob without it, goes through the Python walker, which raises the
    same errors.  Raises ``WireDecodeError`` as the module docstring says.
    """
    from sketches_tpu_torch import native
    from sketches_tpu_torch.batched import resolve_device
    from sketches_tpu_torch.pb.wire import bytes_to_state

    want = spec.backend
    if want == "dense":
        for idx, blob in enumerate(blobs):
            if blob[:1] == b"\x08":
                raise WireDecodeError(
                    f"blob {idx} is a SketchPayload envelope but the spec's backend is"
                    " 'dense': decode it with the matching backend spec"
                )
        return bytes_to_state(
            spec, blobs, assume_native_linear=assume_native_linear, device=device
        )
    dev = resolve_device(device)
    n = len(blobs)
    scanner = native.wire_scanner() if n else None
    enum = BACKEND_ENUM[want]
    if want == "uniform_collapse":
        from sketches_tpu_torch.backends.uniform import AdaptiveState

        dense_blobs: List[bytes] = [b""] * n
        levels = np.zeros(n, np.int64)
        if scanner is not None:
            # One C++ scan finds each canonical envelope's dense sub-blob and
            # level; handoffs and out-of-range levels are re-examined below
            # in batch order, so a refusal names the same first offender as
            # the Python walk.
            from sketches_tpu_torch.native import _i64ptr, _u8ptr

            buf, offsets = _pack_blobs([bytes(b) for b in blobs])
            status = np.zeros(n, np.uint8)
            level_arr = np.zeros(n, np.int64)
            doff = np.zeros(n, np.int64)
            dlen = np.zeros(n, np.int64)
            n_careful = scanner.ddsk_wire_scan_envelope(
                buf, n, _i64ptr(offsets), enum, _u8ptr(status),
                _i64ptr(level_arr), _i64ptr(doff), _i64ptr(dlen),
            )
            if n_careful < 0:
                status[:] = 1
                n_careful = n
            _native_scan_counters(int(n_careful))
            ok = status == 0
            bad_level = ok & ((level_arr < 0) | (level_arr > spec.max_collapses))
            for idx in np.nonzero(ok & ~bad_level)[0].tolist():
                dense_blobs[idx] = buf[doff[idx] : doff[idx] + dlen[idx]]
            levels = np.where(ok & ~bad_level, level_arr, 0)
            problems = np.nonzero(~ok | bad_level)[0].tolist()
        else:
            problems = list(range(n))
        for idx in problems:
            if scanner is not None and status[idx] == 0:
                raise WireDecodeError(
                    f"blob {idx}: collapse level {int(level_arr[idx])} outside"
                    f" [0, {spec.max_collapses}]"
                )
            backend, dense, level, _ = _parse_payload(bytes(blobs[idx]))
            if backend != enum:
                raise _wrong_backend(idx, backend, want)
            if dense is None:
                raise WireDecodeError(
                    f"blob {idx}: uniform_collapse envelope missing the dense payload"
                )
            if not 0 <= level <= spec.max_collapses:
                raise WireDecodeError(
                    f"blob {idx}: collapse level {level} outside [0, {spec.max_collapses}]"
                )
            dense_blobs[idx] = dense
            levels[idx] = level
        base = bytes_to_state(
            spec, dense_blobs, assume_native_linear=assume_native_linear, device=dev
        )
        return AdaptiveState(base, torch.from_numpy(levels.astype(np.int32)).to(dev))
    from sketches_tpu_torch.backends.moment import MomentState

    k_spec = spec.n_moments
    # [count, zero, neg, sum, min, max] per stream; the scanner copies
    # canonical envelopes straight in, the walker fills the rest.
    scal = np.zeros((n, 6), np.float64)
    scal[:, 4] = np.inf
    scal[:, 5] = -np.inf
    powers = np.zeros((n, k_spec), np.float64)
    log_powers = np.zeros((n, k_spec), np.float64)
    if scanner is not None:
        from sketches_tpu_torch.native import _dptr, _i64ptr, _u8ptr

        buf, offsets = _pack_blobs([bytes(b) for b in blobs])
        status = np.zeros(n, np.uint8)
        n_careful = scanner.ddsk_wire_scan_moment(
            buf, n, _i64ptr(offsets), enum, k_spec, _u8ptr(status),
            _dptr(scal), _dptr(powers), _dptr(log_powers),
        )
        if n_careful < 0:
            status[:] = 1
        careful = np.nonzero(status)[0].tolist()
        _native_scan_counters(len(careful))
    else:
        careful = list(range(n))
    for idx in careful:
        backend, _, _, moment = _parse_payload(bytes(blobs[idx]))
        if backend != enum:
            raise _wrong_backend(idx, backend, want)
        if moment is None:
            raise WireDecodeError(f"blob {idx}: moment envelope missing the moment payload")
        k, scalars, p, lp = _parse_moment(moment)
        if k != k_spec:
            raise WireDecodeError(
                f"blob {idx}: moment payload has k={k}, spec wants k={k_spec}"
            )
        scal[idx] = scalars
        powers[idx] = p
        log_powers[idx] = lp

    def cast(a):
        # Saturated power sums come back as +-inf in f32: the backend's
        # documented saturation state, not an error.
        with np.errstate(over="ignore"):
            return torch.from_numpy(np.ascontiguousarray(a).astype(np.float32)).to(dev)

    return MomentState(
        count=cast(scal[:, 0]),
        zero_count=cast(scal[:, 1]),
        neg_count=cast(scal[:, 2]),
        sum=cast(scal[:, 3]),
        min=cast(scal[:, 4]),
        max=cast(scal[:, 5]),
        powers=cast(powers),
        log_powers=cast(log_powers),
    )


def windowed_to_bytes(wsk) -> bytes:
    """The windowed envelope comes with the windowed sketch (ROADMAP A10);
    raises ``SpecError`` until then."""
    raise SpecError("the windowed envelope comes with the windowed sketch (ROADMAP A10)")


def windowed_from_bytes(blob, *args, **kwargs):
    """The windowed envelope comes with the windowed sketch (ROADMAP A10);
    raises ``SpecError`` until then."""
    raise SpecError("the windowed envelope comes with the windowed sketch (ROADMAP A10)")
