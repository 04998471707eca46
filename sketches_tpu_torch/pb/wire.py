"""Vectorized bulk wire-format serde for batched sketch states (PyTorch port).

Counterpart of ``sketches_tpu/pb/wire.py``: the same codec over the same
bytes, with the state read from and written to torch tensors.

* **encode** (:func:`state_to_bytes`): one host copy of the four leaves it
  reads, then streams group by their store's chunk-padded run length; each
  group's payload bytes come from one fancy-indexed gather + ``tobytes``
  (f64, C order), and the per-stream remainder is a few cached varints
  joined around the payload slices.  The output is byte-identical to
  ``DDSketchProto.to_proto(sk).SerializeToString()`` over
  ``to_host_sketches``, and to the JAX package's encoder on the same
  state: same chunk-padded runs, same field order, same proto3
  default-skipping.
* **decode** (:func:`bytes_to_state`): two interchangeable batch drivers
  behind one contract.  The **native driver** (default when the native
  library carries the versioned wire ABI) packs the batch into one buffer
  and hands the canonical walk to one ``ddsk_wire_scan_dense`` call
  (``native/ddsketch_wire.cpp``), then group-scatters the returned runs in
  numpy.  The **pure-Python driver** walks each blob with the hand-rolled
  parser and a structural-template memo; it is the fallback tier (no
  toolchain, ``SKETCHES_TPU_NATIVE=0``, a library of another ABI) and the
  oracle the native driver is tested against.  Anything non-canonical
  (sparse ``binCounts`` maps, unpacked repeated doubles, foreign field
  orders, unknown fields, damaged bytes) falls back per message to
  protobuf's parser plus a careful scalar placement with the semantics of
  ``batched.from_host_sketches``, so both drivers give bit-identical
  states and record-identical quarantine reports.  That fallback, and
  :func:`protos_to_state`, need protobuf; without it they raise
  ``EngineUnavailable`` (a blob is never skipped).

Mapping gates are shared with ``pb.proto.KeyMappingProto``: LINEAR foreign
bytes refuse by default, unknown enum values raise, NONE/QUADRATIC/CUBIC
decode unconditionally.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

from sketches_tpu_torch.batched import (
    SketchSpec,
    SketchState,
    arrays_to_state,
    occupied_bounds_np,
)
from sketches_tpu_torch.mapping import LinearlyInterpolatedMapping
from sketches_tpu_torch.pb.proto import (
    _MAPPING_TO_INTERPOLATION,
    KeyMappingProto,
    messages,
)
from sketches_tpu_torch.resilience import (
    BlobTooLarge,
    QuarantineReport,
    SketchValueError,
    UnequalSketchParametersError,
)

__all__ = ["state_to_bytes", "bytes_to_state", "protos_to_state"]

_CHUNK = 128  # DenseStore growth quantum (store.py CHUNK_SIZE)


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


def _zigzag32(n: int) -> int:
    return ((n << 1) ^ (n >> 31)) & 0xFFFFFFFF


class _VarintMemo(dict):
    """varint bytes memoized by value -- offsets/lengths repeat heavily."""

    def __missing__(self, n):
        b = self[n] = _varint(n)
        return b


def _mapping_field(spec: SketchSpec) -> bytes:
    """Serialized ``mapping`` field (1) -- identical for every stream, so
    built once per call through the same enum table the object bridge uses."""
    mapping = spec.mapping
    interpolation = _MAPPING_TO_INTERPOLATION[type(mapping)]
    body = b"\x09" + struct.pack("<d", mapping.gamma)
    if mapping._offset:  # proto3 skips the 0.0 default
        body += b"\x11" + struct.pack("<d", mapping._offset)
    if interpolation:
        body += b"\x18" + _varint(interpolation)
    return b"\x0a" + _varint(len(body)) + body


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _padded_payloads(src: np.ndarray, rows: np.ndarray, lo: np.ndarray, length: int) -> bytes:
    """Wire payload bytes for one same-padded-length group.

    Gathers ``length`` f64 columns starting at each row's run start in ONE
    fancy-indexed op.  Columns past ``n_bins`` read as zeros (the host
    store's chunk padding); columns inside the array but past the run are
    zeros already by the occupied-bounds invariant.  Row ``i``'s doubles
    are bytes ``[i*8L, (i+1)*8L)`` of the C-order buffer.
    """
    n_bins = src.shape[1]
    cols = lo[:, None] + np.arange(length)  # [k, L]
    valid = cols < n_bins
    block = src[rows[:, None], np.minimum(cols, n_bins - 1)].astype(np.float64)
    if not valid.all():
        block *= valid
    return block.tobytes()


def _encode_store_parts(src, plo, phi, koff, vmemo):
    """Per-stream store-field pieces for one store of the whole batch ->
    (header list, payload bytes list, offset-suffix list), to be joined
    around the group payload slices.  Empty stores get the canonical empty
    submessage (present, zero fields)."""
    n, n_bins = src.shape
    run = phi - plo + 1  # <= 0 for empty stores
    length = np.minimum(-(-run // _CHUNK) * _CHUNK, n_bins)
    offs = plo + koff
    headers: list = [None] * n
    payloads: list = [None] * n
    suffixes: list = [None] * n
    empty = phi < 0
    # Group streams by padded length; one gather + tobytes per group.
    for L in np.unique(length[~empty]):
        Li = int(L)
        rows = np.nonzero((length == L) & ~empty)[0]
        buf = _padded_payloads(src, rows, plo[rows], Li)
        packed_prefix = b"\x12" + vmemo[8 * Li]
        step = 8 * Li
        for g, i in enumerate(rows):
            off = int(offs[i])
            suffix = b"\x18" + vmemo[_zigzag32(off)] if off else b""
            body_len = len(packed_prefix) + step + len(suffix)
            headers[i] = vmemo[body_len] + packed_prefix
            payloads[i] = buf[g * step : (g + 1) * step]
            suffixes[i] = suffix
    return headers, payloads, suffixes, empty


def state_to_bytes(spec: SketchSpec, state: SketchState) -> List[bytes]:
    """Serialize every stream -> wire bytes, byte-identical to the object
    bridge's ``to_proto(...).SerializeToString()`` (and to the JAX
    package's ``state_to_bytes`` on the same state).  Reads the state to
    the host once: one copy each of the bins, zero counts and offsets."""
    bins_pos, bins_neg, zero, koff = (
        getattr(state, f).cpu().numpy()
        for f in ("bins_pos", "bins_neg", "zero_count", "key_offset")
    )
    koff = koff.astype(np.int64)
    plo, phi = occupied_bounds_np(bins_pos)
    nlo, nhi = occupied_bounds_np(bins_neg)
    mapping_field = _mapping_field(spec)
    vmemo = _VarintMemo()
    ph, pp, ps, pe = _encode_store_parts(
        bins_pos, plo.astype(np.int64), phi.astype(np.int64), koff, vmemo
    )
    nh, np_, ns, ne = _encode_store_parts(
        bins_neg, nlo.astype(np.int64), nhi.astype(np.int64), koff, vmemo
    )
    zero64 = zero.astype(np.float64)
    has_zero = zero64 != 0.0
    n = state.n_streams
    blobs = []
    empty_store = b"\x00"
    for i in range(n):
        parts = [mapping_field, b"\x12"]
        if pe[i]:
            parts.append(empty_store)
        else:
            parts += (ph[i], pp[i], ps[i])
        parts.append(b"\x1a")
        if ne[i]:
            parts.append(empty_store)
        else:
            parts += (nh[i], np_[i], ns[i])
        if has_zero[i]:
            parts.append(b"\x21" + struct.pack("<d", zero64[i]))
        blobs.append(b"".join(parts))
    return blobs


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _read_varint(blob: bytes, i: int):
    r = 0
    shift = 0
    while True:
        b = blob[i]
        i += 1
        r |= (b & 0x7F) << shift
        if not b & 0x80:
            return r, i
        shift += 7


def _careful_place(arr, i, store_proto, base, n_bins):
    """Scalar placement with ``StoreProto.merge_into`` + window-clamp
    semantics (the from_host_sketches path) -> (mass, low fold, high fold).
    Dense entries place only when strictly positive; sparse map entries add
    unconditionally."""
    mass = low = high = 0.0
    counts = store_proto.contiguousBinCounts
    ln = len(counts)
    if ln:
        row = np.fromiter(counts, np.float64, ln)
        np.clip(row, 0.0, None, out=row)
        j0 = store_proto.contiguousBinIndexOffset - base
        mass = float(row.sum())
        lo_cut = max(0, -j0)
        hi_cut = max(0, min(ln, n_bins - j0))
        if lo_cut:
            low = float(row[:lo_cut].sum())
            arr[i, 0] += low
        if hi_cut < ln:
            high = float(row[hi_cut:].sum())
            arr[i, n_bins - 1] += high
        if hi_cut > lo_cut:
            arr[i, j0 + lo_cut : j0 + hi_cut] += row[lo_cut:hi_cut]
    for key, weight in store_proto.binCounts.items():
        mass += weight
        j = key - base
        if j < 0:
            arr[i, 0] += weight
            low += weight
        elif j >= n_bins:
            arr[i, n_bins - 1] += weight
            high += weight
        else:
            arr[i, j] += weight
    return mass, low, high


class _Decoder:
    """Accumulates one batch's decode: canonical runs group-vectorized,
    everything else through the careful scalar path.

    Memory discipline matters more than op count here (page faults on
    fresh memory grow costly once a process holds a few GB), so the
    decoder (a) trims each run's all-zero chunk padding at parse time (the payload's ``rstrip`` view -- no spill columns, no
    staging pre-fault), (b) holds zero-copy memoryviews into the input
    blobs rather than slice copies, and (c) flushes groups incrementally
    so join/scatter temps stay ~100 MB and recycle.
    """

    #: flush the pending groups when their payload bytes exceed this.
    _FLUSH_BYTES = 1 << 27

    def __init__(self, spec: SketchSpec, n: int, device=None):
        self.spec = spec
        self.device = device
        self.n_bins = spec.n_bins
        self.base = spec.key_offset
        self.bins_pos = np.zeros((n, self.n_bins), np.float64)
        self.bins_neg = np.zeros((n, self.n_bins), np.float64)
        self.zero = np.zeros((n,), np.float64)
        self.count = np.zeros((n,), np.float64)
        self.clow = np.zeros((n,), np.float64)
        self.chigh = np.zeros((n,), np.float64)
        # Canonical runs grouped by (store, trimmed length): lists of
        # (stream index, window start, payload memoryview).
        self.groups: dict = {}
        self.pending_bytes = 0
        self.mapping_cache: dict = {}

    def flush_groups(self) -> None:
        for (which, ln), items in self.groups.items():
            if not items:
                continue
            k = len(items)
            idx = np.fromiter((it[0] for it in items), np.int64, k)
            j0s = np.fromiter((it[1] for it in items), np.int64, k)
            # One frombuffer over the joined payload views: C-speed
            # assembly of the [k, ln] block (np.stack over k tiny views is
            # ~2x slower; bytes.join accepts buffer objects).
            block = np.frombuffer(
                b"".join([it[2] for it in items]), np.float64
            ).reshape(k, ln)
            self.place_block(which, idx, j0s, block, ln)
        self.groups = {}
        self.pending_bytes = 0

    def place_block(self, which, idx, j0s, block, ln: int) -> None:
        """Place one same-length group block ``[k, ln]`` into store
        ``which`` (0 = positive, 1 = negative).  The single placement
        authority for both parse paths: the pure-Python group flush and
        the native scanner feed it identical payload doubles, so the
        resulting states are bit-identical by construction.  Stream rows
        must be unique within the block (one canonical run per (stream,
        store)), so the fancy ``+=`` cannot collide."""
        arr = (self.bins_pos, self.bins_neg)[which]
        nb = self.n_bins
        if block.min() < 0.0:
            # Dense entries place only when strictly positive
            # (StoreProto.merge_into) and mass counts post-clip.
            block = np.clip(block, 0.0, None)
        self.count[idx] += block.sum(axis=1)
        easy = (j0s >= 0) & (j0s + ln <= nb)
        e = np.nonzero(easy)[0]
        # Scatter in bounded row chunks: chunking keeps the
        # advanced-indexing broadcast temps recycled instead of
        # faulting fresh GBs.
        cstep = max(1, (1 << 23) // max(ln, 1))
        lane = np.arange(ln)
        for s in range(0, e.size, cstep):
            es = e[s : s + cstep]
            arr[idx[es][:, None], j0s[es][:, None] + lane] += block[es]
        for h in np.nonzero(~easy)[0]:
            # Foreign-shaped run overlapping/outside the window: fold
            # the overhangs into the edge bins with collapse counters.
            i, j0 = int(idx[h]), int(j0s[h])
            row = block[h]
            lo_cut = max(0, -j0)
            hi_cut = max(0, min(ln, nb - j0))
            if lo_cut:
                low = float(row[:lo_cut].sum())
                arr[i, 0] += low
                self.clow[i] += low
            if hi_cut < ln:
                high = float(row[hi_cut:].sum())
                arr[i, nb - 1] += high
                self.chigh[i] += high
            if hi_cut > lo_cut:
                arr[i, j0 + lo_cut : j0 + hi_cut] += row[lo_cut:hi_cut]

    def careful_message(self, i: int, msg, assume_native_linear: bool) -> None:
        key = (msg.mapping.gamma, msg.mapping.indexOffset, msg.mapping.interpolation)
        m = self.mapping_cache.get(key)
        if m is None:
            m = self.mapping_cache[key] = KeyMappingProto.from_proto(
                msg.mapping, assume_native_linear=assume_native_linear
            )
        if m != self.spec.mapping:
            raise UnequalSketchParametersError(
                f"Decoded mapping {m!r} does not match batched spec mapping"
                f" {self.spec.mapping!r}"
            )
        pm, pl, ph = _careful_place(
            self.bins_pos, i, msg.positiveValues, self.base, self.n_bins
        )
        nm, nl, nh = _careful_place(
            self.bins_neg, i, msg.negativeValues, self.base, self.n_bins
        )
        self.zero[i] = msg.zeroCount
        self.count[i] += pm + nm + msg.zeroCount
        self.clow[i] += pl + nl
        self.chigh[i] += ph + nh

    def finish(self) -> SketchState:
        self.flush_groups()
        n = self.count.shape[0]
        inf = np.full((n,), np.inf)
        return arrays_to_state(
            self.spec, self.bins_pos, self.bins_neg,
            self.zero, self.count,
            np.zeros((n,)), inf, -inf, self.clow, self.chigh, device=self.device,
        )


def _parse_canonical(blob: bytes, start: int, i: int, base: int):
    """Walk one canonical blob past its mapping prefix.

    Returns ``(pending, zero_count, store_positions, zc_pos)`` --
    ``pending`` holds ``((is_neg, trimmed_len), (stream, window_start,
    payload view))`` per store run; ``store_positions`` /``zc_pos`` are
    the absolute byte positions a :class:`_Template` needs -- or ``None``
    for ANY non-canonical shape: unknown fields, repeated store fields
    (legal protobuf, but the group scatter assumes one run per
    (stream, store)), and declared lengths that leave the blob (a
    truncated blob must reach the careful path, whose
    ``FromString`` raises DecodeError, never be silently slice-clamped
    into a shorter run).
    """
    end = len(blob)
    j = start
    pending: list = []
    zc = 0.0
    zc_pos = -1
    positions: list = []
    seen = 0  # store fields already parsed (bit 0 pos, bit 1 neg)
    while j < end:
        tag = blob[j]
        if tag == 0x12 or tag == 0x1A:  # positiveValues / negativeValues
            bit = 1 if tag == 0x12 else 2
            if seen & bit or j + 1 >= end:
                return None
            seen |= bit
            # Inlined varints (canonical store bodies are `0x12 <len>
            # <payload> [0x18 <zigzag off>]`; anything else falls back).
            b = blob[j + 1]
            if b < 0x80:
                ln = b
                j += 2
            else:
                ln, j = _read_varint(blob, j + 1)
            end_body = j + ln
            if end_body > end:
                return None
            if ln == 0:  # empty store submessage
                continue
            if blob[j] != 0x12 or j + 1 >= end_body:
                return None
            b = blob[j + 1]
            if b < 0x80:
                pl = b
                p0 = j + 2
            else:
                pl, p0 = _read_varint(blob, j + 1)
            pend = p0 + pl
            if pend > end_body or pl & 7:
                return None
            key_off = 0
            off_a = off_b = -1
            if pend < end_body:
                if blob[pend] != 0x18 or pend + 1 >= end_body:
                    return None
                z, nxt = _read_varint(blob, pend + 1)
                # Protobuf sint32 semantics: the varint TRUNCATES to its
                # low 32 bits before zigzag decode (a >32-bit offset
                # varint is legal on the wire; the C++ FromString path
                # truncates, so the fast path must too or the two decode
                # paths diverge on the same foreign bytes).
                z &= 0xFFFFFFFF
                key_off = (z >> 1) ^ -(z & 1)
                if nxt != end_body:
                    return None
                off_a, off_b = pend + 1, nxt
            positions.append((tag == 0x1A, p0, pend, off_a, off_b))
            # Trim the run's trailing all-zero doubles (the host store's
            # chunk padding): shorter groups, no out-of-window zero
            # overhang, and the group block shrinks to the real mass.
            # rstrip is C-speed; the kept view slices the ORIGINAL blob
            # (zero copy) at the 8-byte-rounded cut, so a double with any
            # nonzero byte survives whole.
            stripped = blob[p0:pend].rstrip(b"\x00")
            t_len = (len(stripped) + 7) >> 3
            if t_len:
                pending.append(
                    (
                        (tag == 0x1A, t_len),
                        (
                            i,
                            key_off - base,
                            memoryview(blob)[p0 : p0 + 8 * t_len],
                        ),
                    )
                )
            j = end_body
        elif tag == 0x21:  # zeroCount double
            if j + 9 > end:
                return None
            zc = struct.unpack_from("<d", blob, j + 1)[0]
            zc_pos = j
            j += 9
        else:
            return None
    return pending, zc, positions, zc_pos


class _Template:
    """Structural fast path for same-shaped canonical blobs.

    Bulk batches are highly homogeneous: most blobs share byte-identical
    STRUCTURE (field tags, length varints, offset-varint widths) and
    differ only in the payload doubles, the offset-varint values, and the
    zeroCount value.  A template memorizes one fully-parsed blob's
    structural byte ranges; a candidate of the same length whose
    structural bytes match byte-for-byte skips the field walk (one memcmp
    per range + per-store varint/rstrip).  Any mismatch -- including a
    same-length blob with compensating structural differences -- simply
    misses and takes the full walker, so the template is a pure
    optimization with no acceptance risk.
    """

    __slots__ = ("struct_slices", "stores", "zc_pos")

    def __init__(self, blob: bytes, start: int, stores, zc_pos: int):
        self.stores = stores
        self.zc_pos = zc_pos
        value_ranges = []  # byte ranges whose CONTENT may differ per blob
        for (_, p0, pend, off_a, off_b) in stores:
            value_ranges.append((p0, pend))
            if off_a >= 0:
                value_ranges.append((off_a, off_b))
        if zc_pos >= 0:
            value_ranges.append((zc_pos + 1, zc_pos + 9))
        value_ranges.sort()
        slices = []
        prev = start
        for a, b in value_ranges:
            if a > prev:
                slices.append((prev, blob[prev:a]))
            prev = b
        if prev < len(blob):
            slices.append((prev, blob[prev:]))
        self.struct_slices = slices

    def extract(self, blob: bytes, i: int, base: int):
        """(pending, zc) for a structurally matching blob, else None."""
        for a, ref in self.struct_slices:
            if blob[a : a + len(ref)] != ref:
                return None
        pending = []
        mv = memoryview(blob)
        for (is_neg, p0, pend, off_a, off_b) in self.stores:
            key_off = 0
            if off_a >= 0:
                # Same offset-varint WIDTH is structural; the value is
                # free.  The continuation pattern must terminate exactly
                # at off_b or the structure differs after all.
                if blob[off_b - 1] & 0x80:
                    return None
                for k in range(off_a, off_b - 1):
                    if not blob[k] & 0x80:
                        return None
                z, _ = _read_varint(blob, off_a)
                z &= 0xFFFFFFFF  # protobuf sint32 truncation (see above)
                key_off = (z >> 1) ^ -(z & 1)
            stripped = blob[p0:pend].rstrip(b"\x00")
            t_len = (len(stripped) + 7) >> 3
            if t_len:
                pending.append(
                    (
                        (is_neg, t_len),
                        (i, key_off - base, mv[p0 : p0 + 8 * t_len]),
                    )
                )
        zc = 0.0
        if self.zc_pos >= 0:
            zc = struct.unpack_from("<d", blob, self.zc_pos + 1)[0]
        return pending, zc


def _scan_dense_native(scanner, blobs, expected_mapping: bytes, base: int,
                       status: np.ndarray):
    """One C++ structural scan over the packed batch.

    Packs ``blobs`` into a single buffer, hands the canonical walk
    (prefix memcmp, store framing, varint/zigzag decode, zero-padding
    trim) to ``ddsk_wire_scan_dense``, and returns the per-blob fact
    arrays plus the aligned payload staging buffer.  ``status`` entries
    nonzero on entry are skipped by the scanner (pre-marked admission
    failures); on return nonzero entries are the careful-path handoffs.
    """
    from sketches_tpu_torch.native import _dptr, _i64ptr, _u8ptr

    n = len(blobs)
    lens = np.fromiter((len(b) for b in blobs), np.int64, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    buf = b"".join(blobs)
    zc = np.zeros(n, np.float64)
    run_pos = np.zeros(2 * n, np.int64)
    run_len = np.zeros(2 * n, np.int64)
    run_j0 = np.zeros(2 * n, np.int64)
    payload = np.empty(max(1, len(buf) // 8), np.float64)
    n_careful = scanner.ddsk_wire_scan_dense(
        buf, n, _i64ptr(offsets), expected_mapping, len(expected_mapping),
        base, _u8ptr(status), _dptr(zc), _i64ptr(run_pos),
        _i64ptr(run_len), _i64ptr(run_j0), _dptr(payload),
    )
    if n_careful < 0:  # defensive: the scanner refused its arguments
        status[:] = 1
        n_careful = n
    return zc, run_pos, run_len, run_j0, payload, int(n_careful)


def _place_native_runs(dec: "_Decoder", ok: np.ndarray, run_pos, run_len,
                       run_j0, payload: np.ndarray) -> None:
    """Group-scatter the native scanner's runs through the decoder.

    The same (store, trimmed-length) grouping as the pure-Python flush,
    but the group block assembles as ONE fancy gather out of the aligned
    payload staging buffer instead of a join over per-blob memoryviews.
    Placement goes through ``_Decoder.place_block`` (the single
    placement authority), chunked so gather temps stay bounded.
    """
    n = ok.shape[0]
    sel = np.repeat(ok, 2) & (run_len > 0)
    if not sel.any():
        return
    stream2 = np.repeat(np.arange(n, dtype=np.int64), 2)
    neg2 = np.tile(np.array([False, True]), n)
    for which in (0, 1):
        m = sel & (neg2 if which else ~neg2)
        if not m.any():
            continue
        idx = stream2[m]
        j0s = run_j0[m]
        lens = run_len[m]
        pos = run_pos[m]
        # One stable sort groups the runs by trimmed length (cheaper
        # than a boolean scan per distinct length when lengths spread).
        order = np.argsort(lens, kind="stable")
        lens = lens[order]
        bounds = np.nonzero(np.diff(lens))[0] + 1
        starts = np.concatenate(([0], bounds))
        stops = np.concatenate((bounds, [lens.size]))
        for a, b in zip(starts.tolist(), stops.tolist()):
            g = order[a:b]
            ln = int(lens[a])
            lane = np.arange(ln)
            rstep = max(1, (1 << 23) // ln)
            for s in range(0, g.size, rstep):
                gs = g[s : s + rstep]
                block = payload[pos[gs][:, None] + lane]
                dec.place_block(which, idx[gs], j0s[gs], block, ln)


def _quarantine_kind(exc: BaseException) -> str:
    """Stable reason slug for one quarantined blob's failure."""
    if isinstance(exc, BlobTooLarge):
        return "over_limit"
    if isinstance(exc, UnequalSketchParametersError):
        return "mapping_mismatch"
    if type(exc).__name__ == "DecodeError":  # google.protobuf DecodeError
        return "unparseable"
    if isinstance(exc, ValueError):
        return "invalid"
    return "error"


def _careful_blob(dec: "_Decoder", i: int, blob: bytes,
                  assume_native_linear: bool, report) -> None:
    """One blob through the protobuf reference path (shared by both batch
    drivers).  Quarantine admission: every raiser -- ``FromString``'s
    DecodeError, the mapping gates -- fires before any placement into the
    decode arrays, so a quarantined stream's row stays exactly empty.  A
    missing protobuf raises ``EngineUnavailable`` in either error mode:
    the blob is not quarantined, because it was never judged."""
    pb = messages()
    if report is None:
        dec.careful_message(
            i, pb.DDSketch.FromString(blob), assume_native_linear
        )
    else:
        try:
            dec.careful_message(
                i, pb.DDSketch.FromString(blob), assume_native_linear
            )
        except Exception as e:
            report.add(i, _quarantine_kind(e), e)


def _decode_batch_python(dec: "_Decoder", blobs, expected_mapping: bytes,
                         base: int, fast_ok: bool,
                         assume_native_linear: bool, report,
                         max_blob_bytes: Optional[int]) -> None:
    """The pure-Python batch driver: per-blob canonical walk with the
    structural-template memo, group staging with incremental flushes, and
    per-blob careful fallback.  This is the fallback tier when the native
    scanner is unavailable (no toolchain, ``SKETCHES_TPU_NATIVE=0``,
    stale/ABI-mismatched ``.so``) -- and the semantic oracle the native
    driver is differential-tested against."""
    mlen = len(expected_mapping)
    zeros: list = []  # (stream, zeroCount) -- vector-assigned at the end
    templates: dict = {}  # blob length -> _Template
    for i, blob in enumerate(blobs):
        if max_blob_bytes is not None and len(blob) > max_blob_bytes:
            exc = BlobTooLarge(
                f"blob {i}: {len(blob)} bytes exceeds"
                f" max_blob_bytes={max_blob_bytes}"
            )
            if report is None:
                raise exc
            report.add(i, "over_limit", exc)
            continue
        parsed = None
        if fast_ok and blob.startswith(expected_mapping):
            t = templates.get(len(blob))
            if t is not None:
                parsed = t.extract(blob, i, base)
            if parsed is None:
                # IndexError backstop: a malformed varint whose
                # continuation bits run off the blob end must land on the
                # careful path (DecodeError), not escape as IndexError.
                try:
                    full = _parse_canonical(blob, mlen, i, base)
                except IndexError:
                    full = None
                if full is not None:
                    pending_f, zc_f, positions, zc_pos = full
                    parsed = (pending_f, zc_f)
                    if t is None:
                        templates[len(blob)] = _Template(
                            blob, mlen, positions, zc_pos
                        )
        if parsed is None:
            _careful_blob(dec, i, blob, assume_native_linear, report)
            continue
        pending, zc = parsed
        groups = dec.groups
        for key, entry in pending:
            g = groups.get(key)
            if g is None:
                g = groups[key] = []
            g.append(entry)
            dec.pending_bytes += key[1] << 3
        if zc:
            zeros.append((i, zc))
        if dec.pending_bytes >= dec._FLUSH_BYTES:
            dec.flush_groups()
    if zeros:
        zi = np.fromiter((z[0] for z in zeros), np.int64, len(zeros))
        zv = np.fromiter((z[1] for z in zeros), np.float64, len(zeros))
        dec.zero[zi] = zv
        dec.count[zi] += zv


def _decode_batch_native(scanner, dec: "_Decoder", blobs,
                         expected_mapping: bytes, base: int,
                         assume_native_linear: bool, report,
                         max_blob_bytes: Optional[int]) -> None:
    """The native batch driver: one C++ structural scan over the packed
    batch, vectorized group placement, then the careful-path handoffs in
    batch order.

    Decodes bit-identically to :func:`_decode_batch_python` by
    construction: fast-parsed blobs yield the identical payload doubles /
    window starts / zero counts (the scanner mirrors
    ``_parse_canonical``) placed by the same ``place_block`` authority,
    and careful blobs take the identical per-blob protobuf path in the
    identical order, so error types, quarantine records, and admission
    checks line up record-for-record.
    """
    blob_list = list(blobs)
    n = len(blob_list)
    status = np.zeros(n, np.uint8)
    if max_blob_bytes is not None:
        lens = np.fromiter((len(b) for b in blob_list), np.int64, n)
        status[lens > max_blob_bytes] = 3  # admission failure: pre-marked
    zc, run_pos, run_len, run_j0, payload, n_careful = _scan_dense_native(
        scanner, blob_list, expected_mapping, base, status,
    )
    ok = status == 0
    oki = np.nonzero(ok)[0]
    zsel = oki[zc[oki] != 0.0]
    dec.zero[zsel] = zc[zsel]
    dec.count[zsel] += zc[zsel]
    _place_native_runs(dec, ok, run_pos, run_len, run_j0, payload)
    if not n_careful:
        return
    for i in np.nonzero(status)[0].tolist():
        blob = blob_list[i]
        if status[i] == 3:  # over the admission cap
            exc = BlobTooLarge(
                f"blob {i}: {len(blob)} bytes exceeds"
                f" max_blob_bytes={max_blob_bytes}"
            )
            if report is None:
                raise exc
            report.add(i, "over_limit", exc)
            continue
        _careful_blob(dec, i, blob, assume_native_linear, report)


def bytes_to_state(
    spec: SketchSpec,
    blobs: Sequence[bytes],
    *,
    assume_native_linear: bool = False,
    errors: str = "raise",
    max_blob_bytes: Optional[int] = None,
    device=None,
):
    """Decode raw wire blobs into one batch on ``device`` (the card by
    default; ``device="cpu"`` for the CPU), on the spec's default window.

    Canonical blobs (this library's own encoder shape: expected mapping
    prefix, packed runs, sint32 offsets, trailing zeroCount) parse with the
    native scanner or the hand-rolled walker and place group-vectorized;
    anything else falls back per message to protobuf's parser + careful
    placement, so foreign wire quirks (sparse maps, unpacked doubles,
    unknown fields) decode with the object bridge's exact semantics.  The
    native batch driver runs when the scanner loads
    (``native.wire_scanner()``), else the pure-Python one; both give
    bit-identical states (``SKETCHES_TPU_NATIVE=0`` forces the latter).

    Error policy:

    * ``errors="raise"`` (default): the first bad blob raises (protobuf
      ``DecodeError``, mapping-gate ``ValueError``, :class:`BlobTooLarge`)
      and the whole batch is lost.
    * ``errors="quarantine"``: returns ``(state, QuarantineReport)``.  Bad
      blobs (unparseable bytes, mapping mismatches or refusals, blobs over
      ``max_blob_bytes``) go into the report (index + structured reason)
      and decode as empty streams; every other stream decodes
      bit-identically to a clean decode of the same blob.  Corruption that
      yields structurally valid protobuf is undetectable (the wire format
      carries no checksum): it decodes as whatever sketch the bytes
      describe.

    ``max_blob_bytes`` is the admission cap against oversized blobs
    (``None`` = no cap); it applies in both error modes.
    """
    from sketches_tpu_torch import native

    if errors not in ("raise", "quarantine"):
        raise SketchValueError(
            f"Unknown errors mode {errors!r}; expected 'raise' or"
            " 'quarantine'"
        )
    report = QuarantineReport(total=len(blobs)) if errors == "quarantine" else None
    dec = _Decoder(spec, len(blobs), device)
    expected_mapping = _mapping_field(spec)
    # A canonical-prefix match normally certifies the spec's own mapping;
    # for a LINEAR spec it cannot tell native bytes from a foreign emitter
    # that shares the serialization, so the refusal gate must still run
    # (through the careful path) unless the caller vouches.
    fast_ok = not (
        isinstance(spec.mapping, LinearlyInterpolatedMapping)
        and not assume_native_linear
    )
    base = spec.key_offset
    scanner = None
    if fast_ok and len(blobs):
        scanner = native.wire_scanner()
    if scanner is not None:
        _decode_batch_native(
            scanner, dec, blobs, expected_mapping, base,
            assume_native_linear, report, max_blob_bytes,
        )
    else:
        _decode_batch_python(
            dec, blobs, expected_mapping, base, fast_ok,
            assume_native_linear, report, max_blob_bytes,
        )
    state = dec.finish()
    if report is None:
        return state
    return state, report


def protos_to_state(
    spec: SketchSpec,
    protos: Sequence,
    *,
    assume_native_linear: bool = False,
    errors: str = "raise",
    max_blob_bytes: Optional[int] = None,
    device=None,
):
    """Decode parsed messages into one batch on ``device``.

    Re-serializing through protobuf's serializer canonicalizes the wire, so
    the group-vectorized bytes path serves message inputs too (error
    policy included -- see :func:`bytes_to_state`).  Needs protobuf
    (``EngineUnavailable`` without it).
    """
    messages()
    return bytes_to_state(
        spec,
        [m.SerializeToString() for m in protos],
        assume_native_linear=assume_native_linear,
        errors=errors,
        max_blob_bytes=max_blob_bytes,
        device=device,
    )
