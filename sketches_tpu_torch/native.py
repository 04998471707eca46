"""ctypes bindings for the native host-tier engine (PyTorch port).

Counterpart of ``sketches_tpu/native.py`` over the same, unchanged C++
sources: ``native/ddsketch_host.cpp`` (a single sketch with the device
tier's static-window semantics, so ``to_state`` lifts it directly into a
``[1, n_bins]`` batched state and ``from_state`` back) and
``native/ddsketch_wire.cpp`` (the bulk wire scanners ``pb.wire`` and
``backends.wirefmt`` decode with).

The shared library is built at first use, the way ``_build`` builds the
CUDA kernels: one ``g++`` with the Makefile's flags into
``build/sketches_tpu_torch/``, named by a hash of the sources and flags,
written to a temporary name and renamed into place, so concurrent
processes never load a half-written file.  (``native/``'s own Makefile
target is the JAX package's library and is never written from here.)

A failed build or load is retried a bounded number of times, then the
process degrades to the pure-Python tier: ``available()`` answers False,
``wire_scanner()`` None, and ``status()`` says which tier runs and why.
``SKETCHES_TPU_NATIVE=0`` forces that degradation (the tests use it to
drive the device-flush and pure-Python wire tiers).
"""

from __future__ import annotations

import binascii
import ctypes
import hashlib
import math
import os
import subprocess
import sys
import threading
import time
import typing
from pathlib import Path

import numpy as np
import torch

from sketches_tpu_torch._build import BUILD_DIR
from sketches_tpu_torch.resilience import (
    EngineUnavailable,
    SketchValueError,
    SpecError,
    UnequalSketchParametersError,
)

__all__ = [
    "available",
    "status",
    "reset",
    "wire_scanner",
    "library_path",
    "NativeDDSketch",
    "NATIVE_ENV",
    "WIRE_ABI_VERSION",
]

#: Environment kill switch: ``SKETCHES_TPU_NATIVE=0`` makes the native
#: engine unavailable (pure-Python host tier), as in the JAX package.
NATIVE_ENV = "SKETCHES_TPU_NATIVE"

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("ddsketch_host.cpp", "ddsketch_wire.cpp")
#: ``native/Makefile``'s ``CXXFLAGS`` plus its ``-shared``.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

#: Expected value of the library's ``ddsk_wire_abi_version()``.  A library
#: that answers another version (or lacks the symbols) degrades the wire
#: fast path to the pure-Python walker instead of decoding through a
#: mismatched layout.  In lockstep with ``kWireAbiVersion`` in
#: ``native/ddsketch_wire.cpp``.
WIRE_ABI_VERSION = 1

#: Build/load attempts before the engine degrades for the process, and the
#: capped exponential backoff between them.
_MAX_LOAD_ATTEMPTS = 3
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 0.2

_lock = threading.Lock()
_lib: typing.Optional[ctypes.CDLL] = None
_wire_ok = False
# The process's host tier: which one runs and why (read by status()).
_status: typing.Dict[str, typing.Optional[str]] = {"tier": None, "wire": None, "reason": None}


def _backoff_jitter(key: int, attempt: int) -> float:
    """Deterministic per-(key, attempt) factor in [0.5, 1.0): processes that
    fail together retry out of step, with no clock or RNG involved."""
    h = binascii.crc32(f"{key}:{attempt}".encode()) & 0xFFFFFFFF
    return 0.5 + 0.5 * (h / 2**32)


def library_path() -> Path:
    """Where the library lives: named by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libddsketch_host-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    ``OSError`` or ``CalledProcessError`` on failure."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _degrade(reason: str) -> None:
    _status.update(tier="python", wire="python", reason=reason)


def _load() -> typing.Optional[ctypes.CDLL]:
    """Build (if needed) and load the library, with bounded retry.

    A load that still fails degrades the process to the pure-Python host
    tier; the outcome is cached (no rebuild per call) and recorded in
    :func:`status`; :func:`reset` clears it.
    """
    global _lib, _wire_ok
    with _lock:
        if _lib is not None or _status["tier"] is not None:
            return _lib
        if os.environ.get(NATIVE_ENV) == "0":
            _degrade(f"disabled via {NATIVE_ENV}=0")
            return None
        last_error = None
        for attempt in range(_MAX_LOAD_ATTEMPTS):
            if attempt:
                time.sleep(
                    min(_BACKOFF_BASE_S * 2 ** (attempt - 1), _BACKOFF_CAP_S)
                    * _backoff_jitter(os.getpid(), attempt)
                )
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, subprocess.CalledProcessError) as e:
                last_error = getattr(e, "stderr", None) or str(e)
                continue
            _wire_ok = _bind_wire(_lib)
            _status.update(
                tier="native",
                wire="native" if _wire_ok else "python",
                reason=None if _wire_ok else (
                    f"wire scanner unavailable: ddsk_wire_abi_version != {WIRE_ABI_VERSION}"
                    " or symbols missing (stale or ABI-mismatched library)"
                ),
            )
            return _lib
        _degrade(f"load failed after {_MAX_LOAD_ATTEMPTS} attempts: {last_error}")
        return None


def reset() -> None:
    """Forget the cached load outcome (the next ``available()`` retries).
    Live ``NativeDDSketch`` objects keep their own library handle."""
    global _lib, _wire_ok
    with _lock:
        _lib = None
        _wire_ok = False
        _status.update(tier=None, wire=None, reason=None)


def status() -> dict:
    """The host tier this process runs, after trying the library once:
    ``{"tier": "native" | "python", "wire": "native" | "python",
    "reason": why a tier degraded (None when neither did)}``."""
    _load()
    return dict(_status)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the host engine's C ABI on a freshly loaded handle."""
    dp = ctypes.POINTER(ctypes.c_double)
    lib.sketch_create.restype = ctypes.c_void_p
    lib.sketch_create.argtypes = [ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sketch_destroy.restype = None
    lib.sketch_destroy.argtypes = [ctypes.c_void_p]
    lib.sketch_add.restype = None
    lib.sketch_add.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double]
    lib.sketch_add_batch.restype = None
    lib.sketch_add_batch.argtypes = [ctypes.c_void_p, dp, dp, ctypes.c_size_t]
    lib.sketch_quantile.restype = ctypes.c_double
    lib.sketch_quantile.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.sketch_merge.restype = ctypes.c_int
    lib.sketch_merge.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sketch_counters.restype = None
    lib.sketch_counters.argtypes = [ctypes.c_void_p, dp]
    lib.sketch_bins.restype = None
    lib.sketch_bins.argtypes = [ctypes.c_void_p, dp, dp]
    lib.sketch_load_bins.restype = None
    lib.sketch_load_bins.argtypes = [ctypes.c_void_p, dp, dp, dp]
    return lib


def _bind_wire(lib: ctypes.CDLL) -> bool:
    """Declare the wire scanners' C ABI on a loaded handle: the dense
    scanner and the two ``SketchPayload`` envelope scanners.

    Returns False (never raises) when the symbols are absent, when
    ``ddsk_wire_abi_version()`` disagrees with :data:`WIRE_ABI_VERSION`,
    or on a big-endian host (the scanner copies little-endian wire doubles
    verbatim).  Argument types are declared before the version call, so a
    mismatched library is never entered with an unchecked signature.
    """
    if sys.byteorder != "little":  # pragma: no cover - LE hosts only
        return False
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_longlong
    i64p = ctypes.POINTER(ctypes.c_longlong)
    dp = ctypes.POINTER(ctypes.c_double)
    try:
        lib.ddsk_wire_abi_version.restype = ctypes.c_int
        lib.ddsk_wire_abi_version.argtypes = []
        lib.ddsk_wire_scan_dense.restype = i64
        lib.ddsk_wire_scan_dense.argtypes = [
            ctypes.c_char_p, i64, i64p,      # buf, n, offsets
            ctypes.c_char_p, i64,            # prefix, prefix_len
            i64,                             # base
            u8p, dp, i64p, i64p, i64p, dp,   # status, zc, pos, len, j0, out
        ]
        # The SketchPayload envelope scanners (backends.wirefmt).
        lib.ddsk_wire_scan_envelope.restype = i64
        lib.ddsk_wire_scan_envelope.argtypes = [
            ctypes.c_char_p, i64, i64p,      # buf, n, offsets
            i64,                             # expected_backend
            u8p, i64p, i64p, i64p,           # status, level, dense off/len
        ]
        lib.ddsk_wire_scan_moment.restype = i64
        lib.ddsk_wire_scan_moment.argtypes = [
            ctypes.c_char_p, i64, i64p,      # buf, n, offsets
            i64, i64,                        # expected_backend, k
            u8p, dp, dp, dp,                 # status, scalars, powers, logs
        ]
    except AttributeError:
        return False
    return lib.ddsk_wire_abi_version() == WIRE_ABI_VERSION


def available() -> bool:
    """True iff the native engine builds and loads on this machine."""
    return _load() is not None


def wire_scanner() -> typing.Optional[ctypes.CDLL]:
    """The library handle with a wire scanner of this module's ABI, or
    ``None`` (never raises): no toolchain, ``SKETCHES_TPU_NATIVE=0``, or a
    library of another wire ABI.  Callers then decode through the
    pure-Python walker, bit-identically; ``status()["wire"]`` says which."""
    if _load() is None:
        return None
    return _lib if _wire_ok else None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


_MAPPING_KINDS = {
    "logarithmic": 0,
    "linear_interpolated": 1,
    "cubic_interpolated": 2,
    "quadratic_interpolated": 3,
}


class NativeDDSketch:
    """Reference-shaped single sketch backed by the C++ engine.

    Same static-window semantics as the device tier: keys clamp into
    ``[key_offset, key_offset + n_bins)``; ``add_batch`` is the fast path.
    All four mappings are supported (the engine keys values with the
    mappings' scalar path).  Raises ``EngineUnavailable`` when the engine
    cannot be loaded and ``SpecError`` for an unknown mapping or invalid
    parameters.
    """

    def __init__(
        self,
        relative_accuracy: float = 0.01,
        n_bins: int = 2048,
        key_offset: typing.Optional[int] = None,
        mapping: str = "logarithmic",
    ):
        lib = _load()
        if lib is None:
            raise EngineUnavailable(f"native engine unavailable: {_status['reason']}")
        if key_offset is None:
            key_offset = -(n_bins // 2)
        if mapping not in _MAPPING_KINDS:
            raise SpecError(
                f"Unknown mapping {mapping!r}; expected one of {sorted(_MAPPING_KINDS)}"
            )
        self._lib = lib
        self._handle = lib.sketch_create(
            relative_accuracy, n_bins, key_offset, _MAPPING_KINDS[mapping]
        )
        if not self._handle:
            raise SpecError("invalid sketch parameters")
        self.relative_accuracy = relative_accuracy
        self.n_bins = n_bins
        self.key_offset = key_offset
        self.mapping = mapping
        mantissa = 2.0 * relative_accuracy / (1.0 - relative_accuracy)
        self.gamma = 1.0 + mantissa

    def __del__(self):
        # A constructor failure can leave _handle and _lib unset.
        handle = getattr(self, "_handle", None)
        lib = getattr(self, "_lib", None)
        if handle and lib is not None:
            lib.sketch_destroy(handle)
            self._handle = None

    # -- core API ----------------------------------------------------------
    def add(self, val: float, weight: float = 1.0) -> None:
        if weight <= 0.0:
            raise SketchValueError("weight must be positive")
        self._lib.sketch_add(self._handle, float(val), float(weight))

    def add_batch(
        self,
        values: np.ndarray,
        weights: typing.Optional[np.ndarray] = None,
    ) -> "NativeDDSketch":
        values = np.ascontiguousarray(values, dtype=np.float64).ravel()
        wptr = None
        if weights is not None:
            weights = np.ascontiguousarray(weights, dtype=np.float64).ravel()
            if weights.shape != values.shape:
                raise SketchValueError("weights shape must match values")
            wptr = _dptr(weights)
        self._lib.sketch_add_batch(self._handle, _dptr(values), wptr, values.size)
        return self

    def get_quantile_value(self, quantile: float) -> typing.Optional[float]:
        out = self._lib.sketch_quantile(self._handle, float(quantile))
        return None if math.isnan(out) else out

    def merge(self, other: "NativeDDSketch") -> None:
        if not self.mergeable(other):
            raise UnequalSketchParametersError(
                "Cannot merge native sketches with different parameters"
            )
        if self._lib.sketch_merge(self._handle, other._handle) != 0:
            raise UnequalSketchParametersError("Incompatible native sketches")

    def mergeable(self, other: "NativeDDSketch") -> bool:
        # Mapping identity, not just gamma: the mappings share gamma at
        # equal alpha but key values differently.
        return (
            self.gamma == other.gamma
            and self.n_bins == other.n_bins
            and self.key_offset == other.key_offset
            and self.mapping == other.mapping
        )

    # -- accessors ---------------------------------------------------------
    def _counters(self) -> np.ndarray:
        out = np.empty(7, np.float64)
        self._lib.sketch_counters(self._handle, _dptr(out))
        return out

    @property
    def zero_count(self) -> float:
        return float(self._counters()[0])

    @property
    def count(self) -> float:
        return float(self._counters()[1])

    num_values = count

    @property
    def sum(self) -> float:  # noqa: A003 - reference API name
        return float(self._counters()[2])

    @property
    def avg(self) -> float:
        c = self._counters()
        return float(c[2] / c[1])

    @property
    def collapsed_low(self) -> float:
        return float(self._counters()[5])

    @property
    def collapsed_high(self) -> float:
        return float(self._counters()[6])

    def bins(self) -> typing.Tuple[np.ndarray, np.ndarray]:
        pos = np.empty(self.n_bins, np.float64)
        neg = np.empty(self.n_bins, np.float64)
        self._lib.sketch_bins(self._handle, _dptr(pos), _dptr(neg))
        return pos, neg

    # -- device interop ----------------------------------------------------
    def to_state(self, device=None):
        """Lift into a 1-stream f32 batched state on ``device`` (the card by
        default), with this sketch's window."""
        from sketches_tpu_torch.batched import (
            SketchState,
            occupied_bounds_np,
            resolve_device,
            tile_sums_np,
        )

        dev = resolve_device(device)
        pos, neg = self.bins()
        c = self._counters()
        (pos_lo, pos_hi), (neg_lo, neg_hi) = occupied_bounds_np(pos), occupied_bounds_np(neg)

        def f32(x):
            return torch.from_numpy(np.atleast_1d(np.asarray(x, np.float32))).to(dev)

        def i32(x):
            return torch.tensor([int(x)], dtype=torch.int32, device=dev)

        return SketchState(
            bins_pos=f32(pos[None]),
            bins_neg=f32(neg[None]),
            zero_count=f32(c[0]),
            count=f32(c[1]),
            sum=f32(c[2]),
            min=f32(c[3]),
            max=f32(c[4]),
            collapsed_low=f32(c[5]),
            collapsed_high=f32(c[6]),
            key_offset=i32(self.key_offset),
            pos_lo=i32(pos_lo),
            pos_hi=i32(pos_hi),
            neg_lo=i32(neg_lo),
            neg_hi=i32(neg_hi),
            neg_total=f32(neg.sum()),
            tile_sums=f32(tile_sums_np(pos[None], neg[None])),
        )

    @classmethod
    def from_state(cls, spec, state, stream: int = 0) -> "NativeDDSketch":
        """Extract one stream of a batched state into a native sketch (one
        host copy of that stream's leaves).  The native sketch adopts the
        stream's own window offset."""
        row = {
            f: getattr(state, f)[stream].cpu().numpy()
            for f in ("bins_pos", "bins_neg", "zero_count", "count", "sum", "min", "max",
                      "collapsed_low", "collapsed_high", "key_offset")
        }
        sk = cls(
            spec.relative_accuracy,
            spec.n_bins,
            int(row["key_offset"]),
            mapping=spec.mapping_name,
        )
        counters = np.asarray(
            [row[f] for f in ("zero_count", "count", "sum", "min", "max",
                              "collapsed_low", "collapsed_high")],
            np.float64,
        )
        pos = np.ascontiguousarray(row["bins_pos"], np.float64)
        neg = np.ascontiguousarray(row["bins_neg"], np.float64)
        sk._lib.sketch_load_bins(sk._handle, _dptr(pos), _dptr(neg), _dptr(counters))
        return sk
