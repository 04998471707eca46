"""Key mappings: value <-> bucket-index contracts for DDSketch (PyTorch port).

Counterpart of ``sketches_tpu/mapping.py``.  Every mapping has the same two
paths as there:

* scalar path (``key`` / ``value``) -- pure ``math``, copied as is;
* array path (``key_array`` / ``value_array``) -- elementwise torch ops that
  repeat the JAX array path op for op, so keys agree bit for bit.

Three rules keep the array path's rounding identical to the JAX package's
and to the CUDA kernels' (``csrc/mapping.cuh``):

* every Python-float constant is rounded to f32 first (``_f32``), which is
  what JAX's weak typing does to it;
* a division by the multiplier divides by a tensor on the operand's own
  device: PyTorch's CUDA ``div`` by a host scalar multiplies by the
  reciprocal instead, which rounds differently;
* float -> int32 casts saturate and send NaN to 0 (``_f32_to_i32``), as XLA
  and CUDA's ``cvt.rzi`` do; a plain ``Tensor.to(torch.int32)`` on the CPU
  sends every out-of-range value to INT_MIN.
"""

from __future__ import annotations

import functools
import math
import sys

import numpy as np
import torch

from sketches_tpu_torch.resilience import SpecError

__all__ = [
    "KeyMapping",
    "LogarithmicMapping",
    "LinearlyInterpolatedMapping",
    "QuadraticallyInterpolatedMapping",
    "CubicallyInterpolatedMapping",
    "mapping_from_name",
    "zero_threshold",
]

_NEWTON_ITERS = 5
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def zero_threshold(dtype=torch.float32) -> float:
    """|v| below this lands in the zero bucket: the smallest positive normal
    of ``dtype`` (a torch or numpy float dtype)."""
    if isinstance(dtype, torch.dtype):
        return float(torch.finfo(dtype).tiny)
    return float(np.finfo(np.dtype(dtype)).tiny)


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float (exact in f32)."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=256)
def _dev_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-dim f32 tensor holding ``value`` on ``device`` (cached)."""
    return torch.tensor(np.float32(value), device=device)


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating f32 -> int32 cast with NaN -> 0 (XLA's and CUDA's rule)."""
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    bad = hi | lo | torch.isnan(x)
    out = torch.where(bad, torch.zeros_like(x), x).to(torch.int32)
    out = torch.where(hi, torch.full_like(out, _INT32_MAX), out)
    return torch.where(lo, torch.full_like(out, _INT32_MIN), out)


def _frexp_array(value: torch.Tensor):
    """(mantissa in [0.5, 1), exponent as f32) with v = m * 2**e, by int32
    bit views of f32 -- ``mapping._frexp_array`` for f32.  Subnormal inputs
    are pre-scaled by 2**23 and the exponent corrected back.  ``value``
    must be positive."""
    v = value.to(torch.float32)
    bits0 = v.view(torch.int32)
    is_sub = (bits0 >> 23) == 0
    scaled = torch.where(is_sub, v * 8388608.0, v)
    bits = scaled.view(torch.int32)
    biased = (bits >> 23) & 0xFF
    m = ((bits & 0x7FFFFF) | (126 << 23)).view(torch.float32)
    e = biased - 126 - torch.where(is_sub, 23, 0).to(torch.int32)
    return m, e.to(torch.float32)


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """2.0**e built in the f32 exponent field, for e in [-126, 127]."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _ldexp_array(m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """m * 2**e as two power-of-two factors (``mapping._ldexp_array``)."""
    e = _f32_to_i32(e)
    a = torch.clamp(e, -126, 127)
    b = torch.clamp(e - a, -126, 127)
    return m * _exp2i(a) * _exp2i(b)


class KeyMapping:
    """Abstract value<->key contract (see ``sketches_tpu.mapping.KeyMapping``).

    gamma = (1 + alpha) / (1 - alpha); bucket k covers (gamma^(k-1), gamma^k]
    modulo the subclass's log approximation.  ``relative_accuracy`` outside
    (0, 1) raises ``SpecError``.
    """

    #: Mapping id the CUDA kernels are templated on (``csrc/mapping.cuh``).
    kernel_id = -1

    def __init__(self, relative_accuracy: float, offset: float = 0.0):
        if relative_accuracy <= 0 or relative_accuracy >= 1:
            raise SpecError("Relative accuracy must be between 0 and 1.")
        self.relative_accuracy = float(relative_accuracy)
        self._offset = float(offset)
        gamma_mantissa = 2.0 * relative_accuracy / (1.0 - relative_accuracy)
        self.gamma = 1.0 + gamma_mantissa
        self._multiplier = 1.0 / math.log1p(gamma_mantissa)
        self.min_possible = sys.float_info.min * self.gamma
        self.max_possible = sys.float_info.max / self.gamma

    # -- subclass hooks ---------------------------------------------------
    def _log_gamma(self, value: float) -> float:
        raise NotImplementedError

    def _pow_gamma(self, value: float) -> float:
        raise NotImplementedError

    def _log_gamma_array(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _pow_gamma_array(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- scalar path ------------------------------------------------------
    def key(self, value: float) -> int:
        """Integer bucket key for ``value`` (value > 0)."""
        return int(math.ceil(self._log_gamma(value)) + self._offset)

    def value(self, key: int) -> float:
        """Representative value of bucket ``key``."""
        return self._pow_gamma(key - self._offset) * (2.0 / (1.0 + self.gamma))

    # -- array path -------------------------------------------------------
    def key_array(self, value: torch.Tensor) -> torch.Tensor:
        """Elementwise ``key`` for a tensor of positive f32 values -> int32."""
        keys = _f32_to_i32(torch.ceil(self._log_gamma_array(value)))
        return keys + int(round(self._offset))

    def _div_multiplier(self, x: torch.Tensor) -> torch.Tensor:
        return x / _dev_scalar(_f32(self._multiplier), x.device)

    def _scaled_pow_gamma_array(self, k: torch.Tensor) -> torch.Tensor:
        return self._pow_gamma_array(k) * _f32(2.0 / (1.0 + self.gamma))

    def value_array(self, key: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """Elementwise ``value`` for an int tensor of keys, saturating into
        the positive finite range of ``dtype`` (f32 only)."""
        if dtype != torch.float32:
            raise SpecError("the array path runs in float32 only")
        k = key.to(torch.float32) - _f32(self._offset)
        raw = self._scaled_pow_gamma_array(k)
        fin = torch.finfo(torch.float32)
        return torch.clamp(raw, fin.tiny, fin.max)

    def kernel_constants(self) -> np.ndarray:
        """The f32 constants the CUDA mapping functions read, in the layout
        of ``csrc/mapping.cuh``: multiplier, 1/multiplier, log of the
        midpoint scale, the midpoint scale, 1/3, the cubic's A, B, C, then
        the cubic inverse's eleven Horner coefficients c0..c10."""
        cub = CubicallyInterpolatedMapping
        return np.array(
            [
                self._multiplier,
                1.0 / self._multiplier,
                math.log(2.0 / (1.0 + self.gamma)),
                2.0 / (1.0 + self.gamma),
                1.0 / 3.0,
                cub.A,
                cub.B,
                cub.C,
                *cub._INV_POLY,
            ],
            np.float32,
        )

    # -- equality / identity ----------------------------------------------
    def __eq__(self, other: object) -> bool:
        return (
            type(self) is type(other)
            and self.gamma == other.gamma  # type: ignore[attr-defined]
            and self._offset == other._offset  # type: ignore[attr-defined]
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.gamma, self._offset))

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(relative_accuracy={self.relative_accuracy},"
            f" offset={self._offset})"
        )


class LogarithmicMapping(KeyMapping):
    """Exact ``ln(v) / ln(gamma)`` mapping -- one log per key."""

    kernel_id = 0

    def _log_gamma(self, value: float) -> float:
        return math.log(value) * self._multiplier

    def _pow_gamma(self, value: float) -> float:
        return math.exp(value / self._multiplier)

    def _log_gamma_array(self, value):
        return torch.log(value) * _f32(self._multiplier)

    def _pow_gamma_array(self, value):
        return torch.exp(self._div_multiplier(value))

    def _scaled_pow_gamma_array(self, k):
        # The midpoint scale rides in the exponent, as in the JAX package:
        # exp(k/m) alone can overflow f32 where the scaled value does not.
        return torch.exp(
            self._div_multiplier(k) + _f32(math.log(2.0 / (1.0 + self.gamma)))
        )


class LinearlyInterpolatedMapping(KeyMapping):
    """Linear interpolation of log2 between powers of two (no
    transcendentals); the base multiplier stays 1/ln(gamma)."""

    kernel_id = 1

    def _log2_approx(self, value: float) -> float:
        mantissa, exponent = math.frexp(value)
        significand = 2.0 * mantissa - 1.0
        return significand + (exponent - 1)

    def _exp2_approx(self, value: float) -> float:
        exponent = math.floor(value)
        mantissa = (value - exponent + 1.0) / 2.0
        return math.ldexp(mantissa, exponent + 1)

    def _log_gamma(self, value: float) -> float:
        return self._log2_approx(value) * self._multiplier

    def _pow_gamma(self, value: float) -> float:
        return self._exp2_approx(value / self._multiplier)

    def _log_gamma_array(self, value):
        m, e = _frexp_array(value)
        return (2.0 * m - 1.0 + (e - 1.0)) * _f32(self._multiplier)

    def _pow_gamma_array(self, value):
        v = self._div_multiplier(value)
        exponent = torch.floor(v)
        mantissa = (v - exponent + 1.0) / 2.0
        return _ldexp_array(mantissa, exponent + 1.0)


class QuadraticallyInterpolatedMapping(KeyMapping):
    """Quadratic interpolation of log2 on the mantissa: f(s) = s(4 - s)/3,
    base multiplier scaled by 3/4."""

    kernel_id = 2

    def __init__(self, relative_accuracy: float, offset: float = 0.0):
        super().__init__(relative_accuracy, offset=offset)
        self._multiplier *= 3.0 / 4.0

    def _quad_log2(self, value: float) -> float:
        mantissa, exponent = math.frexp(value)
        s = 2.0 * mantissa - 1.0
        return s * (4.0 - s) / 3.0 + (exponent - 1)

    def _quad_exp2(self, value: float) -> float:
        exponent = math.floor(value)
        rem = value - exponent
        s = 2.0 - math.sqrt(4.0 - 3.0 * rem)
        mantissa = (s + 1.0) / 2.0
        return math.ldexp(mantissa, exponent + 1)

    def _log_gamma(self, value: float) -> float:
        return self._quad_log2(value) * self._multiplier

    def _pow_gamma(self, value: float) -> float:
        return self._quad_exp2(value / self._multiplier)

    def _log_gamma_array(self, value):
        m, e = _frexp_array(value)
        s = 2.0 * m - 1.0
        return (s * (4.0 - s) * _f32(1.0 / 3.0) + (e - 1.0)) * _f32(
            self._multiplier
        )

    def _pow_gamma_array(self, value):
        v = value * _f32(1.0 / self._multiplier)
        exponent = torch.floor(v)
        rem = v - exponent
        # The root in f64, rounded once to f32: correctly rounded, like
        # XLA's and the card's ``sqrtf``.  torch's CPU f32 ``sqrt`` is an ulp
        # off on about 0.6% of inputs in [1, 4).
        root = torch.sqrt((4.0 - 3.0 * rem).double()).to(rem.dtype)
        s = 2.0 - root
        mantissa = (s + 1.0) / 2.0
        return _ldexp_array(mantissa, exponent + 1.0)


class CubicallyInterpolatedMapping(KeyMapping):
    """Cubic interpolation of log2 on the mantissa, f(s) = ((A s + B) s + C) s;
    base multiplier scaled by 7/10.  The inverse is a degree-10 polynomial
    fit evaluated in Horner order (the JAX package's ``_INV_POLY``)."""

    kernel_id = 3
    A = 6.0 / 35.0
    B = -3.0 / 5.0
    C = 10.0 / 7.0
    _INV_POLY = (
        1.5301690381945424e-08, 0.6999976348028631, 0.20588848839053578,
        0.07844588954523869, 0.04020218967609133, -0.052134266801743476,
        0.17317966277481212, -0.3446662420947769, 0.39503167560256974,
        -0.2716945359330847, 0.07574953979095508,
    )

    def __init__(self, relative_accuracy: float, offset: float = 0.0):
        super().__init__(relative_accuracy, offset=offset)
        self._multiplier *= 7.0 / 10.0

    @classmethod
    def _cubic(cls, s):
        return ((cls.A * s + cls.B) * s + cls.C) * s

    @classmethod
    def _cubic_deriv(cls, s):
        return (3.0 * cls.A * s + 2.0 * cls.B) * s + cls.C

    def _cubic_log2(self, value: float) -> float:
        mantissa, exponent = math.frexp(value)
        return self._cubic(2.0 * mantissa - 1.0) + (exponent - 1)

    def _cubic_exp2(self, value: float) -> float:
        exponent = math.floor(value)
        rem = value - exponent
        s = rem
        for _ in range(_NEWTON_ITERS):
            s = s - (self._cubic(s) - rem) / self._cubic_deriv(s)
        mantissa = (s + 1.0) / 2.0
        return math.ldexp(mantissa, exponent + 1)

    def _log_gamma(self, value: float) -> float:
        return self._cubic_log2(value) * self._multiplier

    def _pow_gamma(self, value: float) -> float:
        return self._cubic_exp2(value / self._multiplier)

    def _log_gamma_array(self, value):
        m, e = _frexp_array(value)
        s = 2.0 * m - 1.0
        cubic = ((_f32(self.A) * s + _f32(self.B)) * s + _f32(self.C)) * s
        return (cubic + (e - 1.0)) * _f32(self._multiplier)

    def _pow_gamma_array(self, value):
        v = value * _f32(1.0 / self._multiplier)
        exponent = torch.floor(v)
        rem = v - exponent
        s = torch.full_like(rem, _f32(self._INV_POLY[-1]))
        for c in self._INV_POLY[-2::-1]:
            s = s * rem + _f32(c)
        mantissa = (s + 1.0) / 2.0
        return _ldexp_array(mantissa, exponent + 1.0)


_MAPPING_REGISTRY = {
    "logarithmic": LogarithmicMapping,
    "linear_interpolated": LinearlyInterpolatedMapping,
    "quadratic_interpolated": QuadraticallyInterpolatedMapping,
    "cubic_interpolated": CubicallyInterpolatedMapping,
}


def mapping_from_name(name: str, relative_accuracy: float, offset: float = 0.0) -> KeyMapping:
    """Instantiate a mapping by registry name."""
    try:
        cls = _MAPPING_REGISTRY[name]
    except KeyError:
        raise SpecError(
            f"Unknown mapping {name!r}; expected one of {sorted(_MAPPING_REGISTRY)}"
        ) from None
    return cls(relative_accuracy, offset=offset)
