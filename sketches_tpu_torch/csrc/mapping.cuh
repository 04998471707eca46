// Key and value functions of the four DDSketch mappings, for the kernels.
//
// Device mirror of sketches_tpu_torch/mapping.py (itself the op-for-op port
// of sketches_tpu/mapping.py:118-150, 188-200, 300-476).  Every expression
// keeps the reference's operation order so each rounding step is the same:
//   * logf/expf/floorf/ceilf/sqrtf, never the __logf/__expf intrinsics;
//   * bit views through __float_as_int/__int_as_float;
//   * saturating float->int casts (__float2int_rz: NaN -> 0), as XLA does;
//   * the decode saturates into [FLT_MIN, FLT_MAX].
// The build passes -fmad=false and neither --use_fast_math nor -ftz=true:
// a contracted a*b+c or a flushed subnormal would round differently from
// the plain PyTorch version and from the JAX reference.
//
// The f32 constants arrive in one device array, laid out by
// KeyMapping.kernel_constants():
//   [0] multiplier  [1] 1/multiplier  [2] log(2/(1+gamma))  [3] 2/(1+gamma)
//   [4] 1/3  [5] A  [6] B  [7] C (cubic)  [8..18] cubic inverse, c0..c10
#pragma once

#include <cfloat>
#include <cstdint>

namespace sk {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 128;       // bins per column tile (TILE in batched.py)
constexpr int kNumConsts = 19;

enum Mapping : int { kLog = 0, kLinear = 1, kQuadratic = 2, kCubic = 3 };

struct Consts {
  float c[kNumConsts];
};

__device__ __forceinline__ Consts load_consts(const float* __restrict__ p) {
  Consts k;
#pragma unroll
  for (int i = 0; i < kNumConsts; ++i) k.c[i] = p[i];
  return k;
}

// mapping.py _frexp_array: v = m * 2**e with m in [0.5, 1), v > 0.
__device__ __forceinline__ void frexp_bits(float v, float& m, float& e) {
  const int bits0 = __float_as_int(v);
  const bool is_sub = (bits0 >> 23) == 0;
  const float scaled = is_sub ? v * 8388608.0f : v;
  const int bits = __float_as_int(scaled);
  const int biased = (bits >> 23) & 0xFF;
  m = __int_as_float((bits & 0x7FFFFF) | (126 << 23));
  e = (float)(biased - 126 - (is_sub ? 23 : 0));
}

// 2**e built in the exponent field, e in [-126, 127].
__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// mapping.py _ldexp_array: m * 2**e as two power-of-two factors.
__device__ __forceinline__ float ldexp_bits(float m, float e) {
  const int ei = __float2int_rz(e);
  const int a = min(max(ei, -126), 127);
  const int b = min(max(ei - a, -126), 127);
  return m * exp2i(a) * exp2i(b);
}

// _log_gamma_array of each mapping.
template <int MAP>
__device__ __forceinline__ float log_gamma(float a, const Consts& k) {
  if (MAP == kLog) {
    return logf(a) * k.c[0];
  }
  float m, e;
  frexp_bits(a, m, e);
  if (MAP == kLinear) {
    return (2.0f * m - 1.0f + (e - 1.0f)) * k.c[0];
  }
  const float s = 2.0f * m - 1.0f;
  if (MAP == kQuadratic) {
    return (s * (4.0f - s) * k.c[4] + (e - 1.0f)) * k.c[0];
  }
  const float cubic = ((k.c[5] * s + k.c[6]) * s + k.c[7]) * s;
  return (cubic + (e - 1.0f)) * k.c[0];
}

// key_array: ceil(log_gamma(a)) as int32 (mapping offset is always 0 here).
template <int MAP>
__device__ __forceinline__ int key_of(float a, const Consts& k) {
  return __float2int_rz(ceilf(log_gamma<MAP>(a, k)));
}

// value_array: representative value of bucket `key`, saturated into f32.
template <int MAP>
__device__ __forceinline__ float value_of(int key, const Consts& k) {
  const float kf = (float)key;
  float raw;
  if (MAP == kLog) {
    raw = expf(kf / k.c[0] + k.c[2]);
  } else if (MAP == kLinear) {
    const float v = kf / k.c[0];
    const float ex = floorf(v);
    const float mant = (v - ex + 1.0f) / 2.0f;
    raw = ldexp_bits(mant, ex + 1.0f) * k.c[3];
  } else if (MAP == kQuadratic) {
    const float v = kf * k.c[1];
    const float ex = floorf(v);
    const float rem = v - ex;
    const float s = 2.0f - sqrtf(4.0f - 3.0f * rem);
    const float mant = (s + 1.0f) / 2.0f;
    raw = ldexp_bits(mant, ex + 1.0f) * k.c[3];
  } else {
    const float v = kf * k.c[1];
    const float ex = floorf(v);
    const float rem = v - ex;
    float s = k.c[18];
#pragma unroll
    for (int i = 17; i >= 8; --i) s = s * rem + k.c[i];
    const float mant = (s + 1.0f) / 2.0f;
    raw = ldexp_bits(mant, ex + 1.0f) * k.c[3];
  }
  return fminf(fmaxf(raw, FLT_MIN), FLT_MAX);
}

// Inclusive prefix sums of one 128-bin tile held as one float4 per lane:
// returns the four running sums of this lane's bins, offset by `carry` and
// by every lower lane's total; `tile_total` gets the tile's sum.
__device__ __forceinline__ void tile_scan(float4 x, float carry, float cum[4],
                                          float& tile_total) {
  const int lane = threadIdx.x & (kLanes - 1);
  const float c0 = x.x;
  const float c1 = c0 + x.y;
  const float c2 = c1 + x.z;
  const float c3 = c2 + x.w;
  float incl = c3;
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float base = carry + excl;
  cum[0] = base + c0;
  cum[1] = base + c1;
  cum[2] = base + c2;
  cum[3] = base + c3;
  tile_total = __shfl_sync(kFull, incl, kLanes - 1);
}

// Number of bins of the tile whose running sum is <= thr (strict: < thr).
__device__ __forceinline__ int count_le(const float cum[4], float thr,
                                        bool strict) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool hit = strict ? (cum[j] < thr) : (cum[j] <= thr);
    n += __popc(__ballot_sync(kFull, hit));
  }
  return n;
}

}  // namespace sk

// Dispatch a templated launch over the runtime mapping id.
#define SK_DISPATCH_MAPPING(map, ...)                       \
  switch (map) {                                            \
    case sk::kLog: { constexpr int MAP = sk::kLog; __VA_ARGS__; break; }             \
    case sk::kLinear: { constexpr int MAP = sk::kLinear; __VA_ARGS__; break; }       \
    case sk::kQuadratic: { constexpr int MAP = sk::kQuadratic; __VA_ARGS__; break; } \
    case sk::kCubic: { constexpr int MAP = sk::kCubic; __VA_ARGS__; break; }         \
    default: return (int)cudaErrorInvalidValue;             \
  }
