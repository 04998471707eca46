// Final value of one (stream, q) of the tile-list queries, shared by the
// tile kernel (tiles.cu) and the overlap kernel (overlap.cu).
//
// Replaces the decode half of sketches_tpu/kernels.py:_count_and_decode:
// index tile*128 + count clipped into the store's exact occupied bounds,
// decoded and signed; the zero bucket and NaN (empty stream, q outside
// [0, 1]) applied last.  `ut` is the unified tile id in [0, 2T), negative-
// store tiles offset by T; every operand but the count comes from the
// packed per-stream row (kernels._pack_tile_operand).
#pragma once

#include "mapping.cuh"

namespace sk {

template <int MAP, bool WITH_NEG>
__device__ __forceinline__ float tile_finish(float ut, int cnt, float zflag,
                                             float nanflag, float koff,
                                             float first_pos, float last_pos,
                                             float first_neg, float last_neg,
                                             int n_tiles, const Consts& k) {
  const bool is_neg = ut >= (float)n_tiles;
  const float tile_f = ut - (is_neg ? (float)n_tiles : 0.0f);
  const float idx = tile_f * 128.0f + (float)cnt;
  float val;
  if (WITH_NEG) {
    const float first = is_neg ? first_neg : first_pos;
    const float last = is_neg ? last_neg : last_pos;
    const float sign = is_neg ? -1.0f : 1.0f;
    const float key = fminf(fmaxf(idx, first), last) + koff;
    val = sign * value_of<MAP>(__float2int_rz(key), k);
  } else {
    const float key = fminf(fmaxf(idx, first_pos), last_pos) + koff;
    val = value_of<MAP>(__float2int_rz(key), k);
  }
  if (zflag > 0.5f) val = 0.0f;
  if (nanflag > 0.5f) val = __int_as_float(0x7fc00000);
  return val;
}

}  // namespace sk
