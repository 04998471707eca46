// Tile-list multi-quantile query: hierarchical rank selection.
//
// Replaces sketches_tpu/kernels.py:_tiles_kernel and _count_and_decode (the
// Pallas bodies behind fused_quantile_tiles).  The caller locates each
// (stream, q)'s crossing tile from the state's per-tile masses alone
// (kernels._tile_targets) and packs, per stream:
//   thr_adj[Q] | utile[Q] | zflag[Q] | nanflag[Q] | key_offset | pos_lo |
//   pos_hi | neg_lo | neg_hi
// utile is the tile id in [0, 2T) (negative-store tiles offset by T) and
// thr_adj the rank threshold inside that tile.  The kernel reads that one
// 128-bin tile, scans it, counts #(cum <= thr) on the positive store or
// #(cum < thr) on the negative one, and emits the final value: index
// tile*128 + count clipped into the exact occupied bounds, decoded, signed,
// with the zero bucket and NaN (empty stream, q outside [0, 1]) applied.
//
// The TPU walked a per-block sorted list of needed tiles because its DMAs
// are scheduled per BlockSpec; a warp simply loads the tile it needs, so no
// list is built.  Zero-bucket and NaN outputs read no tile at all.
//
// What bounds it on an H100: bytes -- at most one 512-byte tile per live
// (stream, q) plus the packed row.  One warp owns one stream; each tile is
// one coalesced float4 per lane, scanned in registers and across the warp
// with shuffles, counted with ballots.  Lane q keeps quantile q's count.
#include <cuda_runtime.h>

#include "mapping.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// The final value of one (stream, q): index tile*128 + count clipped into
// the store's exact occupied bounds, decoded and signed; zero bucket and
// NaN applied last (_count_and_decode).
template <int MAP, bool WITH_NEG>
__device__ __forceinline__ float finish(float ut, int cnt, float zflag,
                                        float nanflag, float koff,
                                        float first_pos, float last_pos,
                                        float first_neg, float last_neg,
                                        int n_tiles, const sk::Consts& k) {
  const bool is_neg = ut >= (float)n_tiles;
  const float tile_f = ut - (is_neg ? (float)n_tiles : 0.0f);
  const float idx = tile_f * 128.0f + (float)cnt;
  float val;
  if (WITH_NEG) {
    const float first = is_neg ? first_neg : first_pos;
    const float last = is_neg ? last_neg : last_pos;
    const float sign = is_neg ? -1.0f : 1.0f;
    const float key = fminf(fmaxf(idx, first), last) + koff;
    val = sign * sk::value_of<MAP>(__float2int_rz(key), k);
  } else {
    const float key = fminf(fmaxf(idx, first_pos), last_pos) + koff;
    val = sk::value_of<MAP>(__float2int_rz(key), k);
  }
  if (zflag > 0.5f) val = 0.0f;
  if (nanflag > 0.5f) val = __int_as_float(0x7fc00000);
  return val;
}

template <int MAP, bool WITH_NEG>
__global__ void tiles_kernel(const float* __restrict__ bins_pos,
                             const float* __restrict__ bins_neg,
                             const float* __restrict__ packed,
                             float* __restrict__ out,
                             const float* __restrict__ consts, int n,
                             int n_bins, int q_total, int pk_width) {
  const int lane = threadIdx.x % sk::kLanes;
  const long row = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / sk::kLanes;
  if (row >= n) return;
  const sk::Consts k = sk::load_consts(consts);
  const int n_tiles = n_bins / sk::kTile;
  const float* pk = packed + row * (long)pk_width;
  const int base = 4 * q_total;
  const float koff = pk[base];
  const float first_pos = pk[base + 1];
  const float last_pos = fmaxf(pk[base + 2], first_pos);
  const float first_neg = pk[base + 3];
  const float last_neg = fmaxf(pk[base + 4], first_neg);

  for (int g = 0; g < q_total; g += sk::kLanes) {
    const int q = g + lane;
    const bool has_q = q < q_total;
    const int nq = min(sk::kLanes, q_total - g);
    const float thr = has_q ? pk[q] : 0.0f;
    const float ut = has_q ? pk[q_total + q] : 0.0f;
    const float zflag = has_q ? pk[2 * q_total + q] : 0.0f;
    const float nanflag = has_q ? pk[3 * q_total + q] : 0.0f;

    int my_cnt = 0;
    for (int j = 0; j < nq; ++j) {
      // Quantile j's plan, broadcast from lane j: the loop stays uniform.
      if (__shfl_sync(sk::kFull, zflag, j) > 0.5f ||
          __shfl_sync(sk::kFull, nanflag, j) > 0.5f) {
        continue;  // the output ignores the tile
      }
      const int u = __float2int_rz(__shfl_sync(sk::kFull, ut, j));
      const float thr_j = __shfl_sync(sk::kFull, thr, j);
      const bool neg = u >= n_tiles;
      const int tile = neg ? u - n_tiles : u;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!neg || WITH_NEG) {
        const float* src = (neg ? bins_neg : bins_pos) + row * (long)n_bins +
                           tile * sk::kTile;
        x = reinterpret_cast<const float4*>(src)[lane];
      }
      float cum[4];
      float total;
      sk::tile_scan(x, 0.0f, cum, total);
      const int c = sk::count_le(cum, thr_j, neg);
      if (lane == j) my_cnt = c;
    }

    if (has_q) {
      out[row * (long)q_total + q] = finish<MAP, WITH_NEG>(
          ut, my_cnt, zflag, nanflag, koff, first_pos, last_pos, first_neg,
          last_neg, n_tiles, k);
    }
  }
}

template <int MAP, bool WITH_NEG>
int launch(const float* bins_pos, const float* bins_neg, const float* packed,
           float* out, const float* consts, int n, int n_bins, int q_total,
           int pk_width, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  tiles_kernel<MAP, WITH_NEG><<<blocks, kRowsPerBlock * sk::kLanes, 0, stream>>>(
      bins_pos, bins_neg, packed, out, consts, n, n_bins, q_total, pk_width);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).
// bins_neg == nullptr: the negative store is certified empty and not read.
extern "C" int sk_tiles(const float* bins_pos, const float* bins_neg,
                        const float* packed, float* out, const float* consts,
                        int mapping, int n, int n_bins, int q_total,
                        int pk_width, void* stream) {
  if (n <= 0 || q_total <= 0) return 0;
  if (n_bins % sk::kTile != 0 || pk_width < 4 * q_total + 5) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bins_neg == nullptr) {
    SK_DISPATCH_MAPPING(mapping, return launch<MAP, false>(
        bins_pos, bins_neg, packed, out, consts, n, n_bins, q_total, pk_width,
        st));
  }
  SK_DISPATCH_MAPPING(mapping, return launch<MAP, true>(
      bins_pos, bins_neg, packed, out, consts, n, n_bins, q_total, pk_width,
      st));
  return 0;
}
