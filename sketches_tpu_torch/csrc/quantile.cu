// Full-window multi-quantile query.
//
// Replaces sketches_tpu/kernels.py:_quantile_kernel and _select_quantiles
// (the Pallas body behind fused_quantile): for every stream, the prefix sum
// of each whole store, the first and last occupied bin of each store taken
// from the bins themselves (not from the state's pos_lo/pos_hi; an empty
// store gives (n_bins, -1)), the negative store's total as its last
// running sum, then per quantile
//   rank     = q * (count - 1)
//   idx_neg  = #(cum_neg <  (neg_count - 1 - rank) + 1)
//   idx_pos  = #(cum_pos <= rank - zero_count - neg_count)
// clipped into the occupied bounds, decoded (an empty store's clip
// saturates in value_of and is discarded by the select), and the three-way
// select negative / zero / positive, NaN for count <= 0 or q outside [0, 1].
// Each expression keeps the reference's operation order.  For
// integer-valued bins below 2**24 the f32 running sums are exact in any
// scan order, so unit-weight answers match the plain version bucket for
// bucket.
//
// What bounds it on an H100: bytes -- both stores read whole, 8 * n_bins
// bytes a stream (4.3 GB at 1M x 512).  The work a bin costs is one scan
// step and one compare per quantile.
//
// Design (warp-specialized, persistent; the machinery of overlap.cu):
//   * Slots: a slot holds R consecutive streams of each store, the R rows
//     of the negative store then the R rows of the positive one.  R is the
//     fewest rows whose bytes are a multiple of 16 (1 when n_bins % 4 == 0,
//     else 2 or 4), so each store's part is one 16-byte aligned
//     cp.async.bulk copy.  The last slot may hold fewer rows: its bytes
//     past the last multiple of 16 (under 16 a store) are copied with plain
//     loads before the producer arrives.
//   * Ring: a CTA of one producer warp and C consumer warps walks the slots
//     blockIdx.x, + gridDim.x, ... in order; slot i goes to consumer i % C,
//     which owns ring slot i % C, so a ring slot's full and empty phases
//     pass in one warp's order (a ring slot shared by two consumers could
//     let one of them pass a try_wait.parity on the phase before its own).
//     The producer's lane 0 waits for the slot's *empty* mbarrier, arms its
//     *full* mbarrier with the bytes (arrive.expect_tx) and issues the two
//     copies; the consumer waits on *full*, answers the slot's rows from
//     shared memory only and arrives on *empty*, which releases the slot to
//     its next row at once.  C is as many consumers as fit, up to 12: two
//     CTAs an SM at 512 bins (registers bound them), one at 2048 bins
//     (12 slots of 16 KB).  The rows of the SM's other 20-odd consumers
//     are in flight while one warp works; a second slot a consumer (its
//     next row loaded ahead) measured slower at 512 bins and leaves 2048
//     bins fewer consumers (PERF.md): the row's compute, not the loads'
//     latency, is what the warps are short of.
//   * A row, one warp: lane l holds bins 128 t + 4 l + j (a float4 a tile,
//     conflict-free).  Each store is scanned once, four tiles at a time
//     with their shuffle scans interleaved (the arithmetic of
//     sk::tile_scan), and the lane keeps its first and last occupied bin
//     (a 16-bit mask a group); __reduce_min_sync / __reduce_max_sync finish
//     the bounds.  The negative store's scan writes its running sums over
//     its bins; the running sum at bin n_bins - 1 is the negative total, and
//     every threshold follows from it.  The negative running sums are then
//     read back and the positive store is scanned, both counted lane-locally
//     against four quantiles at a time (kQC) as
//     1.0 / 0.0 compares summed in f32; one __reduce_add_sync per (store, quantile)
//     finishes each count, the same set of bins the reference counts.  With
//     more than kQC quantiles the positive running sums are written back too
//     and later chunks read them.
//   * Decode: lane k of a chunk clips its counts, picks negative / zero /
//     positive / NaN and queues (row, q, key) in the warp's 32 entries of
//     shared memory; when they are full the warp decodes 32 answers at once
//     (value_of once a lane rather than once a row).
//   * Wide rows: when fewer than four consumers' slots fit in shared memory
//     (n_bins above about 7,200; 3,600 for widths of 2 mod 4; 1,800 for odd
//     widths) each warp answers rows straight from device memory, each
//     store scanned again for its counts (the running sums cannot be kept).
//   * Exit: every copy completes a full barrier that a consumer waits on,
//     so no bulk copy is in flight when the CTA exits.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "mapping.cuh"

namespace {

constexpr int kGroup = 4;          // tiles a lane scans at once
constexpr int kQC = 4;              // quantiles counted in one pass
constexpr int kConsumers = 12;     // consumer warps of a ring CTA, at most
constexpr int kMinConsumers = 4;   // fewer fit: the wide-row path
constexpr int kWideWarps = 8;      // warps of a wide-row CTA
constexpr long kSmemLimit = 232448;  // usable by one block
constexpr int kPendingBytes = 32 * 16;  // a warp's answers awaiting decode

struct Args {
  const float* bins_pos;
  const float* bins_neg;
  const float* zero_count;
  const float* count;
  const int* key_offset;
  const float* qs;
  float* out;
  const float* consts;
  int n, n_bins, q_total;
  int rows;       // R: streams a slot holds
  int consumers;  // C: consumer warps, one ring slot each
  long n_slots;   // ceil(n / R)
};

struct Plan {
  int rows, consumers;
  long smem;
  bool wide;
};

// Ring geometry of a width: R, C and the dynamic shared memory.  One slot
// (and 32 queued answers) for each consumer warp, as many as fit up to
// kConsumers; fewer than kMinConsumers: wide rows.
Plan plan_of(int n_bins) {
  Plan p;
  p.rows = n_bins % 4 == 0 ? 1 : (n_bins % 2 == 0 ? 2 : 4);
  const long per = 8L * p.rows * n_bins + 16 + kPendingBytes;  // bins, 2 mbarriers
  const long fit = kSmemLimit / per;
  p.consumers = (int)(fit < kConsumers ? fit : kConsumers);
  p.wide = fit < kMinConsumers;
  p.smem = p.consumers * per;
  return p;
}

// This lane's four bins of tile t (zeros past n_bins).  A float4 when rows
// are 16-byte aligned (n_bins % 4 == 0), else four guarded scalars.
__device__ __forceinline__ float4 load_tile(const float* row, int t, int n_bins) {
  const int b0 = t * sk::kTile + 4 * (threadIdx.x % sk::kLanes);
  if ((n_bins & 3) == 0) {
    return b0 < n_bins ? *reinterpret_cast<const float4*>(row + b0)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 x;
  x.x = b0 < n_bins ? row[b0] : 0.0f;
  x.y = b0 + 1 < n_bins ? row[b0 + 1] : 0.0f;
  x.z = b0 + 2 < n_bins ? row[b0 + 2] : 0.0f;
  x.w = b0 + 3 < n_bins ? row[b0 + 3] : 0.0f;
  return x;
}

__device__ __forceinline__ void store_tile(float* row, int t, int n_bins, const float c[4]) {
  const int b0 = t * sk::kTile + 4 * (threadIdx.x % sk::kLanes);
  if ((n_bins & 3) == 0) {
    if (b0 < n_bins) *reinterpret_cast<float4*>(row + b0) = make_float4(c[0], c[1], c[2], c[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (b0 + j < n_bins) row[b0 + j] = c[j];
  }
}

// f32 compares as 1.0 / 0.0 (PTX set.*.f32.f32), summed with FADD: the
// compare is the only integer-pipe instruction a bin and quantile costs.
// NaN passes no compare.  Counts stay below 2**24, so the sums are exact.
__device__ __forceinline__ float lt_one(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a < b ? 1.0f : 0.0f;
#endif
}

__device__ __forceinline__ float le_one(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("set.le.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a <= b ? 1.0f : 0.0f;
#endif
}

// Running sums of kGroup tiles, as sk::tile_scan gives them one tile at a
// time (base = carry + the lower lanes' total; cum = base + the lane's own
// prefix; carry += the tile's total), with the tiles' shuffle scans
// interleaved.
__device__ __forceinline__ void scan_group(const float4 x[kGroup], float& carry,
                                           float cum[kGroup][4]) {
  const int lane = threadIdx.x % sk::kLanes;
  float c[kGroup][4];
  float incl[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    c[i][0] = x[i].x;
    c[i][1] = c[i][0] + x[i].y;
    c[i][2] = c[i][1] + x[i].z;
    c[i][3] = c[i][2] + x[i].w;
    incl[i] = c[i][3];
  }
#pragma unroll
  for (int o = 1; o < sk::kLanes; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float y = __shfl_up_sync(sk::kFull, incl[i], o);
      if (lane >= o) incl[i] += y;
    }
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    float excl = __shfl_up_sync(sk::kFull, incl[i], 1);
    if (lane == 0) excl = 0.0f;
    const float total = __shfl_sync(sk::kFull, incl[i], sk::kLanes - 1);
    const float base = carry + excl;
#pragma unroll
    for (int j = 0; j < 4; ++j) cum[i][j] = base + c[i][j];
    carry += total;
  }
}

// Fold this lane's occupied bins of a group (bins > 0; zeros past n_bins)
// into its (first, last): one 16-bit mask, then its lowest and highest bit.
__device__ __forceinline__ void occupied(const float4 x[kGroup], int t0, int& first,
                                         int& last) {
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    if (x[i].x > 0.0f) m |= 1u << (4 * i);
    if (x[i].y > 0.0f) m |= 2u << (4 * i);
    if (x[i].z > 0.0f) m |= 4u << (4 * i);
    if (x[i].w > 0.0f) m |= 8u << (4 * i);
  }
  if (m != 0u) {
    const int base = t0 * sk::kTile + 4 * (threadIdx.x % sk::kLanes);
    const int lo = __ffs(m) - 1;
    const int hi = 31 - __clz(m);
    first = min(first, base + (lo >> 2) * sk::kTile + (lo & 3));
    last = max(last, base + (hi >> 2) * sk::kTile + (hi & 3));
  }
}

// Add this lane's running sums of one group that pass each threshold.
// Bins past n_bins count nowhere (NaN passes no compare; WHOLE: the group
// has none).
template <bool STRICT, bool WHOLE>
__device__ __forceinline__ void count_group(const float cum[kGroup][4], int t0, int n_bins,
                                            const float thr[kQC], float cnt[kQC]) {
  const int b0 = t0 * sk::kTile + 4 * (threadIdx.x % sk::kLanes);
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = WHOLE || b0 + i * sk::kTile + j < n_bins ? cum[i][j]
                                                               : __int_as_float(0x7fc00000);
#pragma unroll
      for (int k = 0; k < kQC; ++k) cnt[k] += STRICT ? lt_one(v, thr[k]) : le_one(v, thr[k]);
    }
  }
}

template <bool STRICT>
__device__ __forceinline__ void count_any(const float cum[kGroup][4], int t0, int n_bins,
                                          const float thr[kQC], float cnt[kQC]) {
  if ((t0 + kGroup) * sk::kTile <= n_bins) {
    count_group<STRICT, true>(cum, t0, n_bins, thr, cnt);
  } else {
    count_group<STRICT, false>(cum, t0, n_bins, thr, cnt);
  }
}

// The warp's counts of a chunk from the lanes' counts: lane k gets
// quantile k's.  A lane's count is a whole number below 2**22: adding
// 1.5 * 2**23 puts it in the low mantissa bits.
__device__ __forceinline__ int finish_counts(const float cnt[kQC]) {
  const int lane = threadIdx.x % sk::kLanes;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kQC; ++k) {
    const int c = __float_as_int(cnt[k] + 12582912.0f) - 0x4B400000;
    const int r = __reduce_add_sync(sk::kFull, c);
    if (lane == k) mine = r;
  }
  return mine;
}

// Pass 1 over one store: its running sums (written over the bins when
// `write`), its occupied bounds into (first, last), and either (COUNT) the
// lane-local counts of the running sums below thr[k] (STRICT) or at most
// thr[k], or (returned) the running sum at bin n_bins - 1.
template <bool STRICT, bool COUNT>
__device__ __forceinline__ float walk_store(float* row, int n_bins, bool write, int& first,
                                            int& last, const float thr[kQC], float cnt[kQC]) {
  const int n_tiles = (n_bins + sk::kTile - 1) / sk::kTile;
  const int t_end = (n_bins - 1) / sk::kTile;
  const int j_end = (n_bins - 1) & 3;
  float carry = 0.0f, end_sum = 0.0f;
  first = n_bins;
  last = -1;
  for (int t0 = 0; t0 < n_tiles; t0 += kGroup) {
    float4 x[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) x[i] = load_tile(row, t0 + i, n_bins);
    occupied(x, t0, first, last);
    float cum[kGroup][4];
    scan_group(x, carry, cum);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (write) store_tile(row, t0 + i, n_bins, cum[i]);
      if (!COUNT && t0 + i == t_end) {
        end_sum = j_end == 0 ? cum[i][0]
                             : (j_end == 1 ? cum[i][1] : (j_end == 2 ? cum[i][2] : cum[i][3]));
      }
    }
    if (COUNT) count_any<STRICT>(cum, t0, n_bins, thr, cnt);
  }
  first = __reduce_min_sync(sk::kFull, first);
  last = __reduce_max_sync(sk::kFull, last);
  return COUNT ? 0.0f : __shfl_sync(sk::kFull, end_sum, ((n_bins - 1) % sk::kTile) / 4);
}

// Pass 2 over one store: lane k gets the count of running sums below
// thr[k] (STRICT) or at most thr[k].  IN_PLACE reads the running sums
// pass 1 wrote over the bins, else it scans the bins again.
template <bool STRICT, bool IN_PLACE>
__device__ __forceinline__ int count_store(float* row, int n_bins, const float thr[kQC]) {
  float cnt[kQC];
#pragma unroll
  for (int k = 0; k < kQC; ++k) cnt[k] = 0.0f;
  if (IN_PLACE) {
    const int n_tiles = (n_bins + sk::kTile - 1) / sk::kTile;
    for (int t0 = 0; t0 < n_tiles; t0 += kGroup) {
      float cum[kGroup][4];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float4 x = load_tile(row, t0 + i, n_bins);
        cum[i][0] = x.x;
        cum[i][1] = x.y;
        cum[i][2] = x.z;
        cum[i][3] = x.w;
      }
      count_any<STRICT>(cum, t0, n_bins, thr, cnt);
    }
  } else {
    int first, last;
    walk_store<STRICT, true>(row, n_bins, false, first, last, thr, cnt);
  }
  return finish_counts(cnt);
}

// Answers waiting for their decode: (row, q, key, what), what = 0 negative
// value, 1 zero, 2 positive value, 3 NaN.  A warp decodes 32 at a time.
struct Pending {
  int4* slot;  // this warp's 32 entries in shared memory
  int fill;
};

template <int MAP>
__device__ __forceinline__ void decode(const Args& a, Pending& p) {
  const int lane = threadIdx.x % sk::kLanes;
  __syncwarp();
  if (lane < p.fill) {
    const int4 e = p.slot[lane];
    const float v = sk::value_of<MAP>(e.z, sk::load_consts(a.consts));
    const float val = e.w == 0 ? -v : (e.w == 1 ? 0.0f : (e.w == 2 ? v : __int_as_float(0x7fc00000)));
    a.out[(long)e.x * a.q_total + e.y] = val;
  }
  __syncwarp();
  p.fill = 0;
}

// Every quantile of one stream.  `neg` / `pos` are the row's bins: a ring
// slot's (IN_PLACE: pass 1 writes the running sums over them) or device
// memory's.  `q0` holds the first kQC quantiles (NaN past q_total).  Lane k
// of a chunk of kQC quantiles clips its counts, picks negative / zero /
// positive / NaN and queues the bucket key for the warp's decode.
template <int MAP, bool IN_PLACE>
__device__ __forceinline__ void answer_row(const Args& a, float* neg, float* pos, int row,
                                           float zero, float cnt_f, int key_lo,
                                           const float q0[kQC], Pending& pend) {
  const int lane = threadIdx.x % sk::kLanes;
  int first_neg, last_neg, first_pos, last_pos;
  float none[kQC];
  const float neg_count =
      walk_store<true, false>(neg, a.n_bins, IN_PLACE, first_neg, last_neg, q0, none);
  for (int g = 0; g < a.q_total; g += kQC) {
    float rev_p1[kQC], pos_rank[kQC];
#pragma unroll
    for (int j = 0; j < kQC; ++j) {
      const float qv = g == 0 ? q0[j]
                              : (g + j < a.q_total ? __ldg(a.qs + g + j)
                                                   : __int_as_float(0x7fc00000));
      const float rank = qv * (cnt_f - 1.0f);
      rev_p1[j] = ((neg_count - 1.0f) - rank) + 1.0f;
      pos_rank[j] = (rank - zero) - neg_count;
    }
    const int cnt_neg = count_store<true, IN_PLACE>(neg, a.n_bins, rev_p1);
    int cnt_pos;
    if (g == 0) {  // the positive store's one scan counts the first chunk
      float cnt[kQC];
#pragma unroll
      for (int k = 0; k < kQC; ++k) cnt[k] = 0.0f;
      walk_store<false, true>(pos, a.n_bins, IN_PLACE && a.q_total > kQC, first_pos,
                                  last_pos, pos_rank, cnt);
      cnt_pos = finish_counts(cnt);
    } else {
      cnt_pos = count_store<false, IN_PLACE>(pos, a.n_bins, pos_rank);
    }
    const int nq = min(kQC, a.q_total - g);
    if (pend.fill + nq > sk::kLanes) decode<MAP>(a, pend);
    if (lane < nq) {
      const float qv = __ldg(a.qs + g + lane);
      const float rank = qv * (cnt_f - 1.0f);
      const int what = !(qv >= 0.0f && qv <= 1.0f && cnt_f > 0.0f)
                           ? 3
                           : (rank < neg_count ? 0 : (rank < neg_count + zero ? 1 : 2));
      const int idx = what == 0 ? min(max(cnt_neg, first_neg), last_neg)
                                : min(max(cnt_pos, first_pos), last_pos);
      pend.slot[pend.fill + lane] = make_int4(row, g + lane, idx + key_lo, what);
    }
    pend.fill += nq;
  }
}

__device__ __forceinline__ void first_quantiles(const Args& a, float q0[kQC]) {
#pragma unroll
  for (int j = 0; j < kQC; ++j) q0[j] = j < a.q_total ? __ldg(a.qs + j) : __int_as_float(0x7fc00000);
}

// Producer (lane 0 of the last warp): every slot of this CTA, in order.
__device__ __forceinline__ void produce(const Args& a, float* ring, unsigned full0,
                                       unsigned empty0) {
  const long store_floats = (long)a.rows * a.n_bins;
  // Slot i goes to consumer s = i % C, into ring slot s, phase (i / C) & 1.
  int s = 0;
  unsigned phase = 0u;
  for (long c = blockIdx.x; c < a.n_slots; c += gridDim.x) {
    sk::mbar_wait(empty0 + 8 * s, phase ^ 1u);
    const long r0 = c * a.rows;
    const long rows = a.n - r0 < a.rows ? a.n - r0 : a.rows;
    const unsigned bytes = (unsigned)(rows * a.n_bins * 4);
    const unsigned bulk = bytes & ~15u;
    float* neg = ring + 2 * s * store_floats;
    float* pos = neg + store_floats;
    const long g0 = r0 * a.n_bins;
    // A ragged last slot: the bytes past the last multiple of 16.
    for (unsigned b = bulk / 4; b < bytes / 4; ++b) {
      neg[b] = a.bins_neg[g0 + b];
      pos[b] = a.bins_pos[g0 + b];
    }
    const unsigned full = full0 + 8 * s;
    if (bulk == 0) {
      sk::mbar_arrive(full);
    } else {
      sk::mbar_arrive_tx(full, 2 * bulk);
      sk::bulk_copy(sk::smem_addr(neg), a.bins_neg + g0, bulk, full);
      sk::bulk_copy(sk::smem_addr(pos), a.bins_pos + g0, bulk, full);
    }
    if (++s == a.consumers) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int MAP>
__device__ __forceinline__ void consume(const Args& a, float* ring, unsigned full0,
                                       unsigned empty0, int4* pending) {
  const int warp = threadIdx.x / sk::kLanes;
  const int lane = threadIdx.x % sk::kLanes;
  float q0[kQC];
  first_quantiles(a, q0);
  Pending pend = {pending + warp * sk::kLanes, 0};
  const long store_floats = (long)a.rows * a.n_bins;
  // This warp's slots i = warp, warp + C, ... all go through ring slot
  // `warp`, so its phases pass in this warp's order.
  const int s = warp;
  unsigned phase = 0u;
  for (long c = blockIdx.x + (long)warp * gridDim.x; c < a.n_slots;
       c += (long)a.consumers * gridDim.x) {
    const int r0 = (int)(c * a.rows);
    const int rows = a.n - r0 < a.rows ? a.n - r0 : a.rows;
    float zero = __ldg(a.zero_count + r0), cnt_f = __ldg(a.count + r0);
    int key_lo = __ldg(a.key_offset + r0);
    sk::mbar_wait(full0 + 8 * s, phase);
    float* neg = ring + 2 * s * store_floats;
    for (int r = 0; r < rows; ++r) {
      if (r > 0) {
        zero = __ldg(a.zero_count + r0 + r);
        cnt_f = __ldg(a.count + r0 + r);
        key_lo = __ldg(a.key_offset + r0 + r);
      }
      answer_row<MAP, true>(a, neg + r * a.n_bins, neg + store_floats + r * a.n_bins,
                                r0 + r, zero, cnt_f, key_lo, q0, pend);
    }
    // The running sums this warp wrote, before the slot's refill.
    sk::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sk::mbar_arrive(empty0 + 8 * s);
    phase ^= 1u;
  }
  if (pend.fill > 0) decode<MAP>(a, pend);
}

// Shared memory: C slots of 2 R n_bins floats, C full and C empty
// mbarriers, and each consumer warp's answers awaiting decode.
template <int MAP>
__global__ void __launch_bounds__((kConsumers + 1) * sk::kLanes) ring_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(ring + 2L * a.consumers * a.rows * a.n_bins);
  int4* pending = reinterpret_cast<int4*>(bars + 2 * a.consumers);
  const unsigned full0 = sk::smem_addr(bars);
  const unsigned empty0 = full0 + 8 * a.consumers;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.consumers; ++s) {
      sk::mbar_init(full0 + 8 * s, 1);   // the producer's arrive
      sk::mbar_init(empty0 + 8 * s, 1);  // the slot's consumer warp
    }
    sk::mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist
  const int warp = threadIdx.x / sk::kLanes;
  if (warp < a.consumers) {
    consume<MAP>(a, ring, full0, empty0, pending);
  } else if (threadIdx.x % sk::kLanes == 0) {
    produce(a, ring, full0, empty0);
  }
}

// Rows too wide for the ring: one warp a row, straight from device memory.
template <int MAP>
__global__ void __launch_bounds__(kWideWarps * sk::kLanes) wide_kernel(const Args a) {
  __shared__ int4 pending[kWideWarps * sk::kLanes];
  float q0[kQC];
  first_quantiles(a, q0);
  const int warp = threadIdx.x / sk::kLanes;
  Pending pend = {pending + warp * sk::kLanes, 0};
  const long warps = (long)gridDim.x * kWideWarps;
  for (long row = (long)blockIdx.x * kWideWarps + warp; row < a.n; row += warps) {
    // Never written: IN_PLACE is false.
    float* neg = const_cast<float*>(a.bins_neg + row * a.n_bins);
    float* pos = const_cast<float*>(a.bins_pos + row * a.n_bins);
    answer_row<MAP, false>(a, neg, pos, (int)row, __ldg(a.zero_count + row),
                               __ldg(a.count + row), __ldg(a.key_offset + row), q0, pend);
  }
  if (pend.fill > 0) decode<MAP>(a, pend);
}

// Resident CTAs of `kern` a streaming multiprocessor, and the SM count.
template <typename K>
cudaError_t residency(K kern, int threads, long smem, int& per_sm, int& sms) {
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  if (smem > 0 && (err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem)) != cudaSuccess) {
    return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, (size_t)smem);
}

// The launch geometry of a call: kernel, threads, shared memory, CTAs an SM.
template <int MAP>
cudaError_t geometry(Args& a, int& threads, long& smem, int& per_sm, int& sms, bool& wide) {
  const Plan p = plan_of(a.n_bins);
  wide = p.wide;
  a.rows = p.rows;
  a.consumers = p.consumers;
  a.n_slots = ((long)a.n + p.rows - 1) / p.rows;
  if (wide) {
    threads = kWideWarps * sk::kLanes;
    smem = 0;
    return residency(wide_kernel<MAP>, threads, 0, per_sm, sms);
  }
  threads = (p.consumers + 1) * sk::kLanes;
  smem = p.smem;
  return residency(ring_kernel<MAP>, threads, smem, per_sm, sms);
}

template <int MAP>
int launch(Args a, cudaStream_t stream) {
  int threads = 0, per_sm = 0, sms = 0;
  long smem = 0;
  bool wide = false;
  const cudaError_t err = geometry<MAP>(a, threads, smem, per_sm, sms, wide);
  if (err != cudaSuccess) return (int)err;
  const long resident = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long work = wide ? ((long)a.n + kWideWarps - 1) / kWideWarps : a.n_slots;
  const int grid = (int)(work < resident ? work : resident);
  if (wide) {
    wide_kernel<MAP><<<grid, threads, 0, stream>>>(a);
  } else {
    ring_kernel<MAP><<<grid, threads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (sketches_tpu_torch/kernels.py).  Both
// stores must start on a 16-byte boundary (the bulk copies' rule).
extern "C" int sk_quantile(const float* bins_pos, const float* bins_neg,
                           const float* zero_count, const float* count,
                           const int* key_offset, const float* qs, float* out,
                           const float* consts, int mapping, int n, int n_bins,
                           int q_total, void* stream) {
  if (n <= 0 || q_total <= 0) return 0;
  if (n_bins < 2 || bins_pos == nullptr || bins_neg == nullptr ||
      ((reinterpret_cast<uintptr_t>(bins_pos) | reinterpret_cast<uintptr_t>(bins_neg)) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {bins_pos, bins_neg, zero_count, count, key_offset, qs, out, consts,
            n, n_bins, q_total, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SK_DISPATCH_MAPPING(mapping, return launch<MAP>(a, st));
  return 0;
}

// The launch geometry sk_quantile takes for (mapping, n_bins), for the
// records: shape = {rows a slot, consumer warps (= ring slots), threads a
// CTA, dynamic shared memory bytes, CTAs an SM, SMs, wide (0/1)}.
extern "C" int sk_quantile_shape(int mapping, int n_bins, int* shape) {
  if (n_bins < 2 || shape == nullptr) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.n = 1;
  a.n_bins = n_bins;
  int threads = 0, per_sm = 0, sms = 0;
  long smem = 0;
  bool wide = false;
  cudaError_t err = cudaSuccess;
  SK_DISPATCH_MAPPING(mapping, err = geometry<MAP>(a, threads, smem, per_sm, sms, wide));
  if (err != cudaSuccess) return (int)err;
  const int vals[7] = {a.rows, a.consumers, threads, (int)smem, per_sm, sms, wide};
  for (int i = 0; i < 7; ++i) shape[i] = vals[i];
  return 0;
}
