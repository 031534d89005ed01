// Chunk-verify attention (the cache part of speculative decoding's verify
// step): S query tokens per batch row, all against the first lengths[b]
// cache positions of that row.  Replaces the TPU entry flash_verify_append
// (aiko_services_tpu/ops/pallas_decode.py:830), which ran kernels #2/#3
// with lengths = starts and the qrow_period head map.
//
// The query rows come in the reference's [S, H] order, [B, S*H, HD]; row
// r belongs to kv head (r mod H) div G.  A block serves one (kv head,
// batch row) pair and its nq = S*G queries: query j of the block is
// r = (j / G) * H + kvh * G + j % G (20 at llama3-8b with 4 draft tokens;
// up to 72).  The cache rows come through the Rows functors of
// kv_rows.cuh (flat or paged), bf16 or int8 with per-(position, kv head)
// f32 scales.
//
// What bounds it on an H100: bytes.  Each cached element meets nq
// queries, ~4 nq operations per element against the 1-2 bytes it costs,
// far below the card's ~295 operations a byte, once the products run on
// the tensor cores.
//
// Design:
//  - Split over T.  The grid is (K, B, splits); block z owns positions
//    [z * tiles * 64, (z + 1) * tiles * 64) of its row, with (splits,
//    tiles) a function of the static shapes only (the launch is captured
//    in the device loop's graph, where the host cannot read the
//    lengths).  A block past its row's start writes a neutral partial
//    (m = -1e30, l = 0) and exits.  Each block writes its partial (acc,
//    m, l) to scratch; verify_combine_kernel below merges the splits in
//    a fixed order.  Split boundaries are positions, multiples of the
//    64-key tile, never pages: the paged form stays bitwise equal to the
//    flat one.
//  - Tensor cores over the staged tile, one warpgroup a block.  Keys go
//    on the wgmma M axis and queries on N:  S^T[64 keys, N] = K Q^T, and
//    O^T[hd, N] += V^T P^T with hd = 128 as two m64 halves and V read
//    MN-major from the same swizzled tile (the transpose bit of A).  N
//    is nq padded to the next of 8, 24, 40, 72 (sm90.cuh's narrow
//    widths), so 20 queries cost 24 columns, not 64 rows.
//  - f32 accuracy from bf16 products.  f32 queries and the f32 softmax
//    weights are each split into a bf16 high and low part (x = hi + lo
//    to ~16 bits) and both products accumulate into one f32
//    accumulator; bf16 keys and values, and int8 codes (|code| <= 127),
//    are exact in bf16.  bf16 queries keep the TPU kernel's semantics:
//    one product each, the weights rounded to bf16 before P V.
//  - Online softmax over the key rows: a query column's max is a shuffle
//    over the warp's 16 keys plus one exchange across the four warps in
//    shared memory; each thread keeps its rows' share of l and the four
//    warps add them once, at the end.
//  - Copies: a ring of two stages filled by 16-byte cp.async through the
//    Rows address of each key row, tile j + 2 in flight while tile j is
//    computed.  bf16 rows land directly in the 128-byte swizzled layout;
//    int8 rows land raw (with their scales, 4-byte cp.async) and are
//    widened exactly into one bf16 tile pair in shared memory.  The k
//    scale multiplies the score, the v scale the numerator's weights
//    only (the TPU kernel's fold).
#include <type_traits>

#include "common.cuh"
#include "kv_rows.cuh"
#include "sm90.cuh"

namespace {

using aiko::kNegInf;
using aiko::FlatRows;
using aiko::PagedRows;
using namespace aiko::sm90;

constexpr int kThreads = 128;     // one warpgroup
constexpr int kKeys = 64;         // keys per tile: the M of S^T = K Q^T
constexpr int kStages = 2;
constexpr int kMaxQueries = 72;   // S * G a block holds

// The wgmma width N that holds nq queries.
int padded_queries(int nq) {
  return nq <= 8 ? 8 : nq <= 24 ? 24 : nq <= 40 ? 40 : 72;
}

template <int HD, int N, typename QT, typename KV>
struct Layout {
  static constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  static constexpr int kParts = std::is_same_v<QT, float> ? 2 : 1;
  static constexpr int kTile = kKeys * HD * 2;     // bf16 [HD/64][64][128 B]
  static constexpr int kRawTile = kKeys * HD;      // int8 [64][HD]
  static constexpr int kRawStage = 2 * kRawTile + 2 * kKeys * 4;
  static constexpr int kQ = N * HD * 2;            // bf16 [HD/64][N][128 B]
  static constexpr int kP = N * kKeys * 2;         // bf16 [N][128 B]
  // bf16 payloads: the ring of K/V tiles; int8: one widened pair.
  static constexpr int kKVBytes = (kInt8 ? 1 : kStages) * 2 * kTile;
  static constexpr int kQOff = kKVBytes;
  static constexpr int kPOff = kQOff + kParts * kQ;
  static constexpr int kRawOff = kPOff + kParts * kP;
  static constexpr int kRedOff = kRawOff + (kInt8 ? kStages * kRawStage : 0);
  static constexpr int kTableOff = kRedOff + 4 * N * 4;
  static constexpr int kBytes = kTableOff + 1024;  // + the table; alignment
  static_assert(N % 8 == 0 && HD % 64 == 0, "whole swizzle atoms");
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <int HD, int N, typename QT, typename KV, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_verify_kernel(const QT* __restrict__ q,              // [B, R, HD]
                    const KV* __restrict__ k,              // one layer
                    const KV* __restrict__ v,
                    const float* __restrict__ k_scale,     // int8 only
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ lengths,   // [B] starts
                    float* __restrict__ part_acc,  // [B, K, splits, nq, HD]
                    float* __restrict__ part_m,    // [B, K, splits, nq]
                    float* __restrict__ part_l,
                    int groups, int n_queries, int period, int n_rows,
                    int t_len, int tiles_per_split, Rows rows) {
  using L = Layout<HD, N, QT, KV>;
  constexpr bool kInt8 = L::kInt8;
  constexpr bool kSplit = L::kParts == 2;
  constexpr int kChunks = HD / 8;       // 16-byte bf16 chunks in a row
  constexpr int kHalves = HD / 64;      // m64 halves of O^T
  constexpr int kS = N / 2;             // accumulator registers a thread
  constexpr int kCols = N / 4;          // query columns a thread owns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_addr);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nq = n_queries;
  const int length = min(max(lengths[b], 0), t_len);
  const int t_begin = split * tiles_per_split * kKeys;
  const int t_end = min(length, t_begin + tiles_per_split * kKeys);
  const long long part =
      (((long long)b * gridDim.x + kvh) * gridDim.z + split) * nq;
  if (t_begin >= t_end) {               // past this row's start: neutral
    for (int j = tid; j < nq; j += kThreads) {
      part_m[part + j] = kNegInf;
      part_l[part + j] = 0.f;
    }
    return;
  }
  int* tbl = reinterpret_cast<int*>(gbase + L::kTableOff);
  rows.load(b, t_end, tbl);
  __syncthreads();                      // the table, before any address

  const KV* kb = k + kvh * HD;
  const KV* vb = v + kvh * HD;
  const int n_tiles = (t_end - t_begin + kKeys - 1) / kKeys;
  auto load_tile = [&](int tile, int slot) {
    const int t0 = t_begin + tile * kKeys;
    if constexpr (kInt8) {
      constexpr int kVecs = HD / 16;    // 16-code vectors in a row
      const uint32_t raw = base + L::kRawOff + slot * L::kRawStage;
      for (int i = tid; i < kKeys * kVecs; i += kThreads) {
        const int r = i / kVecs;
        const int c = i % kVecs;
        const bool live = t0 + r < t_end;
        const long long off = live ? rows.row(b, t0 + r, tbl) + c * 16 : 0;
        cp_async16(raw + r * HD + c * 16, kb + off, live);
        cp_async16(raw + L::kRawTile + r * HD + c * 16, vb + off, live);
      }
      for (int r = tid; r < kKeys; r += kThreads) {
        const bool live = t0 + r < t_end;
        const long long off = live ? rows.srow(b, t0 + r, tbl) + kvh : 0;
        cp_async4(raw + 2 * L::kRawTile + r * 4, k_scale + off, live);
        cp_async4(raw + 2 * L::kRawTile + (kKeys + r) * 4, v_scale + off,
                  live);
      }
    } else {
      const uint32_t ks = base + slot * 2 * L::kTile;
      const uint32_t vs = ks + L::kTile;
      for (int i = tid; i < kKeys * kChunks; i += kThreads) {
        const int r = i / kChunks;
        const int c = i % kChunks;
        const bool live = t0 + r < t_end;
        const long long off = live ? rows.row(b, t0 + r, tbl) + c * 8 : 0;
        const uint32_t dst = (c / 8) * (kKeys * 128) + swizzled(r, c % 8);
        cp_async16(ks + dst, kb + off, live);
        cp_async16(vs + dst, vb + off, live);
      }
    }
  };
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  // Queries -> [HD/64][N][128 B] swizzled bf16 tiles (hi, then lo for f32
  // queries), rows past nq zero.
  const uint32_t q_s = base + L::kQOff;
  for (int i = tid; i < N * kChunks; i += kThreads) {
    const int j = i / kChunks;
    const int c = i % kChunks;
    const uint32_t dst = (c / 8) * (N * 128) + swizzled(j, c % 8);
    uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
    if (j < nq) {
      const int r = (j / groups) * period + kvh * groups + j % groups;
      const QT* src = q + ((long long)b * n_rows + r) * HD + c * 8;
      if constexpr (kSplit) {
        const float4 x0 = reinterpret_cast<const float4*>(src)[0];
        const float4 x1 = reinterpret_cast<const float4*>(src)[1];
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
          l[e] = pack_bf16(x[2 * e] - bf16_lo(h[e]),
                           x[2 * e + 1] - bf16_hi(h[e]));
        }
        hi = make_uint4(h[0], h[1], h[2], h[3]);
        lo = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
        hi = *reinterpret_cast<const uint4*>(src);
      }
    }
    st_shared_v4(q_s + dst, hi);
    if constexpr (kSplit) st_shared_v4(q_s + L::kQ + dst, lo);
  }

  float sacc[kS];
  float o[kHalves][kS];
  float m[kCols], l[kCols];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < kS; ++i) o[h][i] = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    m[c] = kNegInf;
    l[c] = 0.f;
  }
  float* red = reinterpret_cast<float*>(gbase + L::kRedOff);   // [4][N]
  const uint32_t p_s = base + L::kPOff;
  const int row0 = 16 * warp + lane / 4;   // this thread's key rows: +0, +8
  // Query column of accumulator register i, and of column slot c (the
  // slot of register i is 2 (i / 4) + i % 2).
  auto column = [&](int i) { return 8 * (i / 4) + 2 * (lane % 4) + i % 2; };
  auto slot_column = [&](int c) {
    return 8 * (c / 2) + 2 * (lane % 4) + c % 2;
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % kStages;
    const int t0 = t_begin + j * kKeys;
    cp_async_wait<1>();                 // this thread's copies of tile j
    uint32_t ks = base + slot * 2 * L::kTile;
    if constexpr (kInt8) {
      __syncthreads();                  // ... and everyone's
      ks = base;
      const uint32_t raw = base + L::kRawOff + slot * L::kRawStage;
      constexpr int kVecs = HD / 16;
      for (int i = tid; i < 2 * kKeys * kVecs; i += kThreads) {
        const int side = i / (kKeys * kVecs);
        const int r = (i / kVecs) % kKeys;
        const int c = i % kVecs;
        uint4 lo, hi;
        widen16(ld_shared_v4(raw + side * L::kRawTile + r * HD + c * 16), lo,
                hi);
        const uint32_t tile = base + side * L::kTile;
        st_shared_v4(tile + (c / 4) * (kKeys * 128) + swizzled(r, (2 * c) % 8),
                     lo);
        st_shared_v4(tile + (c / 4) * (kKeys * 128)
                         + swizzled(r, (2 * c + 1) % 8), hi);
      }
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t vs = ks + L::kTile;

    // S^T = K Q^T: HD / 16 k-steps, hi and lo queries into one sum.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t step = (kk / 4) * (kKeys * 128) + (kk % 4) * 32;
      const uint32_t qstep = (kk / 4) * (N * 128) + (kk % 4) * 32;
      const uint64_t da = desc128(ks + step, 0, 1024);
      wgmma_ss_t<0, 0>(sacc, da, desc128(q_s + qstep, 0, 1024), kk > 0);
      if constexpr (kSplit)
        wgmma_ss_t<0, 0>(sacc, da, desc128(q_s + L::kQ + qstep, 0, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // Online softmax down the key rows.  Register i: key row
    // row0 + 8 ((i / 2) % 2), query column(i), column slot 2 (i / 4) + i % 2.
    bool valid[2];
    float kscale[2] = {1.f, 1.f}, vscale[2] = {1.f, 1.f};
    const float* scales = reinterpret_cast<const float*>(
        gbase + L::kRawOff + slot * L::kRawStage + 2 * L::kRawTile);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = t0 + row0 + 8 * h < t_end;
      if constexpr (kInt8) {
        kscale[h] = scales[row0 + 8 * h];
        vscale[h] = scales[kKeys + row0 + 8 * h];
      }
    }
    float mx[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) mx[c] = kNegInf;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int h = (i / 2) % 2;
      const int c = 2 * (i / 4) + i % 2;
      const float s = valid[h] ? (kInt8 ? sacc[i] * kscale[h] : sacc[i])
                               : kNegInf;
      sacc[i] = s;
      mx[c] = fmaxf(mx[c], s);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], off));
      if (lane < 4) red[warp * N + slot_column(c)] = mx[c];
    }
    __syncthreads();
    float m_safe[kCols], corr[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = slot_column(c);
      const float tile_max = fmaxf(fmaxf(red[col], red[N + col]),
                                   fmaxf(red[2 * N + col], red[3 * N + col]));
      const float m_new = fmaxf(m[c], tile_max);
      m_safe[c] = m_new <= kNegInf / 2 ? 0.f : m_new;
      corr[c] = expf(m[c] - m_safe[c]);
      m[c] = m_new;
      l[c] *= corr[c];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int h = (i / 2) % 2;
      const int c = 2 * (i / 4) + i % 2;
      const float p = valid[h] ? expf(sacc[i] - m_safe[c]) : 0.f;
      l[c] += p;
      const float w = kInt8 ? p * vscale[h] : p;
      // P^T as a K-major [N][64 keys] tile: query column(i), key row.
      const int r = row0 + 8 * h;
      const uint32_t at = swizzled(column(i), r / 8) + (r % 8) * 2;
      const uint16_t w_hi = bf16_bits(w);
      st_shared_u16(p_s + at, w_hi);
      if constexpr (kSplit)
        st_shared_u16(p_s + L::kP + at,
                      bf16_bits(w - __uint_as_float(uint32_t(w_hi) << 16)));
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int i = 0; i < kS; ++i) o[h][i] *= corr[2 * (i / 4) + i % 2];
    fence_async_shared();               // P -> the tensor cores
    __syncthreads();

    // O^T += V^T P^T: per m64 half of hd, 4 k-steps of 16 keys.
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_regs(o[h]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t da =
            desc128(vs + h * (kKeys * 128) + kk * 2048, kKeys * 128, 1024);
        wgmma_ss_t<1, 0>(o[h], da, desc128(p_s + kk * 32, 0, 1024), 1);
        if constexpr (kSplit)
          wgmma_ss_t<1, 0>(o[h], da, desc128(p_s + L::kP + kk * 32, 0, 1024),
                           1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_regs(o[h]);
    __syncthreads();                    // the stage, P and red are free
    if (j + kStages < n_tiles) load_tile(j + kStages, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // l: the thread's rows -> the warp's 16 rows -> the four warps, in order.
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
      l[c] += __shfl_xor_sync(0xffffffffu, l[c], off);
    if (lane < 4) red[warp * N + slot_column(c)] = l[c];
  }
  __syncthreads();
  if (warp == 0 && lane < 4) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = slot_column(c);
      if (col < nq) {
        part_m[part + col] = m[c];
        part_l[part + col] = ((red[col] + red[N + col]) + red[2 * N + col])
                             + red[3 * N + col];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int col = column(i);
      if (col < nq)
        part_acc[(part + col) * HD + h * 64 + row0 + 8 * ((i / 2) % 2)] =
            o[h][i];
    }
}

// Merge the splits of each output row in split order: m = max m_s,
// acc = sum exp(m_s - m) acc_s, l = sum exp(m_s - m) l_s; neutral
// partials (m_s = -1e30) are skipped, so a row with no cache positions
// gives acc = 0, m = -1e30, l = 0.  One warp a row, HD / 32 dims a lane.
template <int HD>
__global__ void __launch_bounds__(128)
verify_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      float* __restrict__ acc_out,     // [B, R, HD]
                      float* __restrict__ m_out,       // [B, R]
                      float* __restrict__ l_out,
                      int batch, int n_kv, int groups, int n_queries,
                      int period, int n_rows, int splits) {
  constexpr int DPL = HD / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= (long long)batch * n_rows) return;
  const int b = static_cast<int>(row / n_rows);
  const int r = static_cast<int>(row % n_rows);
  const int h = r % period;
  const int j = (r / period) * groups + h % groups;
  const long long first = ((long long)b * n_kv + h / groups) * splits
                          * n_queries + j;
  float mx = kNegInf;
  for (int s = lane; s < splits; s += 32)
    mx = fmaxf(mx, part_m[first + (long long)s * n_queries]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float acc[DPL], l = 0.f;
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long p = first + (long long)s * n_queries;
    const float ms = part_m[p];
    if (ms <= kNegInf / 2) continue;
    const float w = expf(ms - mx);
    l += w * part_l[p];
    float part[DPL];
    aiko::load_vec<DPL>(part_acc + p * HD + lane * DPL, part);
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] += w * part[d];
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc_out[row * HD + lane * DPL + d] = acc[d];
  if (lane == 0) {
    m_out[row] = mx;
    l_out[row] = l;
  }
}

// Everything a launch needs besides the template choices.
struct Args {
  const void* q;
  int q_bf16;
  int kv_int8;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const void* lengths;
  void* part_acc;
  void* part_m;
  void* part_l;
  int batch, n_kv, groups, n_queries, period, n_rows, t_len;
  int splits, tiles_per_split;
};

template <int HD, int N, typename QT, typename KV, typename Rows>
int launch_typed(const Args& a, Rows rows, int table_bytes,
                 cudaStream_t stream) {
  auto kernel = flash_verify_kernel<HD, N, QT, KV, Rows>;
  const int bytes = Layout<HD, N, QT, KV>::kBytes + table_bytes;
  // Set before any graph capture (the first launch is eager), raised
  // when a larger page table needs more.
  static int configured = 0;
  if (bytes > configured) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    configured = bytes;
  }
  kernel<<<dim3(a.n_kv, a.batch, a.splits), kThreads, bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.lengths),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), a.groups, a.n_queries, a.period,
      a.n_rows, a.t_len, a.tiles_per_split, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int N, typename Rows>
int launch_types(const Args& a, Rows rows, int table_bytes, cudaStream_t s) {
  if (a.q_bf16 && a.kv_int8)
    return launch_typed<HD, N, __nv_bfloat16, int8_t>(a, rows, table_bytes, s);
  if (a.q_bf16)
    return launch_typed<HD, N, __nv_bfloat16, __nv_bfloat16>(a, rows,
                                                             table_bytes, s);
  if (a.kv_int8)
    return launch_typed<HD, N, float, int8_t>(a, rows, table_bytes, s);
  return launch_typed<HD, N, float, __nv_bfloat16>(a, rows, table_bytes, s);
}

template <int HD, typename Rows>
int launch_width(const Args& a, Rows rows, int table_bytes, cudaStream_t s) {
  switch (padded_queries(a.n_queries)) {
    case 8: return launch_types<HD, 8>(a, rows, table_bytes, s);
    case 24: return launch_types<HD, 24>(a, rows, table_bytes, s);
    case 40: return launch_types<HD, 40>(a, rows, table_bytes, s);
    default: return launch_types<HD, 72>(a, rows, table_bytes, s);
  }
}

template <typename Rows>
int launch(int head_dim, const Args& a, Rows rows, int table_bytes,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (a.n_queries < 1 || a.n_queries > kMaxQueries || a.groups < 1
      || a.period % a.groups || a.n_rows % a.period || a.splits < 1
      || a.tiles_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64: return launch_width<64>(a, rows, table_bytes, s);
    case 128: return launch_width<128>(a, rows, table_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Chunk verify, flat form: q is [B, n_rows, HD] f32 or bf16 in [S, H] row
// order (period = H, n_rows = S * H, n_queries = S * G); k/v point at a
// [B, T, C] view whose rows sit at b * stride_b + t * stride_t elements,
// an int8 payload's k_scale/v_scale at its [B, T, K] f32 scales (rows
// b * sstride_b + t * sstride_t floats apart; null for bf16); lengths
// holds each row's verify start.  Writes the partials [B, K, splits,
// n_queries, HD] / [B, K, splits, n_queries] of splits blocks of
// tiles_per_split 64-key tiles a row; aiko_verify_combine merges them.
extern "C" int aiko_flash_verify(
    const void* q, int q_bf16, int kv_int8, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lengths,
    void* part_acc, void* part_m, void* part_l, int batch, int n_kv,
    int groups, int head_dim, int n_queries, int period, int n_rows,
    int t_len, int splits, int tiles_per_split, long long stride_b,
    long long stride_t, long long sstride_b, long long sstride_t,
    void* stream) {
  const Args a{q, q_bf16, kv_int8, k, v, k_scale, v_scale, lengths,
               part_acc, part_m, part_l, batch, n_kv, groups, n_queries,
               period, n_rows, t_len, splits, tiles_per_split};
  const FlatRows rows{stride_b, stride_t, sstride_b, sstride_t};
  return launch(head_dim, a, rows, 0, stream);
}

// Chunk verify, paged form: the queries and partials of
// aiko_flash_verify, the cache as one layer of the pools [P, pt, C]
// (rows page_stride and stride_t elements apart; an int8 payload's scales
// one layer of the [P, pt, K] scale pools) walked through table [B, pps].
extern "C" int aiko_flash_verify_paged(
    const void* q, int q_bf16, int kv_int8, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* part_acc, void* part_m, void* part_l,
    int batch, int n_kv, int groups, int head_dim, int n_queries, int period,
    int n_rows, int splits, int tiles_per_split, int pps, int page_tokens,
    int n_pages, long long page_stride, long long stride_t,
    long long spage_stride, long long sstride_t, void* stream) {
  const Args a{q, q_bf16, kv_int8, k, v, k_scale, v_scale, lengths,
               part_acc, part_m, part_l, batch, n_kv, groups, n_queries,
               period, n_rows, pps * page_tokens, splits, tiles_per_split};
  const PagedRows rows{page_stride, stride_t, spage_stride, sstride_t,
                       static_cast<const int32_t*>(table), pps, page_tokens,
                       n_pages};
  return launch(head_dim, a, rows, pps * static_cast<int>(sizeof(int)),
                stream);
}

// The verify's combine: partials of aiko_flash_verify(_paged) -> acc
// [B, n_rows, HD], m and l [B, n_rows] f32, in the queries' [S, H] order.
extern "C" int aiko_verify_combine(
    const void* part_acc, const void* part_m, const void* part_l, void* acc,
    void* m, void* l, int batch, int n_kv, int groups, int head_dim,
    int n_queries, int period, int n_rows, int splits, void* stream) {
  if (batch < 1 || n_rows < 1 || splits < 1 || groups < 1
      || n_queries < 1 || period % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>(((long long)batch * n_rows + 3) / 4);
  auto s = static_cast<cudaStream_t>(stream);
#define AIKO_COMBINE(HD)                                                     \
  verify_combine_kernel<HD><<<blocks, 128, 0, s>>>(                          \
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m), \
      static_cast<const float*>(part_l), static_cast<float*>(acc),            \
      static_cast<float*>(m), static_cast<float*>(l), batch, n_kv, groups,    \
      n_queries, period, n_rows, splits)
  if (head_dim == 64)
    AIKO_COMBINE(64);
  else if (head_dim == 128)
    AIKO_COMBINE(128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef AIKO_COMBINE
  return static_cast<int>(cudaGetLastError());
}
