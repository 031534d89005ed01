// Split-K decode attention: one query token per batch row against the
// first lengths[b] positions of that row's cache, over three layouts that
// share ONE kernel body (a template parameter supplies the address of
// cache row t):
//
//  - flat [B, T, K*hd] views with per-row strides.  Replaces the TPU
//    kernels flash_decode_attention (aiko_services_tpu/ops/
//    pallas_decode.py:285, kernel #1) and, through the cache[layer] view
//    of the layer-stacked cache, flash_decode_attention_stacked (:387,
//    kernel #2);
//  - paged pools [P, pt, K*hd] (one layer of [L, P, pt, K*hd]) walked
//    through a [B, pps] int32 page table.  Replaces
//    flash_decode_attention_paged (:487, kernel #3).
//
// The result is the unnormalised online-softmax state (acc, m, l) that
// the caller merges with the current token's own k/v.
//
// A second template parameter is the payload: bf16 caches, or int8 codes
// with one f32 scale per (position, kv head) (the JAX package's
// kv_dtype="int8", dequantized inside the kernel as the TPU kernels do).
//
// What bounds it on an H100: bytes.  Each launch streams the live part of
// one layer's K and V (at B=8, T=2048, K*hd=1024, bf16: 64 MiB; int8: half
// that plus 1/hd of it in scales) and does ~4 FLOP per cached element, far
// below the card's ~295 FLOP/byte ridge.  The paged form adds only the
// live table entries (4 bytes a page).
//
// Design:
//  - The TPU kernel carries (m, l, acc) across a sequential grid axis in
//    VMEM.  Hopper blocks run in no order, so one block owns one
//    (batch row, kv head) pair and loops over T itself, 64 positions per
//    tile, keeping m and l in shared memory and acc in registers.
//  - The three layouts differ ONLY in where row t lives, so the tile loop,
//    the products and the softmax run the same instructions in the same
//    order: the paged kernel is bitwise equal to the flat kernel on the
//    gathered view (the twin of the JAX package's acceptance gate
//    test_paged_kernel_bitwise_matches_dense_kernel).  The TPU kernel's
//    pages ARE its time blocks; here the 64-position tile is independent
//    of the page size, so any pt that is a multiple of 8 works, pt < 64
//    included (a tile then spans several pages).
//  - Paged: the block copies its row's LIVE table entries into shared
//    memory once, at block start (ceil(length / pt) ints; the TPU kernel
//    scalar-prefetched the whole table), and resolves row t as
//    pool[table[t / pt], t % pt].  Entries are clamped into [0, P) so a
//    corrupt table cannot read outside the pool.
//  - GQA on the TPU was a block-diagonal product of zero-padded queries
//    [B, H, K*hd] over the fused K*hd axis (a lane-alignment trick for
//    the MXU).  Here the queries come compact as [B, H, hd] and a block
//    reads only its kv head's hd-wide slice of each cache row: 1/K of
//    the products, and no zero-padding columns.  acc comes back compact
//    as [B, H, hd].
//  - Score phase: HD/16 lanes share a cache row, each lane holding 16
//    dims of all G queries in registers and reading its 32 bytes of the
//    row with two 16-byte loads; a short shuffle tree finishes each dot.
//  - PV phase: each warp walks rows r = warp, warp+8, ...; each lane owns
//    HD/32 contiguous dims of all G heads, so a warp reads a whole value
//    row in one coalesced transaction.  The eight warps' partial sums
//    are added in shared memory at the end.
//  - Tiles past lengths[b] are never read, so short rows cost only their
//    own extent; a row of length 0 returns acc = 0, l = 0, m = -1e30.
//  - bf16 queries (head dims whose softmax scale is a power of two) round
//    the softmax weights to bf16 before the PV product, as the TPU
//    kernel's p.astype(compute_dtype) does; f32 queries keep them f32.
//  - int8 payloads: the rows are read as int8 codes (half the bytes; 16
//    codes a 16-byte load in the score phase) and widened exactly; the
//    scales are read in their stored [.., T, K] layout through the same
//    row address (no transposed copy).  The score is dot(q, k) * k_scale
//    and a position adds p * v_scale * v to acc but p alone to l -- the
//    TPU kernel's fold: exact dequantization, no query or weight
//    quantization.  The paged int8 form stays bitwise equal to the flat
//    int8 form on the gathered view.
//
// Known limit: B * K blocks (64 at llama3-8b with 8 slots) leave about
// half of the 132 SMs idle.  Splitting T across blocks with a second
// combine pass is the next step for all three forms (a later change).
#include <type_traits>

#include "common.cuh"

namespace {

using aiko::kNegInf;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;

// Row addressing of a flat [B, T, C] view: row t of batch row b at
// base + b * stride_b + t * stride_t, its scales (int8 payloads, a
// [B, T, K] view) at scale_base + b * sstride_b + t * sstride_t.
struct FlatRows {
  long long stride_b, stride_t;
  long long sstride_b, sstride_t;

  __device__ __forceinline__ void load(int, int, int*) const {}
  __device__ __forceinline__ long long row(int b, int t, const int*) const {
    return b * stride_b + t * stride_t;
  }
  __device__ __forceinline__ long long srow(int b, int t, const int*) const {
    return b * sstride_b + t * sstride_t;
  }
};

// Row addressing of a paged pool [P, pt, C]: row t of batch row b at
// base + table[b, t / pt] * page_stride + (t % pt) * stride_t, its scales
// (a [P, pt, K] pool) at the same page and row of the scale pool.
struct PagedRows {
  long long page_stride, stride_t;
  long long spage_stride, sstride_t;
  const int32_t* table;           // [B, pps]
  int pps, page_tokens, n_pages;

  __device__ __forceinline__ void load(int b, int length, int* tbl) const {
    const int live = (length + page_tokens - 1) / page_tokens;
    for (int i = threadIdx.x; i < live; i += kThreads) {
      const int page = table[(long long)b * pps + i];
      tbl[i] = min(max(page, 0), n_pages - 1);
    }
  }
  __device__ __forceinline__ long long row(int, int t, const int* tbl) const {
    return tbl[t / page_tokens] * page_stride
           + (long long)(t % page_tokens) * stride_t;
  }
  __device__ __forceinline__ long long srow(int, int t,
                                            const int* tbl) const {
    return tbl[t / page_tokens] * spage_stride
           + (long long)(t % page_tokens) * sstride_t;
  }
};

template <int HD, int G, typename QT, typename KV, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q,              // [B, H, HD]
                    const KV* __restrict__ k,              // one layer
                    const KV* __restrict__ v,
                    const float* __restrict__ k_scale,     // int8 only
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ lengths,   // [B]
                    float* __restrict__ acc_out,           // [B, H, HD]
                    float* __restrict__ m_out,             // [B, H]
                    float* __restrict__ l_out,             // [B, H]
                    int n_kv, int t_len, Rows rows) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int LPR = HD / 16;     // lanes sharing one row (score phase)
  constexpr int RPW = 32 / LPR;    // rows a warp scores per pass
  constexpr int DPL = HD / 32;     // dims a lane owns (PV phase)
  __shared__ float p_s[G][kTile];
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ float red_s[kWarps][G][HD];
  extern __shared__ int tbl_s[];   // paged: the row's live table entries

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h_total = n_kv * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = min(max(lengths[b], 0), t_len);

  const int sub = lane % LPR;
  const int rsub = lane / LPR;
  float qf[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const QT* row = q + ((long long)b * h_total + kvh * G + g) * HD
                    + sub * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) qf[g][j] = aiko::to_float(row[j]);
  }
  float acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  rows.load(b, length, tbl_s);
  __syncthreads();

  const KV* kb = k + kvh * HD;
  const KV* vb = v + kvh * HD;
  const int n_tiles = (length + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    for (int r0 = warp * RPW; r0 < kTile; r0 += kWarps * RPW) {
      const int t = t0 + r0 + rsub;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (t < length) {
        float kf[16];
        aiko::load_vec<16>(kb + rows.row(b, t, tbl_s) + sub * 16, kf);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] = fmaf(qf[g][j], kf[j], part[g]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (sub == 0) {
        float ks = 1.f;
        if constexpr (kInt8) {
          if (t < length) ks = k_scale[rows.srow(b, t, tbl_s) + kvh];
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          p_s[g][r0 + rsub] = t < length ? (kInt8 ? part[g] * ks : part[g])
                                         : kNegInf;
      }
    }
    __syncthreads();
    if (warp < G) {
      const int g = warp;
      const bool valid0 = t0 + lane < length;
      const bool valid1 = t0 + lane + 32 < length;
      const float s0 = p_s[g][lane];
      const float s1 = p_s[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p0 = valid0 ? expf(s0 - m_safe) : 0.f;
      const float p1 = valid1 ? expf(s1 - m_safe) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      float w0 = p0, w1 = p1;
      if constexpr (kInt8) {
        // Value scales fold into the numerator's weights only.
        if (valid0) w0 *= v_scale[rows.srow(b, t0 + lane, tbl_s) + kvh];
        if (valid1)
          w1 *= v_scale[rows.srow(b, t0 + lane + 32, tbl_s) + kvh];
      }
      p_s[g][lane] = aiko::round_to<QT>(w0);
      p_s[g][lane + 32] = aiko::round_to<QT>(w1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_safe);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = corr_s[g];
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= corr;
    }
    for (int r = warp; r < kTile; r += kWarps) {
      const int t = t0 + r;
      if (t >= length) break;
      float vf[DPL];
      aiko::load_vec<DPL>(vb + rows.row(b, t, tbl_s) + lane * DPL, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g][r];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, vf[d], acc[g][d]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int d = 0; d < DPL; ++d) red_s[warp][g][lane * DPL + d] = acc[g][d];
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w][g][d];
    acc_out[((long long)b * h_total + kvh * G + g) * HD + d] = sum;
  }
  if (threadIdx.x < G) {
    const long long row = (long long)b * h_total + kvh * G + threadIdx.x;
    m_out[row] = m_s[threadIdx.x];
    l_out[row] = l_s[threadIdx.x];
  }
}

// Chunk-verify attention (the cache part of speculative decoding's verify
// step): S query tokens per batch row, all against the first lengths[b]
// cache positions of that row.  Replaces the TPU entry flash_verify_append
// (aiko_services_tpu/ops/pallas_decode.py:830), which ran kernels #2/#3
// with lengths = starts and the qrow_period head map.
//
// The query rows come in the reference's [S, H] order, [B, S*H, HD]; row
// r belongs to kv head (r mod H) div G.  One block owns one (kv head,
// batch row) pair and its S*G queries: query j of the block is
// r = (j / G) * H + kvh * G + j % G.  The decode body above keeps its G
// queries in registers; S*G (20 at llama3-8b with 4 draft tokens, up to
// 72) does not fit, and launching that body S times would read the cache
// S times.  So:
//  - each 64-row K/V tile (and its int8 scales) is staged in shared memory
//    ONCE, by all 256 threads, and every query of the block runs against
//    the staged tile: the cache is read once per verify step, not once per
//    draft position;
//  - score phase: the decode body's lane layout (HD/16 lanes share a row,
//    16 dims each), with the queries in register groups of up to 8 that
//    are reloaded from a float copy of the block's queries in shared
//    memory for every tile;
//  - softmax phase: warp w updates the running max, denominator and
//    correction of queries w, w+8, ...; PV phase: the same warp owns the
//    same queries' accumulators (HD/32 dims a lane, all 64 rows of the
//    tile), so no cross-warp reduction is needed;
//  - the paged and flat forms differ only in the Rows address of cache row
//    t, so the paged form is bitwise equal to the flat form on the
//    gathered view; the int8 payload folds its scales exactly as the
//    decode body does (k scale into the score, v scale into the
//    numerator's weights only).
// What bounds it: at llama3-8b (S=5, G=4) each cached element meets 20
// queries, ~80 FLOP per element against the 1-2 bytes it costs: below the
// card's ridge, so still bytes, but the FP32 products without tensor
// cores (and the query reloads from shared memory) take more time than
// the stream.  wgmma over the staged tile is the next step.
constexpr int kQGroup = 8;
constexpr int kMaxQPW = 9;  // queries a warp owns: S*G <= 72
constexpr int kMaxVerifyQueries = kMaxQPW * kWarps;

template <int HD, typename KV>
struct VerifySmem {
  // [kTile][HD] K and V tiles, [kTile] scales, [nq][HD] queries,
  // [nq][kTile] scores, [nq] m / l / correction, then the paged table.
  static constexpr int tile_bytes = kTile * HD * static_cast<int>(sizeof(KV));
  static __host__ __device__ int bytes(int nq) {
    return 2 * tile_bytes + 2 * kTile * 4 + nq * HD * 4 + nq * kTile * 4
           + ((3 * nq * 4 + 15) / 16) * 16;
  }
};

template <int HD, typename QT, typename KV, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_verify_kernel(const QT* __restrict__ q,              // [B, R, HD]
                    const KV* __restrict__ k,              // one layer
                    const KV* __restrict__ v,
                    const float* __restrict__ k_scale,     // int8 only
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ lengths,   // [B] starts
                    float* __restrict__ acc_out,           // [B, R, HD]
                    float* __restrict__ m_out,             // [B, R]
                    float* __restrict__ l_out,             // [B, R]
                    int groups, int n_queries, int period, int n_rows,
                    int t_len, Rows rows) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int LPR = HD / 16;     // lanes sharing one row (score phase)
  constexpr int RPW = 32 / LPR;    // rows a warp scores per pass
  constexpr int DPL = HD / 32;     // dims a lane owns (PV phase)
  constexpr int VEC = 16 / static_cast<int>(sizeof(KV));  // per 16 bytes
  constexpr int VPR = HD / VEC;    // 16-byte vectors per row
  using Smem = VerifySmem<HD, KV>;
  extern __shared__ __align__(16) unsigned char smem[];
  KV* k_s = reinterpret_cast<KV*>(smem);
  KV* v_s = reinterpret_cast<KV*>(smem + Smem::tile_bytes);
  float* ks_s = reinterpret_cast<float*>(smem + 2 * Smem::tile_bytes);
  float* vs_s = ks_s + kTile;
  float* q_s = vs_s + kTile;
  float* p_s = q_s + n_queries * HD;
  float* m_s = p_s + n_queries * kTile;
  float* l_s = m_s + n_queries;
  float* corr_s = l_s + n_queries;
  int* tbl_s = reinterpret_cast<int*>(smem + Smem::bytes(n_queries));

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = n_queries;
  const int length = min(max(lengths[b], 0), t_len);
  auto row_of = [&](int j) {
    return (j / groups) * period + kvh * groups + j % groups;
  };

  for (int i = threadIdx.x; i < nq * HD; i += kThreads) {
    const int j = i / HD;
    q_s[i] = aiko::to_float(
        q[((long long)b * n_rows + row_of(j)) * HD + i % HD]);
  }
  for (int j = threadIdx.x; j < nq; j += kThreads) {
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
  }
  float acc[kMaxQPW][DPL];
#pragma unroll
  for (int i = 0; i < kMaxQPW; ++i)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  rows.load(b, length, tbl_s);
  __syncthreads();

  const int sub = lane % LPR;
  const int rsub = lane / LPR;
  const KV* kb = k + kvh * HD;
  const KV* vb = v + kvh * HD;
  const int n_tiles = (length + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    // Stage: the tile's live K and V rows, 16 bytes a thread per step.
    for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = i % VPR;
      if (t0 + r < length) {
        const long long offset = rows.row(b, t0 + r, tbl_s) + c * VEC;
        reinterpret_cast<uint4*>(k_s)[i] =
            *reinterpret_cast<const uint4*>(kb + offset);
        reinterpret_cast<uint4*>(v_s)[i] =
            *reinterpret_cast<const uint4*>(vb + offset);
      }
    }
    if constexpr (kInt8) {
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        if (t0 + r < length) {
          const long long srow = rows.srow(b, t0 + r, tbl_s) + kvh;
          ks_s[r] = k_scale[srow];
          vs_s[r] = v_scale[srow];
        }
      }
    }
    __syncthreads();

    // Scores of every query against the staged rows.
    for (int j0 = 0; j0 < nq; j0 += kQGroup) {
      float qf[kQGroup][16];
#pragma unroll
      for (int g = 0; g < kQGroup; ++g)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          qf[g][jj] = j0 + g < nq ? q_s[(j0 + g) * HD + sub * 16 + jj] : 0.f;
      for (int r0 = warp * RPW; r0 < kTile; r0 += kWarps * RPW) {
        const int r = r0 + rsub;
        const bool valid = t0 + r < length;
        float part[kQGroup];
#pragma unroll
        for (int g = 0; g < kQGroup; ++g) part[g] = 0.f;
        if (valid) {
          float kf[16];
          aiko::load_vec<16>(k_s + r * HD + sub * 16, kf);
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
#pragma unroll
            for (int g = 0; g < kQGroup; ++g)
              part[g] = fmaf(qf[g][jj], kf[jj], part[g]);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
          for (int g = 0; g < kQGroup; ++g)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
        if (sub == 0) {
          const float ks = kInt8 && valid ? ks_s[r] : 1.f;
#pragma unroll
          for (int g = 0; g < kQGroup; ++g)
            if (j0 + g < nq)
              p_s[(j0 + g) * kTile + r] =
                  valid ? (kInt8 ? part[g] * ks : part[g]) : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp w owns queries w, w + 8, ...
    for (int j = warp; j < nq; j += kWarps) {
      float* ps = p_s + j * kTile;
      const bool valid0 = t0 + lane < length;
      const bool valid1 = t0 + lane + 32 < length;
      const float s0 = ps[lane];
      const float s1 = ps[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p0 = valid0 ? expf(s0 - m_safe) : 0.f;
      const float p1 = valid1 ? expf(s1 - m_safe) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      float w0 = p0, w1 = p1;
      if constexpr (kInt8) {
        if (valid0) w0 *= vs_s[lane];
        if (valid1) w1 *= vs_s[lane + 32];
      }
      ps[lane] = aiko::round_to<QT>(w0);
      ps[lane + 32] = aiko::round_to<QT>(w1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_safe);
        l_s[j] = l_s[j] * corr + sum;
        m_s[j] = m_new;
        corr_s[j] = corr;
      }
    }
    __syncthreads();

    // PV: the same warp's queries, every live row of the tile.
#pragma unroll
    for (int i = 0; i < kMaxQPW; ++i) {
      const int j = warp + kWarps * i;
      if (j < nq) {
        const float corr = corr_s[j];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
      }
    }
    for (int r = 0; r < kTile; ++r) {
      if (t0 + r >= length) break;
      float vf[DPL];
      aiko::load_vec<DPL>(v_s + r * HD + lane * DPL, vf);
#pragma unroll
      for (int i = 0; i < kMaxQPW; ++i) {
        const int j = warp + kWarps * i;
        if (j < nq) {
          const float p = p_s[j * kTile + r];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(p, vf[d], acc[i][d]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxQPW; ++i) {
    const int j = warp + kWarps * i;
    if (j < nq) {
      const long long row = (long long)b * n_rows + row_of(j);
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc_out[row * HD + lane * DPL + d] = acc[i][d];
      if (lane == 0) {
        m_out[row] = m_s[j];
        l_out[row] = l_s[j];
      }
    }
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
  void* acc;
  void* m;
  void* l;
  int batch, n_kv, t_len;
};

// Dynamic shared memory above the 48 KB default needs an opt-in per
// kernel; asked for only when a launch needs it.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int dynamic_bytes) {
  cudaFuncAttributes attributes;
  cudaError_t status = cudaFuncGetAttributes(&attributes, kernel);
  if (status != cudaSuccess) return status;
  if (attributes.sharedSizeBytes + dynamic_bytes <= 48 * 1024)
    return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_bytes);
}

template <int HD, int G, typename QT, typename KV, typename Rows>
int launch_typed(const Args& a, Rows rows, int dynamic_bytes,
                 cudaStream_t stream) {
  auto kernel = flash_decode_kernel<HD, G, QT, KV, Rows>;
  if (dynamic_bytes > 0) {
    const cudaError_t status = allow_shared(kernel, dynamic_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  const dim3 grid(a.n_kv, a.batch);
  kernel<<<grid, kThreads, dynamic_bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.lengths), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.n_kv, a.t_len,
      rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int G, typename QT, typename Rows>
int launch_payload(const Args& a, Rows rows, int dynamic_bytes,
                   cudaStream_t s) {
  if (a.kv_int8)
    return launch_typed<HD, G, QT, int8_t>(a, rows, dynamic_bytes, s);
  return launch_typed<HD, G, QT, __nv_bfloat16>(a, rows, dynamic_bytes, s);
}

template <int HD, int G, typename Rows>
int launch(const Args& a, Rows rows, int dynamic_bytes, cudaStream_t s) {
  if (a.q_bf16)
    return launch_payload<HD, G, __nv_bfloat16>(a, rows, dynamic_bytes, s);
  return launch_payload<HD, G, float>(a, rows, dynamic_bytes, s);
}

template <int HD, typename Rows>
int launch_groups(int groups, const Args& a, Rows rows, int dynamic_bytes,
                  cudaStream_t s) {
  switch (groups) {
    case 1: return launch<HD, 1>(a, rows, dynamic_bytes, s);
    case 2: return launch<HD, 2>(a, rows, dynamic_bytes, s);
    case 4: return launch<HD, 4>(a, rows, dynamic_bytes, s);
    case 8: return launch<HD, 8>(a, rows, dynamic_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Rows>
int launch_dims(int head_dim, int groups, const Args& a, Rows rows,
                int dynamic_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_groups<64>(groups, a, rows, dynamic_bytes, s);
    case 128: return launch_groups<128>(groups, a, rows, dynamic_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The verify rows of a launch: queries per block (S * G), the head period
// H of the [S, H] row order and the rows per batch row (S * H).
struct VerifyShape {
  int groups, n_queries, period, n_rows;
};

template <int HD, typename QT, typename KV, typename Rows>
int launch_verify_typed(const Args& a, const VerifyShape& shape, Rows rows,
                        int table_bytes, cudaStream_t stream) {
  auto kernel = flash_verify_kernel<HD, QT, KV, Rows>;
  const int bytes = VerifySmem<HD, KV>::bytes(shape.n_queries) + table_bytes;
  const cudaError_t status = allow_shared(kernel, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<dim3(a.n_kv, a.batch), kThreads, bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int32_t*>(a.lengths), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), shape.groups,
      shape.n_queries, shape.period, shape.n_rows, a.t_len, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename Rows>
int launch_verify_types(const Args& a, const VerifyShape& shape, Rows rows,
                        int table_bytes, cudaStream_t s) {
  if (a.q_bf16 && a.kv_int8)
    return launch_verify_typed<HD, __nv_bfloat16, int8_t>(a, shape, rows,
                                                          table_bytes, s);
  if (a.q_bf16)
    return launch_verify_typed<HD, __nv_bfloat16, __nv_bfloat16>(
        a, shape, rows, table_bytes, s);
  if (a.kv_int8)
    return launch_verify_typed<HD, float, int8_t>(a, shape, rows,
                                                  table_bytes, s);
  return launch_verify_typed<HD, float, __nv_bfloat16>(a, shape, rows,
                                                       table_bytes, s);
}

template <typename Rows>
int launch_verify(int head_dim, const Args& a, const VerifyShape& shape,
                  Rows rows, int table_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (shape.n_queries < 1 || shape.n_queries > kMaxVerifyQueries
      || shape.groups < 1 || shape.period % shape.groups
      || shape.n_rows % shape.period)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64: return launch_verify_types<64>(a, shape, rows, table_bytes, s);
    case 128: return launch_verify_types<128>(a, shape, rows, table_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Flat form (kernels #1 and #2): k/v point at a [B, T, C] view whose rows
// sit at b * stride_b + t * stride_t elements; for an int8 payload
// (kv_int8 = 1) k_scale/v_scale point at its [B, T, K] f32 scales, rows
// b * sstride_b + t * sstride_t floats apart (null for bf16).
extern "C" int aiko_flash_decode(const void* q, int q_bf16, int kv_int8,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* lengths, void* acc, void* m,
                                 void* l, int batch, int n_kv, int groups,
                                 int head_dim, int t_len, long long stride_b,
                                 long long stride_t, long long sstride_b,
                                 long long sstride_t, void* stream) {
  const Args a{q, q_bf16, kv_int8, k, v, k_scale, v_scale, lengths, acc, m,
               l, batch, n_kv, t_len};
  const FlatRows rows{stride_b, stride_t, sstride_b, sstride_t};
  return launch_dims(head_dim, groups, a, rows, 0, stream);
}

// Paged form (kernel #3): k/v point at one layer of the pools, [P, pt, C]
// with rows page_stride and stride_t elements apart; table is [B, pps].
// An int8 payload's scales are one layer of the [P, pt, K] scale pools,
// spage_stride and sstride_t floats apart.
extern "C" int aiko_flash_decode_paged(
    const void* q, int q_bf16, int kv_int8, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* acc, void* m, void* l, int batch, int n_kv,
    int groups, int head_dim, int pps, int page_tokens, int n_pages,
    long long page_stride, long long stride_t, long long spage_stride,
    long long sstride_t, void* stream) {
  const Args a{q, q_bf16, kv_int8, k, v, k_scale, v_scale, lengths, acc, m,
               l, batch, n_kv, pps * page_tokens};
  const PagedRows rows{page_stride, stride_t, spage_stride, sstride_t,
                       static_cast<const int32_t*>(table), pps, page_tokens,
                       n_pages};
  return launch_dims(head_dim, groups, a, rows,
                     pps * static_cast<int>(sizeof(int)), stream);
}

// Chunk verify, flat form: q is [B, n_rows, HD] in [S, H] row order
// (period = H, n_rows = S * H); the cache arguments are those of
// aiko_flash_decode and lengths holds each row's verify start.
extern "C" int aiko_flash_verify(
    const void* q, int q_bf16, int kv_int8, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lengths, void* acc,
    void* m, void* l, int batch, int n_kv, int groups, int head_dim,
    int n_queries, int period, int n_rows, int t_len, long long stride_b,
    long long stride_t, long long sstride_b, long long sstride_t,
    void* stream) {
  const Args a{q, q_bf16, kv_int8, k, v, k_scale, v_scale, lengths, acc, m,
               l, batch, n_kv, t_len};
  const VerifyShape shape{groups, n_queries, period, n_rows};
  const FlatRows rows{stride_b, stride_t, sstride_b, sstride_t};
  return launch_verify(head_dim, a, shape, rows, 0, stream);
}

// Chunk verify, paged form: the queries of aiko_flash_verify, the pools
// and table of aiko_flash_decode_paged.
extern "C" int aiko_flash_verify_paged(
    const void* q, int q_bf16, int kv_int8, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* acc, void* m, void* l, int batch, int n_kv,
    int groups, int head_dim, int n_queries, int period, int n_rows, int pps,
    int page_tokens, int n_pages, long long page_stride, long long stride_t,
    long long spage_stride, long long sstride_t, void* stream) {
  const Args a{q, q_bf16, kv_int8, k, v, k_scale, v_scale, lengths, acc, m,
               l, batch, n_kv, pps * page_tokens};
  const VerifyShape shape{groups, n_queries, period, n_rows};
  const PagedRows rows{page_stride, stride_t, spage_stride, sstride_t,
                       static_cast<const int32_t*>(table), pps, page_tokens,
                       n_pages};
  return launch_verify(head_dim, a, shape, rows,
                       pps * static_cast<int>(sizeof(int)), stream);
}

extern "C" const char* aiko_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
