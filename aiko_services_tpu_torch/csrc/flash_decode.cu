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

extern "C" const char* aiko_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
