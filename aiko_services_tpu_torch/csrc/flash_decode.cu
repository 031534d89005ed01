// Split-K decode attention over one layer of the layer-stacked KV cache.
//
// Replaces the TPU kernel flash_decode_attention_stacked
// (aiko_services_tpu/ops/pallas_decode.py).  One query token per batch
// row attends the first lengths[b] positions of its row of cache[layer];
// the result is the unnormalised online-softmax state (acc, m, l) that
// the caller merges with the current token's own k/v.
//
// What bounds it on an H100: bytes.  Each launch streams the live part of
// one layer's K and V (at B=8, T=2048, K*hd=1024, bf16: 64 MiB) and does
// ~4 FLOP per cached element, far below the card's ~295 FLOP/byte ridge.
//
// Design:
//  - The TPU kernel carries (m, l, acc) across a sequential grid axis in
//    VMEM.  Hopper blocks run in no order, so one block owns one
//    (batch row, kv head) pair and loops over T itself, 64 positions per
//    tile, keeping m and l in shared memory and acc in registers.
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
//
// Known limit: B * K blocks (64 at llama3-8b with 8 slots) leave about
// half of the 132 SMs idle.  Splitting T across blocks with a second
// combine pass is the next step (a later change).
#include "common.cuh"

namespace {

using aiko::kNegInf;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;

template <int HD, int G, typename QT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q,              // [B, H, HD]
                    const __nv_bfloat16* __restrict__ k,   // cache[layer]
                    const __nv_bfloat16* __restrict__ v,
                    const int32_t* __restrict__ lengths,   // [B]
                    float* __restrict__ acc_out,           // [B, H, HD]
                    float* __restrict__ m_out,             // [B, H]
                    float* __restrict__ l_out,             // [B, H]
                    int n_kv, int t_len, long long stride_b,
                    long long stride_t) {
  constexpr int LPR = HD / 16;     // lanes sharing one row (score phase)
  constexpr int RPW = 32 / LPR;    // rows a warp scores per pass
  constexpr int DPL = HD / 32;     // dims a lane owns (PV phase)
  __shared__ float p_s[G][kTile];
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ float red_s[kWarps][G][HD];

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
  __syncthreads();

  const __nv_bfloat16* kb = k + b * stride_b + kvh * HD;
  const __nv_bfloat16* vb = v + b * stride_b + kvh * HD;
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
        aiko::load_vec<16>(kb + t * stride_t + sub * 16, kf);
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
#pragma unroll
        for (int g = 0; g < G; ++g)
          p_s[g][r0 + rsub] = t < length ? part[g] : kNegInf;
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
      p_s[g][lane] = aiko::round_to<QT>(p0);
      p_s[g][lane + 32] = aiko::round_to<QT>(p1);
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
      aiko::load_vec<DPL>(vb + t * stride_t + lane * DPL, vf);
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

template <int HD, int G>
int launch(const void* q, int q_bf16, const void* k, const void* v,
           const void* lengths, void* acc, void* m, void* l, int batch,
           int n_kv, int t_len, long long stride_b, long long stride_t,
           cudaStream_t stream) {
  const dim3 grid(n_kv, batch);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* lp = static_cast<const int32_t*>(lengths);
  if (q_bf16) {
    flash_decode_kernel<HD, G, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), kp, vp, lp,
        static_cast<float*>(acc), static_cast<float*>(m),
        static_cast<float*>(l), n_kv, t_len, stride_b, stride_t);
  } else {
    flash_decode_kernel<HD, G, float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), kp, vp, lp,
        static_cast<float*>(acc), static_cast<float*>(m),
        static_cast<float*>(l), n_kv, t_len, stride_b, stride_t);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_groups(int groups, const void* q, int q_bf16, const void* k,
                  const void* v, const void* lengths, void* acc, void* m,
                  void* l, int batch, int n_kv, int t_len, long long stride_b,
                  long long stride_t, cudaStream_t stream) {
  switch (groups) {
    case 1: return launch<HD, 1>(q, q_bf16, k, v, lengths, acc, m, l,
                                 batch, n_kv, t_len, stride_b, stride_t, stream);
    case 2: return launch<HD, 2>(q, q_bf16, k, v, lengths, acc, m, l,
                                 batch, n_kv, t_len, stride_b, stride_t, stream);
    case 4: return launch<HD, 4>(q, q_bf16, k, v, lengths, acc, m, l,
                                 batch, n_kv, t_len, stride_b, stride_t, stream);
    case 8: return launch<HD, 8>(q, q_bf16, k, v, lengths, acc, m, l,
                                 batch, n_kv, t_len, stride_b, stride_t, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int aiko_flash_decode(const void* q, int q_bf16, const void* k,
                                 const void* v, const void* lengths, void* acc,
                                 void* m, void* l, int batch, int n_kv,
                                 int groups, int head_dim, int t_len,
                                 long long stride_b, long long stride_t,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_groups<64>(groups, q, q_bf16, k, v, lengths,
                                      acc, m, l, batch, n_kv, t_len, stride_b,
                                      stride_t, s);
    case 128: return launch_groups<128>(groups, q, q_bf16, k, v, lengths,
                                        acc, m, l, batch, n_kv, t_len,
                                        stride_b, stride_t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* aiko_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
