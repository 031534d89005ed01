// Causal blockwise prefill attention with an online softmax and GQA.
//
// Replaces the TPU kernel flash_attention
// (aiko_services_tpu/ops/pallas_attention.py).  q [B, S, H, d] attends
// k/v [B, T, K, d] (H = K * G); query row s sits at absolute position
// q_offset + s, so a prompt chunk attends the slot row written so far and
// the causal mask hides the unwritten tail.
//
// What bounds it on an H100: operations.  The last 512-token chunk of a
// 2048-token prompt at llama3-8b is ~15 GFLOP per layer against ~10 MB of
// q/k/v/out, far above the ridge.  This first kernel runs its products as
// plain f32 FMAs from shared memory, so it is held to the card's f32 rate,
// not its tensor-core rate; tensor cores (mma.sync / wgmma) are the next
// step, in a later change.
//
// Design:
//  - The TPU kernel carries (m, l, acc) across the sequential KV grid
//    axis in VMEM scratch.  Here one block owns 64 query rows and loops
//    over the KV tiles itself, holding m, l and acc in registers.
//  - GQA: the 64 rows of a block are the G query heads of one kv head at
//    64/G consecutive positions, so each K/V tile is loaded once for the
//    whole group.
//  - Causal skip: KV tiles past the block's last query position are never
//    loaded (the TPU kernel clamped their DMA index for the same reason).
//  - Each thread owns 4 rows x 4 keys of the 64x64 score tile; the 16
//    threads of a row are one half-warp, so the row max and row sum are
//    shuffles.  P goes through shared memory (over the spent K tile) for
//    the PV product, where each thread owns its 4 rows x d/16 dims.
//  - Numerics follow the TPU kernel: f32 scores; the scale is folded into
//    q by the caller when it is a power of two, else applied to the f32
//    scores; exp(s - m) is taken in the value dtype (bf16 for bf16
//    inputs); l sums those weights in f32; out = acc / max(l, 1e-30).
#include "common.cuh"

namespace {

using aiko::kNegInf;
constexpr int kThreads = 256;
constexpr int kRows = 64;    // query rows per block (G heads x 64/G positions)
constexpr int kKeys = 64;    // keys per tile

template <int D>
constexpr int smem_bytes() {
  return (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D) * 4;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int seq, int n_heads, int n_kv, int kv_len,
                       int q_offset, int causal, float scale,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  static_assert(DP >= kKeys + 1, "P tile reuses the K tile's space");
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kRows][DP]
  float* k_s = q_s + kRows * DP;        // [kKeys][DP], then P [kRows][65]
  float* v_s = k_s + kKeys * DP;        // [kKeys][D]

  const int groups = n_heads / n_kv;
  const int bq = kRows / groups;        // positions per block
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  const T* qb = q + b * q_sb;
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int s = q0 + r % bq;
    const int h = kvh * groups + r / bq;
    q_s[r * DP + d] = s < seq ? aiko::to_float(qb[s * q_ss + h * q_sh + d])
                              : 0.f;
  }

  int qpos[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_offset + q0 + (tr + 16 * i) % bq;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int k_end = causal ? min(kv_len, q_offset + q0 + bq) : kv_len;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * k_sb + kvh * k_sh;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();    // the previous tile's P and V are spent
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      const int t = k0 + r;
      const bool live = t < kv_len;
      k_s[r * DP + d] = live ? aiko::to_float(kb[t * k_st + d]) : 0.f;
      v_s[r * D + d] = live ? aiko::to_float(vb[t * k_st + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(tr + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = k_s[(tc + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        valid[j] = kpos < kv_len && (!causal || kpos <= qpos[i]);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = valid[j]
            ? aiko::round_to<T>(expf(aiko::round_to<T>(s[i][j] - m_safe)))
            : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_safe);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }

    __syncthreads();    // every thread is done reading K
    float* p_s = k_s;   // [kRows][kKeys + 1]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(tr + 16 * i) * (kKeys + 1) + tc + 16 * j] = p[i][j];
    __syncthreads();
    const int keys = min(kKeys, k_end - k0);
    for (int c = 0; c < keys; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(tr + 16 * i) * (kKeys + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = v_s[c * D + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = out + b * q_sb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int s_pos = q0 + r % bq;
    if (s_pos >= seq) continue;
    const int h = kvh * groups + r / bq;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[s_pos * q_ss + h * q_sh + tc + 16 * j] =
          aiko::from_float<T>(acc[i][j] * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int n_heads, int n_kv, int kv_len, int q_offset,
           int causal, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_st, long long k_sh,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D, T>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int bq = kRows / (n_heads / n_kv);
  const dim3 grid((seq + bq - 1) / bq, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, n_heads, n_kv,
      kv_len, q_offset, causal, scale, q_sb, q_ss, q_sh, k_sb, k_st, k_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int aiko_flash_attention(
    const void* q, const void* k, const void* v, void* out, int is_bf16,
    int head_dim, int batch, int seq, int n_heads, int n_kv, int kv_len,
    int q_offset, int causal, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_heads % n_kv || kRows % (n_heads / n_kv))
    return static_cast<int>(cudaErrorInvalidValue);
#define AIKO_LAUNCH(D, T)                                                    \
  return launch<D, T>(q, k, v, out, batch, seq, n_heads, n_kv, kv_len,       \
                      q_offset, causal, scale, q_sb, q_ss, q_sh, k_sb, k_st, \
                      k_sh, s)
  if (head_dim == 128) {
    if (is_bf16) AIKO_LAUNCH(128, __nv_bfloat16);
    AIKO_LAUNCH(128, float);
  }
  if (head_dim == 64) {
    if (is_bf16) AIKO_LAUNCH(64, __nv_bfloat16);
    AIKO_LAUNCH(64, float);
  }
#undef AIKO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
