// Causal blockwise prefill attention with an online softmax and GQA.
//
// Replaces the TPU kernel flash_attention
// (aiko_services_tpu/ops/pallas_attention.py:138, called at :277).
// q [B, S, H, d] attends k/v [B, T, K, d] (H = K * G); query row s sits
// at absolute position q_offset + s, so a prompt chunk attends the slot
// row written so far and the causal mask hides the unwritten tail.
//
// What bounds it on an H100: operations.  The last 512-token chunk of a
// 2048-token prompt at llama3-8b is ~15 GFLOP per layer against ~10 MB
// of q/k/v/out, far above the ridge, so the products belong on the
// tensor cores (989 TFLOP/s bf16), and every K/V tile must arrive before
// the tensor cores want it.
//
// bf16 inputs (the serving path) -- the tensor-core body:
//  - Rows: a block owns 128 query rows, the G query heads of one kv head
//    at 128/G consecutive positions, so each K/V tile is loaded once for
//    the whole group.  Two warpgroups own 64 rows each; at S 512, G 4
//    that is 16 x 8 = 128 blocks, one wave on 132 SMs.
//  - Copies: a ring of two K/V stages (128 keys each) in shared memory,
//    filled by 16-byte cp.async copies into the 128-byte swizzled layout
//    (sm90.cuh); tile j + 2 streams in while tile j + 1 is computed.
//    Causal skip: tiles past the block's last position are never loaded;
//    only tiles that cross the diagonal or the end of the row are masked.
//  - S = Q K^T: wgmma m64n128k16, Q and K read from shared memory (both
//    K-major), f32 accumulators.
//  - Online softmax on the accumulator registers: a row lives in the 4
//    lanes of a quad, so its max is two shuffles; no shared memory.
//  - P V: P is rounded to bf16 pairs in registers, which is exactly the
//    register A operand of wgmma m64n{d}k16; V is the MN-major B operand
//    read from the same swizzled tile.
//
// f32 inputs keep the FMA body below (the tensor cores would round them
// to TF32): 64 rows a block, 4x4 register tiles, f32 FMAs from shared
// memory; held to the card's f32 rate.
//
// Numerics follow the TPU kernel in both bodies: f32 scores; the scale is
// folded into q by the caller when it is a power of two, else applied to
// the f32 scores; exp(s - m) is taken in the value dtype (bf16 for bf16
// inputs, also what the tensor cores consume); l sums those weights in
// f32; out = acc / max(l, 1e-30).
#include "common.cuh"
#include "sm90.cuh"

namespace {

using aiko::kNegInf;

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace aiko::sm90;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 128;      // query rows per block
constexpr int kKeys = 128;      // keys per K/V tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kQBytes = kRows * D * 2;    // [D/64][kRows][128 B]
  static constexpr int kTileBytes = kKeys * D * 2; // one K or V tile
  static constexpr int kBytes = kQBytes + kStages * 2 * kTileBytes + 1024;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       int seq, int n_heads, int n_kv, int kv_len,
                       int q_offset, int causal, float scale,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       const int* __restrict__ at) {
  using L = Layout<D>;
  constexpr int kChunks = D / 8;        // 16-byte chunks in a row
  constexpr int kO = D / 2;             // accumulator registers of P V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;   // slot s: K at 2s, V at 2s+1

  const int groups = n_heads / n_kv;
  const int bq = kRows / groups;        // positions per block
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // A captured admission reads its k/v row and offset from the card.
  const int kv_b = at ? at[0] : b;
  if (at) q_offset = at[1];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const __nv_bfloat16* qb = q + b * q_sb;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int s = q0 + r % bq;
    const int h = kvh * groups + r / bq;
    const bool live = s < seq;
    cp_async16(q_s + (c / 8) * (kRows * 128) + swizzled(r, c % 8),
               qb + (live ? s * q_ss + h * q_sh + c * 8 : 0), live);
  }
  const int k_end = causal ? min(kv_len, q_offset + min(q0 + bq, seq))
                           : kv_len;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const __nv_bfloat16* kb = k + kv_b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + kv_b * k_sb + kvh * k_sh;
  auto load_kv = [&](int tile, int slot) {
    const uint32_t ks = kv_s + (2 * slot) * L::kTileBytes;
    const uint32_t vs = ks + L::kTileBytes;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int t = tile * kKeys + r;
      const bool live = t < kv_len;
      const long long off = live ? t * k_st + c * 8 : 0;
      const uint32_t dst = (c / 8) * (kKeys * 128) + swizzled(r, c % 8);
      cp_async16(ks + dst, kb + off, live);
      cp_async16(vs + dst, vb + off, live);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();                    // group 0: Q and tile 0
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();                    // group 1: tile 1

  // This thread's two rows of the block: r0 and r0 + 8.
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int qpos[2] = {q_offset + q0 + r0 % bq,
                       q_offset + q0 + (r0 + 8) % bq};
  const int first_pos = q_offset + q0;
  float o[kO], sc[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % kStages;
    const int k0 = j * kKeys;
    const uint32_t ks = kv_s + (2 * slot) * L::kTileBytes;
    const uint32_t vs = ks + L::kTileBytes;
    cp_async_wait<1>();                 // this thread's copies of tile j
    fence_async_shared();
    __syncthreads();                    // ... and everyone's

    // S = Q K^T (128 keys): D/16 k-steps of m64n128k16.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;   // 16 columns of 128 bytes
      const uint64_t da = desc128(
          q_s + (kk / 4) * (kRows * 128) + wg * 64 * 128 + step, 0, 1024);
      const uint64_t db = desc128(ks + (kk / 4) * (kKeys * 128) + step, 0,
                                  1024);
      wgmma_ss<0>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Online softmax.  Register i: row (i / 2) % 2, key 8 (i / 4) +
    // 2 (lane % 4) + i % 2 of the tile.
    const bool masked = (causal && k0 + kKeys - 1 > first_pos)
                        || k0 + kKeys > kv_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale;
      if (masked) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (key >= kv_len || (causal && key > qpos[(i / 2) % 2]))
          x = kNegInf;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
      corr[r] = expf(m[r] - m_safe[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= corr[(i / 2) % 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // exp(round_bf16(s - m)) rounded to bf16: the weight the tensor
      // cores consume, and the one l sums.
      const float ms = m_safe[i % 2];
      const uint32_t x = pack_bf16(sc[2 * i] - ms, sc[2 * i + 1] - ms);
      const uint32_t e = pack_bf16(exp2_approx(bf16_lo(x) * kLog2e),
                                   exp2_approx(bf16_hi(x) * kLog2e));
      l[i % 2] += bf16_lo(e) + bf16_hi(e);
      p[i] = e;
    }

    // O += P V: 8 k-steps of m64n{D}k16, P from registers, V MN-major.
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = desc128(vs + kk * 2048, kKeys * 128, 1024);
      wgmma_rs<1>(o, p + 4 * kk, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();                    // both warpgroups are done with slot
    if (j + kStages < n_tiles) load_kv(j + kStages, slot);
    cp_async_commit();
  }

  cp_async_wait<0>();
  __nv_bfloat16* ob = out + b * q_sb;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int s = q0 + row % bq;
    if (s >= seq) continue;
    const int h = kvh * groups + row / bq;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = ob + s * q_ss + h * q_sh + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int n_heads, int n_kv, int kv_len, int q_offset,
           int causal, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_st, long long k_sh,
           const int* at, cudaStream_t stream) {
  if (kRows % (n_heads / n_kv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel<D>;
  constexpr int bytes = Layout<D>::kBytes;
  static int configured[aiko::kMaxDevices] = {};
  const cudaError_t status =
      aiko::raise_smem_limit(kernel, bytes, configured);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int bq = kRows / (n_heads / n_kv);
  const dim3 grid((seq + bq - 1) / bq, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      seq, n_heads, n_kv, kv_len, q_offset, causal, scale, q_sb, q_ss, q_sh,
      k_sb, k_st, k_sh, at);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: FMAs from shared memory
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kThreads = 256;
constexpr int kRows = 64;    // query rows per block (G heads x 64/G positions)
constexpr int kKeys = 64;    // keys per tile

// Each thread owns 4 rows x 4 keys of the 64x64 score tile; the 16
// threads of a row are one half-warp, so the row max and row sum are
// shuffles.  P goes through shared memory (over the spent K tile) for
// the PV product, where each thread owns its 4 rows x d/16 dims.
template <int D>
constexpr int smem_bytes() {
  return (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int seq, int n_heads, int n_kv, int kv_len,
                       int q_offset, int causal, float scale,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       const int* __restrict__ at) {
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
  const int kv_b = at ? at[0] : b;
  if (at) q_offset = at[1];
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  const float* qb = q + b * q_sb;
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int s = q0 + r % bq;
    const int h = kvh * groups + r / bq;
    q_s[r * DP + d] = s < seq ? qb[s * q_ss + h * q_sh + d] : 0.f;
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
  const float* kb = k + kv_b * k_sb + kvh * k_sh;
  const float* vb = v + kv_b * k_sb + kvh * k_sh;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();    // the previous tile's P and V are spent
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      const int t = k0 + r;
      const bool live = t < kv_len;
      k_s[r * DP + d] = live ? kb[t * k_st + d] : 0.f;
      v_s[r * D + d] = live ? vb[t * k_st + d] : 0.f;
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
        p[i][j] = valid[j] ? expf(s[i][j] - m_safe) : 0.f;
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

  float* ob = out + b * q_sb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int s_pos = q0 + r % bq;
    if (s_pos >= seq) continue;
    const int h = kvh * groups + r / bq;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[s_pos * q_ss + h * q_sh + tc + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int n_heads, int n_kv, int kv_len, int q_offset,
           int causal, float scale, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_st, long long k_sh,
           const int* at, cudaStream_t stream) {
  if (kRows % (n_heads / n_kv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel<D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int bq = kRows / (n_heads / n_kv);
  const dim3 grid((seq + bq - 1) / bq, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), seq, n_heads,
      n_kv, kv_len, q_offset, causal, scale, q_sb, q_ss, q_sh, k_sb, k_st,
      k_sh, at);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

}  // namespace

// bf16 inputs take the tensor-core body (G must divide 128; k/v rows and
// the k/v/q pointers 16-byte aligned), f32 inputs the FMA body (G must
// divide 64).  ``at`` is null, or two ints on the card, (k/v batch row,
// q_offset), that every block reads at its start in place of its own
// batch index and ``q_offset``: a launch captured in a CUDA graph then
// serves any cache row and offset (q and out keep batch 1).  The grid
// depends only on seq, n_heads and n_kv either way.
extern "C" int aiko_flash_attention(
    const void* q, const void* k, const void* v, void* out, int is_bf16,
    int head_dim, int batch, int seq, int n_heads, int n_kv, int kv_len,
    int q_offset, int causal, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    const void* at, void* stream) {
  auto row_offset = static_cast<const int*>(at);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_kv <= 0 || n_heads % n_kv)
    return static_cast<int>(cudaErrorInvalidValue);
#define AIKO_LAUNCH(NS, D)                                                   \
  return NS::launch<D>(q, k, v, out, batch, seq, n_heads, n_kv, kv_len,      \
                       q_offset, causal, scale, q_sb, q_ss, q_sh, k_sb, k_st, \
                       k_sh, row_offset, s)
  if (head_dim == 128) {
    if (is_bf16) AIKO_LAUNCH(tc, 128);
    AIKO_LAUNCH(fp32, 128);
  }
  if (head_dim == 64) {
    if (is_bf16) AIKO_LAUNCH(tc, 64);
    AIKO_LAUNCH(fp32, 64);
  }
#undef AIKO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
