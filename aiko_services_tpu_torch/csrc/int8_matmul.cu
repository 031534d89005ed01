// Weight-only int8 matmul: out[M, F] = (x[M, D] @ w[D, F]) * scale[F],
// x and out bf16, w int8, one f32 scale per output column.  Replaces the
// TPU kernel int8_matmul (aiko_services_tpu/ops/pallas_matmul.py:73,
// kernel #5).
//
// What bounds it on an H100:
//  - decode (M = 8 rows): bytes.  The int8 weight is read once (the
//    Llama-3-8B unembed is 525 MB: 0.157 ms at 3.35 TB/s, half the bf16
//    weight's 0.31 ms) and each weight byte feeds 2 * M = 16 operations,
//    far below the card's ~295 operations a byte;
//  - admission (M = 512, the prefill unembed): operations, 0.54 TFLOP a
//    chunk, 0.54 ms at the bf16 tensor-core peak.
//
// Design:
//  - The TPU kernel streams int8 weight tiles into VMEM, casts them on the
//    way into the MXU and carries an f32 accumulator across a sequential
//    contraction axis of its grid.  Here one block owns one BM x BN output
//    tile and loops over D itself: x (bf16, 16-byte loads) and w (int8,
//    16-byte loads: half the bytes of bf16) are read from device memory
//    into registers, the int8 codes are converted to bf16 on their way
//    into shared memory (exact: |code| <= 127), and nvcuda::wmma
//    16x16x16 bf16 fragments accumulate in f32.  The next tile's loads
//    are issued before the current tile's products, so one tile of
//    loads is always in flight.
//  - The per-column scale multiplies the f32 accumulator once, at the
//    store: no dequantized weight and no unscaled product ever exist in
//    device memory.
//  - Two tile shapes, picked by M: 16 x 64 with a 256-deep contraction
//    tile for decode (M <= 16, padded with zero rows; the deep tile keeps
//    16 KB of weight loads in flight per block), and 64 x 128 with a
//    64-deep tile and 2 x 4 warps for admission.
//  - Ragged edges: rows past M and columns of x past D load as zeros;
//    D must be a multiple of 8 and F of 16 (whole 16-byte vectors), the
//    wrapper checks both.
//
// Known limits (a later change): no TMA / wgmma pipeline, and at M = 8
// the layer weights with few column tiles (wk/wv: 16 blocks) leave most
// SMs idle; a split of D across blocks would fill them.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

// Two int8 codes -> their packed bf16 pair, low element first (exact for
// |code| <= 127).
__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__int2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__int2bfloat16_rn(hi))) << 16);
}

// Sixteen int8 codes (one 16-byte load) -> sixteen bf16 (two 16-byte
// stores), in address order.
__device__ __forceinline__ void codes_to_bf16(uint4 codes, uint4& lo,
                                              uint4& hi) {
  const uint32_t words[4] = {codes.x, codes.y, codes.z, codes.w};
  uint32_t pairs[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t word = words[j];
    pairs[2 * j] = bf16_pair(static_cast<int32_t>(word << 24) >> 24,
                             static_cast<int32_t>(word << 16) >> 24);
    pairs[2 * j + 1] = bf16_pair(static_cast<int32_t>(word << 8) >> 24,
                                 static_cast<int32_t>(word) >> 24);
  }
  lo = make_uint4(pairs[0], pairs[1], pairs[2], pairs[3]);
  hi = make_uint4(pairs[4], pairs[5], pairs[6], pairs[7]);
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct Tile {
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kWarpM = BM / WARPS_M;     // rows of a warp's tile
  static constexpr int kWarpN = BN / WARPS_N;     // columns of a warp's tile
  static constexpr int kFragM = kWarpM / 16;
  static constexpr int kFragN = kWarpN / 16;
  // Row pitches in shared memory, padded against bank conflicts (multiples
  // of 8 bf16 / 4 f32 elements, as wmma's ldm requires).
  static constexpr int kXPitch = BK + 8;
  static constexpr int kWPitch = BN + 8;
  static constexpr int kCPitch = BN + 4;
  static constexpr int kXVecs = BM * BK / 8 / kThreads;    // bf16 x8 loads
  static constexpr int kWVecs = BK * BN / 16 / kThreads;   // int8 x16 loads
  static constexpr int kOperandBytes = (BM * kXPitch + BK * kWPitch) * 2;
  static constexpr int kEpilogueBytes = BM * kCPitch * 4;
  static constexpr int kSharedBytes =
      kOperandBytes > kEpilogueBytes ? kOperandBytes : kEpilogueBytes;
  static_assert(BM % (16 * WARPS_M) == 0 && BN % (16 * WARPS_N) == 0,
                "warp tiles are whole 16x16 fragments");
  static_assert((BM * BK) % (8 * kThreads) == 0, "x tile splits evenly");
  static_assert((BK * BN) % (16 * kThreads) == 0, "w tile splits evenly");
  static_assert(kSharedBytes <= 48 * 1024, "static shared memory");
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // [M, D]
                   const int8_t* __restrict__ w,          // [D, F]
                   const float* __restrict__ scale,       // [F]
                   __nv_bfloat16* __restrict__ out,       // [M, F]
                   int m, int d, int f) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N>;
  __shared__ __align__(128) unsigned char smem[T::kSharedBytes];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + BM * T::kXPitch;
  float* cs = reinterpret_cast<float*>(smem);   // epilogue, after the loop

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFragM]
                                                           [T::kFragN];
#pragma unroll
  for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 x_regs[T::kXVecs];
  uint4 w_regs[T::kWVecs];
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::kXVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      const int row = v / (BK / 8);
      const int col = (v % (BK / 8)) * 8;
      const int gm = m0 + row, gk = k0 + col;
      x_regs[i] = (gm < m && gk < d)
          ? *reinterpret_cast<const uint4*>(x + (long long)gm * d + gk)
          : zero;
    }
#pragma unroll
    for (int i = 0; i < T::kWVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      const int row = v / (BN / 16);
      const int col = (v % (BN / 16)) * 16;
      const int gk = k0 + row, gn = n0 + col;
      w_regs[i] = (gk < d && gn < f)
          ? *reinterpret_cast<const uint4*>(w + (long long)gk * f + gn)
          : zero;
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < T::kXVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      const int row = v / (BK / 8);
      const int col = (v % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + row * T::kXPitch + col) = x_regs[i];
    }
#pragma unroll
    for (int i = 0; i < T::kWVecs; ++i) {
      const int v = threadIdx.x + i * T::kThreads;
      const int row = v / (BN / 16);
      const int col = (v % (BN / 16)) * 16;
      uint4* dst = reinterpret_cast<uint4*>(ws + row * T::kWPitch + col);
      codes_to_bf16(w_regs[i], dst[0], dst[1]);
    }
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < d) load(k0 + BK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[T::kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[T::kFragN];
#pragma unroll
      for (int i = 0; i < T::kFragM; ++i)
        wmma::load_matrix_sync(
            a[i], xs + (warp_m * T::kWarpM + i * 16) * T::kXPitch + kk,
            T::kXPitch);
#pragma unroll
      for (int j = 0; j < T::kFragN; ++j)
        wmma::load_matrix_sync(
            b[j], ws + kk * T::kWPitch + warp_n * T::kWarpN + j * 16,
            T::kWPitch);
#pragma unroll
      for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
        for (int j = 0; j < T::kFragN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragN; ++j)
      wmma::store_matrix_sync(
          cs + (warp_m * T::kWarpM + i * 16) * T::kCPitch
              + warp_n * T::kWarpN + j * 16,
          acc[i][j], T::kCPitch, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += T::kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < m && gn < f)
      out[(long long)gm * f + gn] =
          __float2bfloat16_rn(cs[r * T::kCPitch + c] * scale[gn]);
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
int launch(const void* x, const void* w, const void* scale, void* out,
           int m, int d, int f, void* stream) {
  const dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  int8_matmul_kernel<BM, BN, BK, WARPS_M, WARPS_N>
      <<<grid, 32 * WARPS_M * WARPS_N, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int8_t*>(w), static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), m, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, D] bf16 row-major, w [D, F] int8 row-major, scale [F] f32, out
// [M, F] bf16; D % 8 == 0, F % 16 == 0, every pointer 16-byte aligned.
extern "C" int aiko_int8_matmul(const void* x, const void* w,
                                const void* scale, void* out, int m, int d,
                                int f, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || d % 8 || f % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 16) return launch<16, 64, 256, 1, 4>(x, w, scale, out, m, d, f,
                                                stream);
  return launch<64, 128, 64, 2, 4>(x, w, scale, out, m, d, f, stream);
}
