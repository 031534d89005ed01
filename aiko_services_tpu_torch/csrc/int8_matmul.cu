// Weight-only int8 matmul: out[M, F] = (x[M, D] @ w[D, F]) * scale[F],
// x and out bf16, w int8, one f32 scale per output column.  Replaces the
// TPU kernel int8_matmul (aiko_services_tpu/ops/pallas_matmul.py:73,
// called at :117; kernel #5).
//
// What bounds it on an H100 (the shapes' ideal):
//  - decode (M <= 16 rows): bytes.  The int8 weight is read once (the
//    Llama-3-8B unembed is 525 MB: 0.157 ms at 3.35 TB/s, half the bf16
//    weight's 0.31 ms) and each weight byte feeds 2 * M operations, far
//    below the card's ~295 operations a byte;
//  - admission (M = 512 rows of a prompt chunk) and the verify forward
//    (M = 40): operations at M 512 (the prefill unembed is 0.54 TFLOP,
//    0.54 ms at the bf16 tensor-core peak), bytes at M 40.
//
// Two bodies, picked by M.
//
// M <= 16, the decode route: one block owns a 16 x 64 output tile and a
// 256-deep contraction tile (16 KB of weight loads in flight per block);
// x and w are read into registers with 16-byte loads, the int8 codes are
// widened to bf16 on their way into shared memory, and nvcuda::wmma
// 16x16x16 fragments accumulate in f32.  The next tile's loads are issued
// before the current tile's products.
//
// M > 16, the admission route: warp-specialised tensor-core tiles.
//  - Copies: one producer thread keeps TMA loads in flight, into rings of
//    shared memory: x as bf16 (BM x 64, 128-byte swizzled: the K-major A
//    operand, STAGES - 2 steps ahead) and w as raw int8 (64 x BN, half
//    the bytes of bf16, 3 steps ahead).  Tensor maps are encoded on the
//    host at each launch (cuTensorMapEncodeTiled, looked up with
//    cudaGetDriverEntryPoint: no libcuda link) from the launch's
//    pointers, so a captured graph replays them while its buffers stay
//    put.
//  - Widening: the producer warpgroup(s) widen each raw stage into a bf16
//    B tile (swizzled, MN-major), exactly (|code| <= 127) and with integer
//    ops and one bf16 add per pair: a byte permute and two 3-input
//    logic ops build 128 + (v & 127) and -128 or -256, whose sum is v.
//    No dequantized weight reaches device memory.
//  - Products: one or two consumer warpgroups run wgmma m64n{BN}k16
//    from shared memory, f32 accumulators; mbarriers hand stages between
//    producer and consumers (x landed, B widened, stage read).
//  - Tiles by shape: the widest of 128 x 256, 128 x 128 (two producer
//    warpgroups), 64 x 128 that gives >= 120 blocks, else 64 x 64
//    (narrow outputs, e.g. wk/wv at F 1,024, and the verify forward's
//    M 40); blocks that share a column tile of w run next to each other
//    (M tiles on grid x), so the weight streams from device memory about
//    once.
//  - What bounds it: the widening, which adds ~4 instructions a pair and
//    48 KB of shared-memory traffic a 128 x 256 stage to the products'
//    80 KB, on one producer warpgroup.
//  - Epilogue: the per-column scale multiplies the f32 accumulator once,
//    at the store.
//
// Both bodies: rows past M and columns of x past D load as zeros; D must
// be a multiple of 8 and F of 16 (whole 16-byte vectors), the wrapper
// checks both.
#include <cuda.h>
#include <mma.h>

#include "common.cuh"
#include "sm90.cuh"

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


// ---------------------------------------------------------------------------
// M > 16: tensor cores (wgmma), a producer warpgroup, an mbarrier ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace aiko::sm90;

constexpr int kBK = 64;      // contraction step: one 128-byte row of x
constexpr int kRaw = 4;      // raw int8 w stages: loads run 3 steps ahead

// WGS consumer warpgroups (BM = 64 WGS rows), PRODUCERS producer
// warpgroups, BN columns, STAGES operand stages [x tile | widened B tile].
template <int WGS, int BN, int STAGES, int PRODUCERS>
struct Layout {
  static constexpr int kBM = 64 * WGS;
  static constexpr int kProducerThreads = 128 * PRODUCERS;
  static constexpr int kThreads = 128 * WGS + kProducerThreads;
  static constexpr int kXBytes = kBM * 128;     // bf16 [BM][64], swizzled
  static constexpr int kBBytes = kBK * BN * 2;  // bf16 [BN/64][64][64]
  static constexpr int kWBytes = kBK * BN;      // int8 [64][BN]
  static constexpr int kPieces = kBK * BN / 8 / kProducerThreads;
  static constexpr int kBarriers = 3 * STAGES + kRaw;
  static constexpr int kBytes = STAGES * (kXBytes + kBBytes)
                                + kRaw * kWBytes + 8 * kBarriers + 1024;
  static_assert(BN % 64 == 0 && BN <= 256, "B tile: 64-column blocks");
  static_assert(STAGES >= 3, "x runs STAGES - 2 steps ahead");
  static_assert(kBytes <= 227 * 1024, "shared memory of one block");
};

// Two int8 codes, each in the low byte of a 16-bit lane -> the packed
// bf16 pair of their values, exactly: 128 + (v & 127) and -128 or -256
// (v < 0) are both exact bf16 bit patterns, and so is their sum v.
// Each mask-and-merge is one 3-input lop3 (the compiler splits the C
// form into two instructions, one per constant).
__device__ __forceinline__ uint32_t widen_pair(uint32_t lanes) {
  uint32_t hi7, sign;
  asm("lop3.b32 %0, %1, 0x007F007F, 0x43004300, 0xEA;\n"   // (a & b) | c
      : "=r"(hi7) : "r"(lanes));
  asm("lop3.b32 %0, %1, 0x00800080, 0xC300C300, 0x6A;\n"   // (a & b) ^ c
      : "=r"(sign) : "r"(lanes));
  const __nv_bfloat162 sum =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&hi7),
              *reinterpret_cast<const __nv_bfloat162*>(&sign));
  return *reinterpret_cast<const uint32_t*>(&sum);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Arrive and expect `bytes` of TMA transfers to complete the phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
// TMA: the box of `map` at (c0 inner, c1 outer) -> shared memory at dst,
// completing on `bar`; parts outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}
// Barrier among the producer warpgroups' threads only.
template <int THREADS> __device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

template <int WGS, int BN, int STAGES, int PRODUCERS>
__global__ void __launch_bounds__(128 * (WGS + PRODUCERS), 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap x_map,  // [M, D]
                   const __grid_constant__ CUtensorMap w_map,  // [D, F]
                   const float* __restrict__ scale,            // [F]
                   __nv_bfloat16* __restrict__ out,            // [M, F]
                   int m, int d, int f) {
  using L = Layout<WGS, BN, STAGES, PRODUCERS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t xs = base;                          // x stages
  const uint32_t bs = xs + STAGES * L::kXBytes;      // B stages
  const uint32_t ws = bs + STAGES * L::kBBytes;      // raw w stages
  const uint32_t x_ready = ws + kRaw * L::kWBytes;   // STAGES: TMA of x
  const uint32_t full = x_ready + 8 * STAGES;        // STAGES: B widened
  const uint32_t empty = full + 8 * STAGES;          // STAGES: read
  const uint32_t w_ready = empty + 8 * STAGES;       // kRaw: TMA of w

  const int m0 = blockIdx.x * L::kBM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n_k = (d + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(x_ready + 8 * s, 1);
      mbar_init(full + 8 * s, L::kProducerThreads);
      mbar_init(empty + 8 * s, 4 * WGS);    // every consumer warp
    }
    for (int s = 0; s < kRaw; ++s) mbar_init(w_ready + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= WGS) {
    // Producers.  Thread 0 keeps TMA loads in flight: x of step
    // kt + STAGES - 2 (once the consumers released that stage) and the
    // raw w of step kt + kRaw - 1.  Every producer thread widens its
    // pieces of raw w(kt) into B(kt), 8 codes a piece (a quarter-warp
    // stores one 128-byte row of a column block: conflict-free), then
    // publishes B(kt) on full[].
    const int t = tid - 128 * WGS;
    constexpr int kAhead = STAGES - 2;
    constexpr int kStep = L::kProducerThreads;
    auto load_x = [&](int kt) {
      const int slot = kt % STAGES;
      if (kt >= STAGES)
        mbar_wait(empty + 8 * slot, (kt / STAGES - 1) & 1);
      mbar_expect(x_ready + 8 * slot, L::kXBytes);
      tma_load(xs + slot * L::kXBytes, x_map, kt * kBK, m0,
               x_ready + 8 * slot);
    };
    auto load_w = [&](int kt) {
      const int slot = kt % kRaw;
      mbar_expect(w_ready + 8 * slot, L::kWBytes);
      tma_load(ws + slot * L::kWBytes, w_map, n0, kt * kBK,
               w_ready + 8 * slot);
    };
    if (t == 0) {
      for (int kt = 0; kt < kAhead && kt < n_k; ++kt) load_x(kt);
      for (int kt = 0; kt < kRaw - 1 && kt < n_k; ++kt) load_w(kt);
    }
    uint32_t raw_off[L::kPieces], b_off[L::kPieces];
#pragma unroll
    for (int p = 0; p < L::kPieces; ++p) {
      const int i = t + kStep * p;
      const int r = i / (BN / 8), col8 = i % (BN / 8);
      raw_off[p] = r * BN + col8 * 8;
      b_off[p] = (col8 / 8) * (kBK * 128) + swizzled(r, col8 % 8);
    }
    for (int kt = 0; kt < n_k; ++kt) {
      if (t == 0) {
        if (kt + kAhead < n_k) load_x(kt + kAhead);
        if (kt + kRaw - 1 < n_k) load_w(kt + kRaw - 1);
      }
      const int slot = kt % STAGES;
      if (kt >= STAGES)                     // B(kt)'s stage is released
        mbar_wait(empty + 8 * slot, (kt / STAGES - 1) & 1);
      mbar_wait(w_ready + 8 * (kt % kRaw), (kt / kRaw) & 1);
      const uint32_t w_tile = ws + (kt % kRaw) * L::kWBytes;
      const uint32_t b_tile = bs + slot * L::kBBytes;
      uint2 raw[L::kPieces];
#pragma unroll
      for (int p = 0; p < L::kPieces; ++p)
        asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                     : "=r"(raw[p].x), "=r"(raw[p].y)
                     : "r"(w_tile + raw_off[p]));
#pragma unroll
      for (int p = 0; p < L::kPieces; ++p) {
        const uint32_t lo = raw[p].x, hi = raw[p].y;
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(b_tile + b_off[p]),
                        "r"(widen_pair(__byte_perm(lo, 0, 0x4140))),
                        "r"(widen_pair(__byte_perm(lo, 0, 0x4342))),
                        "r"(widen_pair(__byte_perm(hi, 0, 0x4140))),
                        "r"(widen_pair(__byte_perm(hi, 0, 0x4342)))
                     : "memory");
      }
      fence_async_shared();                 // B(kt) -> the tensor cores
      mbar_arrive(full + 8 * slot);
      producer_sync<L::kProducerThreads>();  // raw stage kt read: refill
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  constexpr int kAcc = BN / 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int lane = tid % 32;
  for (int kt = 0; kt < n_k; ++kt) {
    const int slot = kt % STAGES;
    mbar_wait(x_ready + 8 * slot, (kt / STAGES) & 1);
    mbar_wait(full + 8 * slot, (kt / STAGES) & 1);
    const uint32_t a_tile = xs + slot * L::kXBytes + wg * 64 * 128;
    const uint32_t b_tile = bs + slot * L::kBBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc128(a_tile + kk * 32, 0, 1024);
      const uint64_t db = desc128(b_tile + kk * 2048, kBK * 128, 1024);
      wgmma_ss<1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                         // stage kt - 1 is read
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int warp = (tid % 128) / 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= f) continue;
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gm = row + 8 * r;
      if (gm < m)
        *reinterpret_cast<uint32_t*>(out + (long long)gm * f + col) =
            pack_bf16(acc[4 * j + 2 * r] * s0, acc[4 * j + 2 * r + 1] * s1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up once with cudaGetDriverEntryPoint
// (the library links no libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// A 2-D row-major tensor [rows][cols] of `type` and its [box_rows] x
// [box_cols] box; zeros outside the tensor.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* ptr, int rows, int cols, int box_rows,
                int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WGS, int BN, int STAGES, int PRODUCERS>
int launch(const void* x, const void* w, const void* scale, void* out,
           int m, int d, int f, void* stream) {
  using L = Layout<WGS, BN, STAGES, PRODUCERS>;
  CUtensorMap x_map, w_map;
  if (!tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, d,
                  L::kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B)
      || !tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, d, f, kBK,
                     BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_matmul_kernel<WGS, BN, STAGES, PRODUCERS>;
  static bool configured = false;      // before any graph capture
  if (!configured) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    configured = true;
  }
  const dim3 grid((m + L::kBM - 1) / L::kBM, (f + BN - 1) / BN);
  kernel<<<grid, L::kThreads, L::kBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), m, d, f);
  return static_cast<int>(cudaGetLastError());
}

// The tile of the M > 16 route for [m, f]: the widest of 128 x 256,
// 128 x 128, 64 x 128 that gives >= 120 blocks (of 132 SMs), else 64 x 64.
void pick_tile(int m, int f, int* bm, int* bn) {
  auto blocks = [&](int rows, int cols) {
    return ((m + rows - 1) / rows) * ((f + cols - 1) / cols);
  };
  *bm = 64;
  *bn = 64;
  if (m > 64 && blocks(128, 256) >= 120) {
    *bm = 128;
    *bn = 256;
  } else if (m > 64 && blocks(128, 128) >= 120) {
    *bm = 128;
    *bn = 128;
  } else if (blocks(64, 128) >= 120) {
    *bn = 128;
  }
}

}  // namespace tc

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
  int bm, bn;
  tc::pick_tile(m, f, &bm, &bn);
  // <consumer warpgroups, columns, operand stages, producer warpgroups>:
  // as many stages as 227 KB hold (two 64 x 64 blocks share an SM); the
  // 128 x 128 tile widens with two producers (its 2.1 MFLOP a stage leave
  // one producer behind the tensor cores).
  if (bn == 256)
    return tc::launch<2, 256, 3, 1>(x, w, scale, out, m, d, f, stream);
  if (bm == 128)
    return tc::launch<2, 128, 4, 2>(x, w, scale, out, m, d, f, stream);
  if (bn == 128)
    return tc::launch<1, 128, 6, 1>(x, w, scale, out, m, d, f, stream);
  return tc::launch<1, 64, 5, 1>(x, w, scale, out, m, d, f, stream);
}

// The tile (rows x columns of one block) and the number of blocks that
// aiko_int8_matmul launches for [m, f], for reports.
extern "C" void aiko_int8_matmul_tiles(int m, int f, int* tile_m,
                                       int* tile_n, int* n_blocks) {
  int bm = 16, bn = 64;
  if (m > 16) tc::pick_tile(m, f, &bm, &bn);
  *tile_m = bm;
  *tile_n = bn;
  *n_blocks = ((m + bm - 1) / bm) * ((f + bn - 1) / bn);
}
