// Exact top-k over the last axis of a [B, V] float32 array, by threshold
// select.
//
// Replaces the TPU kernel topk (aiko_services_tpu/ops/pallas_topk.py:146):
// values descending, ties to the lowest index (lax.top_k's contract, and
// a stable descending sort's), and no duplicate index on a row that is
// mostly -inf.  k <= 128.
//
// What bounds it on an H100: bytes.  [8, 128256] f32 is 4.1 MB read once
// for a [8, k] result (~1.2 us at 3.35 TB/s); everything else is latency
// inside the blocks.
//
// Design:
//  - Key.  Each f32 maps to an order-preserving 32-bit key: every bit of
//    a negative value flipped, the sign bit of any other set (-0 counts
//    as +0, a NaN above +inf, as the stable sort orders them).  An absent
//    slot (past the row's end) has key 0, below every value's key.
//  - Threshold.  A block finds the k-th largest key of its elements by
//    radix select in shared memory: a histogram of the top 12 key bits,
//    the bin holding the k-th element, then histograms of the next 10
//    and the last 10 bits counted only inside the chosen bin (shared-
//    memory atomics; folding a warp's equal bins first with
//    __match_any_sync measured slower).  At most three rounds of a few
//    block barriers each, in place of k serial extraction rounds.
//  - Select.  Every element whose key is above the threshold, then the
//    lowest-indexed elements equal to it, up to k: one block scan of the
//    (above, equal) counts in index order (elements are blocked, E
//    consecutive ones a thread) gives each taken element its slot, so
//    the result does not depend on the order blocks run in.
//  - Two passes.  The chunk pass cuts each row into chunks (the split
//    from ops/topk.py's plan: shapes only, about 2 x 132 blocks or more
//    where the merge can hold the candidates) and writes each chunk's own
//    top-k keys and indices, in index order; the merge pass (one block a
//    row) selects the row's top-k from its chunks' candidates, whose
//    order is again index order among equal keys, so the tie rule
//    carries over exactly.  It sorts the k winners by (key desc, index
//    asc) by rank (8 lanes count the winners ahead of each) and reads
//    their values back from x.
//  - Capture-safe: no host synchronisation, scratch from torch.empty,
//    two launches of static shapes.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kChunkThreads = 256;
constexpr int kMergeThreads = 1024;
constexpr int kMergeEpt = 8;        // candidates a merge thread holds
constexpr int kMaxK = 128;
constexpr int kRankLanes = kMergeThreads / kMaxK;   // lanes ranking a winner
constexpr int kBins = 4096;         // the first round's 12-bit digits
// Bin b sits at b + b / 32: the 32 lanes of a warp summing 4 or 16
// consecutive bins each then hit 32 different banks.
constexpr int kHistWords = kBins + kBins / 32;

__device__ __forceinline__ int padded(int bin) { return bin + (bin >> 5); }

__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) return 0xffffffffu;
  const uint32_t u = x == 0.f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Exclusive prefix sum of one int a thread over the block, in thread
// order.  sums: T / 32 ints of shared memory.
template <int T>
__device__ int block_exclusive_scan(int value, int* sums) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int x = value;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < T / 32 ? sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < T / 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < T / 32) sums[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? sums[warp - 1] : 0) + x - value;
  __syncthreads();
  return before;
}

// The threshold of the block's keys (E a thread) by up to three radix
// rounds: the top k are the keys whose masked value (key & mask) is
// above tau, then the first `need` whose masked value equals it.  The
// rounds stop early once every key of the chosen bin is needed (tau is
// then a prefix and mask covers its bits); after all three, tau is the
// k-th largest key.  hist: kHistWords ints; scratch: T / 32 + 3 ints.
template <int T, int E>
__device__ void block_threshold(const uint32_t (&key)[E], int k, int* hist,
                                int* scratch, uint32_t& tau, uint32_t& mask,
                                int& need) {
  uint32_t prefix = 0;
  int remaining = k;
  mask = 0;
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    const int shift = round == 0 ? 20 : round == 1 ? 10 : 0;
    const int bins = round == 0 ? kBins : 1024;
    for (int i = threadIdx.x; i < padded(bins); i += T) hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((key[e] & mask) == prefix)
        atomicAdd(&hist[padded(static_cast<int>(key[e] >> shift)
                                & (bins - 1))], 1);
    }
    __syncthreads();
    // Thread i sums bins [top - per, top), the highest bins first.
    const int per = bins / T;
    const int top = bins - static_cast<int>(threadIdx.x) * per;
    int sum = 0;
    for (int j = 1; j <= per; ++j) sum += hist[padded(top - j)];
    int above = block_exclusive_scan<T>(sum, scratch);
    if (above < remaining && remaining <= above + sum) {
      for (int j = 1; j <= per; ++j) {
        const int count = hist[padded(top - j)];
        if (above + count >= remaining) {
          scratch[T / 32] = top - j;
          scratch[T / 32 + 1] = above;
          scratch[T / 32 + 2] = above + count == remaining;
          break;
        }
        above += count;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(scratch[T / 32]) << shift;
    mask |= static_cast<uint32_t>(bins - 1) << shift;
    remaining -= scratch[T / 32 + 1];
    if (scratch[T / 32 + 2]) break;    // the whole bin is taken
  }
  tau = prefix;
  need = remaining;
}

// Slot in [0, k) of each key the top k take (every key whose masked
// value is above tau, then the first `need` equal to it in index order),
// or -1.
template <int T, int E>
__device__ void block_take(const uint32_t (&key)[E], uint32_t tau,
                           uint32_t mask, int need, int* scratch,
                           int (&slot)[E]) {
  uint32_t masked[E];
  int above = 0, equal = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    masked[e] = key[e] & mask;
    above += masked[e] > tau;
    equal += masked[e] == tau;
  }
  // Both counts are <= T * E <= 8192: one packed scan.
  const int before = block_exclusive_scan<T>((above << 16) | equal, scratch);
  int g = before >> 16, q = before & 0xffff;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (masked[e] > tau) {
      slot[e] = g + min(q, need);
      ++g;
    } else if (masked[e] == tau) {
      slot[e] = q < need ? g + q : -1;
      ++q;
    } else {
      slot[e] = -1;
    }
  }
}

// Chunk pass: block (chunk, row) writes its chunk's top-k keys and
// indices, in index order, to cand_*[row][chunk][0, k).  A chunk of
// fewer than k elements fills its last slots with key 0, index INT_MAX.
template <int E>
__global__ void __launch_bounds__(kChunkThreads)
topk_chunk_kernel(const float* __restrict__ x, long long row_stride,
                  int vocab, int k, int aligned,
                  uint32_t* __restrict__ cand_key,
                  int* __restrict__ cand_idx) {
  __shared__ int hist[kHistWords];
  __shared__ int scratch[kChunkThreads / 32 + 3];
  const int chunk = blockIdx.x;
  const int row = blockIdx.y;
  const int start = chunk * kChunkThreads * E;
  const int n = min(kChunkThreads * E, vocab - start);
  const float* src = x + row * row_stride + start;
  const int p0 = static_cast<int>(threadIdx.x) * E;
  uint32_t key[E];
  if (E % 4 == 0 && aligned && p0 + E <= n) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(src + p0)[i];
      key[4 * i] = order_key(f.x);
      key[4 * i + 1] = order_key(f.y);
      key[4 * i + 2] = order_key(f.z);
      key[4 * i + 3] = order_key(f.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      key[e] = p0 + e < n ? order_key(src[p0 + e]) : 0u;
  }
  uint32_t tau, mask;
  int need;
  block_threshold<kChunkThreads, E>(key, k, hist, scratch, tau, mask, need);
  int slot[E];
  block_take<kChunkThreads, E>(key, tau, mask, need, scratch, slot);
  const long long out = ((long long)row * gridDim.x + chunk) * k;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (slot[e] >= 0) {
      cand_key[out + slot[e]] = key[e];
      cand_idx[out + slot[e]] = p0 + e < n ? start + p0 + e : INT_MAX;
    }
  }
}

// Merge pass: block `row` selects the row's top k from its n_cand
// candidates and writes them sorted by (value desc, index asc).
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ x, long long row_stride,
                  const uint32_t* __restrict__ cand_key,
                  const int* __restrict__ cand_idx, int n_cand, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ int hist[kHistWords];
  __shared__ int scratch[kMergeThreads / 32 + 3];
  __shared__ uint32_t win_key[kMaxK];
  __shared__ int win_idx[kMaxK];
  const int row = blockIdx.x;
  const long long in = (long long)row * n_cand;
  const int p0 = static_cast<int>(threadIdx.x) * kMergeEpt;
  uint32_t key[kMergeEpt];
#pragma unroll
  for (int e = 0; e < kMergeEpt; ++e)
    key[e] = p0 + e < n_cand ? cand_key[in + p0 + e] : 0u;
  uint32_t tau, mask;
  int need;
  block_threshold<kMergeThreads, kMergeEpt>(key, k, hist, scratch, tau,
                                            mask, need);
  int slot[kMergeEpt];
  block_take<kMergeThreads, kMergeEpt>(key, tau, mask, need, scratch, slot);
#pragma unroll
  for (int e = 0; e < kMergeEpt; ++e) {
    if (slot[e] >= 0) {
      win_key[slot[e]] = key[e];
      win_idx[slot[e]] = p0 + e < n_cand ? cand_idx[in + p0 + e] : INT_MAX;
    }
  }
  __syncthreads();
  // Rank of winner w: the winners ahead of it in (key desc, index asc),
  // counted by kRankLanes lanes over kMaxK / kRankLanes winners each.
  const int w = threadIdx.x / kRankLanes;
  const int part = threadIdx.x % kRankLanes;
  const uint32_t mine = w < k ? win_key[w] : 0u;
  const int idx = w < k ? win_idx[w] : INT_MAX;
  int rank = 0;
  for (int j = part * (kMaxK / kRankLanes);
       j < min(k, (part + 1) * (kMaxK / kRankLanes)); ++j)
    rank += win_key[j] > mine || (win_key[j] == mine && win_idx[j] < idx);
#pragma unroll
  for (int off = 1; off < kRankLanes; off *= 2)
    rank += __shfl_xor_sync(0xffffffffu, rank, off);
  if (w < k && part == 0) {
    out_i[(long long)row * k + rank] = idx;
    out_v[(long long)row * k + rank] =
        idx == INT_MAX ? -INFINITY : x[row * row_stride + idx];
  }
}

}  // namespace

// x: [batch, vocab] f32 rows row_stride elements apart (unit stride along
// the row; aligned = 1 when rows start on 16-byte boundaries); n_chunks
// chunks of kChunkThreads * chunk_ept elements, n_chunks * k at most
// kMergeThreads * kMergeEpt (ops/topk.py's _MERGE_CAPACITY);
// cand_key / cand_idx: [batch, n_chunks, k] scratch; out_v / out_i:
// [batch, k].
extern "C" int aiko_topk(const void* x, long long row_stride, int batch,
                         int vocab, int k, int chunk_ept, int n_chunks,
                         int aligned, void* cand_key, void* cand_idx,
                         void* out_v, void* out_i, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || k > vocab || n_chunks < 1
      || (long long)n_chunks * chunk_ept * kChunkThreads < vocab
      || n_chunks * k > kMergeThreads * kMergeEpt)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_chunks, batch);
  const auto* xp = static_cast<const float*>(x);
  auto* ck = static_cast<uint32_t*>(cand_key);
  auto* ci = static_cast<int*>(cand_idx);
  switch (chunk_ept) {
#define AIKO_CHUNK(E)                                                       \
  case E:                                                                   \
    topk_chunk_kernel<E><<<grid, kChunkThreads, 0, s>>>(                    \
        xp, row_stride, vocab, k, aligned, ck, ci);                         \
    break;
    AIKO_CHUNK(1)
    AIKO_CHUNK(2)
    AIKO_CHUNK(4)
    AIKO_CHUNK(8)
#undef AIKO_CHUNK
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  topk_merge_kernel<<<batch, kMergeThreads, 0, s>>>(
      xp, row_stride, ck, ci, n_chunks * k, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
