// Exact top-k over the last axis of a [B, V] float32 array.
//
// Replaces the TPU kernel topk (aiko_services_tpu/ops/pallas_topk.py):
// values descending, ties to the lowest index (lax.top_k's contract), and
// no duplicate index on a row that is mostly -inf.  k <= 128.
//
// What bounds it on an H100: bytes.  [8, 128256] f32 is 4.1 MB read once
// for a [8, k] result.
//
// Design:
//  - The TPU kernel streams one row group through a sequential grid axis,
//    carrying a running top-k in VMEM.  Here the vocabulary is cut into
//    chunks, one block each (63 chunks x 8 rows = 504 blocks at llama3
//    width), and each block writes its chunk's own top-k as candidates;
//    a second pass, one block per row, selects the row's top-k from the
//    candidates.  Both passes run the same block routine.
//  - The block routine holds its elements in registers and extracts k
//    winners one at a time: each thread keeps its best live element, a
//    warp shuffle tree and one shared-memory step find the block's best,
//    and only the winning thread re-scans its own elements.
//  - Order is (value desc, index asc, position asc).  An element is
//    consumed by its position, never by overwriting its value, so an
//    already -inf element cannot be picked twice (the TPU kernel's
//    duplicate-index fault).  A chunk shorter than k pads its candidates
//    with (-inf, INT_MAX), which every real element outranks.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Entry {
  float v;
  int i;
  int pos;
};

__device__ __forceinline__ bool better(const Entry& a, const Entry& b) {
  if (a.v != b.v) return a.v > b.v;
  if (a.i != b.i) return a.i < b.i;
  return a.pos < b.pos;
}

__device__ __forceinline__ Entry shfl(const Entry& e, int off) {
  Entry o;
  o.v = __shfl_xor_sync(0xffffffffu, e.v, off);
  o.i = __shfl_xor_sync(0xffffffffu, e.i, off);
  o.pos = __shfl_xor_sync(0xffffffffu, e.pos, off);
  return o;
}

// Top-k of n elements: element p has value vals[p] and index
// idxs ? idxs[p] : index_base + p.  Writes k entries to out_v / out_i.
template <int EPT>
__device__ void block_topk(const float* __restrict__ vals,
                           const int* __restrict__ idxs, int n,
                           int index_base, int k, float* __restrict__ out_v,
                           int* __restrict__ out_i) {
  __shared__ Entry warp_best[kWarps];
  __shared__ Entry winner;
  const Entry none = {-INFINITY, INT_MAX, INT_MAX};
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  float v[EPT];
  int ix[EPT];
  unsigned live = 0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = e * kThreads + tid;
    if (p < n) {
      v[e] = vals[p];
      ix[e] = idxs ? idxs[p] : index_base + p;
      live |= 1u << e;
    } else {
      v[e] = -INFINITY;
      ix[e] = INT_MAX;
    }
  }
  auto local_best = [&]() {
    Entry best = none;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const Entry cand = {v[e], ix[e], e * kThreads + tid};
      if ((live >> e) & 1u && better(cand, best)) best = cand;
    }
    return best;
  };
  Entry mine = local_best();

  for (int round = 0; round < k; ++round) {
    Entry best = mine;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const Entry other = shfl(best, off);
      if (better(other, best)) best = other;
    }
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? warp_best[lane] : none;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off /= 2) {
        const Entry other = shfl(best, off);
        if (better(other, best)) best = other;
      }
      if (lane == 0) {
        winner = best;
        out_v[round] = best.v;
        out_i[round] = best.i;
      }
    }
    __syncthreads();
    const int pos = winner.pos;
    if (pos != INT_MAX && pos % kThreads == tid) {
      live &= ~(1u << (pos / kThreads));
      mine = local_best();
    }
  }
}

template <int EPT>
__global__ void __launch_bounds__(kThreads)
topk_chunks_kernel(const float* __restrict__ x, long long row_stride, int vocab,
                   int k, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  const int chunk = blockIdx.x;
  const int row = blockIdx.y;
  const int chunk_len = EPT * kThreads;
  const int start = chunk * chunk_len;
  const int n = min(chunk_len, vocab - start);
  const long long out = ((long long)row * gridDim.x + chunk) * k;
  block_topk<EPT>(x + row * row_stride + start, nullptr, n, start, k,
                  cand_v + out, cand_i + out);
}

template <int EPT>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ cand_v,
                  const int* __restrict__ cand_i, int n_cand, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  const int row = blockIdx.x;
  const long long in = (long long)row * n_cand;
  block_topk<EPT>(cand_v + in, cand_i + in, n_cand, 0, k,
                  out_v + (long long)row * k, out_i + (long long)row * k);
}

constexpr int kMergeEpt = 32;

}  // namespace

// Largest k * n_chunks the merge pass holds (one element per thread per
// register slot).
extern "C" int aiko_topk_merge_capacity() { return kMergeEpt * kThreads; }

extern "C" int aiko_topk(const void* x, long long row_stride, int batch,
                         int vocab, int k, int chunk_ept, int n_chunks,
                         void* cand_v, void* cand_i, void* out_v, void* out_i,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_chunks * k > kMergeEpt * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_chunks, batch);
  const auto* xp = static_cast<const float*>(x);
  auto* cv = static_cast<float*>(cand_v);
  auto* ci = static_cast<int*>(cand_i);
  switch (chunk_ept) {
    case 8:
      topk_chunks_kernel<8><<<grid, kThreads, 0, s>>>(xp, row_stride, vocab,
                                                      k, cv, ci);
      break;
    case 32:
      topk_chunks_kernel<32><<<grid, kThreads, 0, s>>>(xp, row_stride, vocab,
                                                       k, cv, ci);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  topk_merge_kernel<kMergeEpt><<<batch, kThreads, 0, s>>>(
      cv, ci, n_chunks * k, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
