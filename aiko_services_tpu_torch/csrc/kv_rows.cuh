// Where cache row t of batch row b lives, for the decode and verify
// kernels: a flat [B, T, C] view, or a page pool [P, pt, C] walked
// through a [B, pps] page table.  A kernel body takes one of these as a
// template parameter, so its flat and paged forms run the same
// instructions in the same order and differ only in addresses (the
// paged form is bitwise equal to the flat one on the gathered view).
#pragma once

#include "common.cuh"

namespace aiko {

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
    for (int i = threadIdx.x; i < live; i += blockDim.x) {
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

}  // namespace aiko
