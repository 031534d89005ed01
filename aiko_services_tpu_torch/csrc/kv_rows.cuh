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

// log2(n) when n is a power of two, else -1 (PagedRows::page_shift).
inline int power_of_two_shift(int n) {
  return n > 0 && (n & (n - 1)) == 0 ? __builtin_ctz(n) : -1;
}

// Row addressing of a paged pool [P, pt, C]: row t of batch row b at
// base + table[b, t / pt] * page_stride + (t % pt) * stride_t, its scales
// (a [P, pt, K] pool) at the same page and row of the scale pool.  A
// power-of-two pt divides by a shift and a mask.
struct PagedRows {
  long long page_stride, stride_t;
  long long spage_stride, sstride_t;
  const int32_t* table;           // [B, pps]
  int pps, page_tokens, n_pages;
  int page_shift;                 // power_of_two_shift(page_tokens)

  __device__ __forceinline__ int page(int t) const {
    return page_shift >= 0 ? t >> page_shift : t / page_tokens;
  }
  __device__ __forceinline__ int within(int t) const {
    return page_shift >= 0 ? t & (page_tokens - 1) : t % page_tokens;
  }

  __device__ __forceinline__ void load(int b, int length, int* tbl) const {
    const int live = (length + page_tokens - 1) / page_tokens;
    for (int i = threadIdx.x; i < live; i += blockDim.x) {
      const int page = table[(long long)b * pps + i];
      tbl[i] = min(max(page, 0), n_pages - 1);
    }
  }
  __device__ __forceinline__ long long row(int, int t, const int* tbl) const {
    return tbl[page(t)] * page_stride + (long long)within(t) * stride_t;
  }
  __device__ __forceinline__ long long srow(int, int t,
                                            const int* tbl) const {
    return tbl[page(t)] * spage_stride + (long long)within(t) * sstride_t;
  }
};

}  // namespace aiko
