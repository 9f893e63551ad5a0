// The Top-K fold and merge shared by the Top-K kernels (sim_topk.cu: fp32
// and int8 on __dp4a; sim_topk_q8.cu: int8 on wgmma): a warp folds one row
// of a parked score tile into that row's sorted K-list, and a second pass
// merges the per-split partial lists.  Internal linkage: each kernel file
// compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Fold one row of the score tile into that row's sorted list (one warp).
// lv/li: the list (shared or device memory), *cnt: its length.
__device__ void fold_row(const float* srow, int c0, int bc, int limit, int k,
                         float* lv, int* li, int* cnt, int lane) {
  int n = *cnt;
  float thr = n < k ? -CUDART_INF_F : lv[k - 1];
  for (int base = 0; base < bc; base += 32) {
    const int col = base + lane;
    const float v = (col < bc && c0 + col < limit) ? srow[col] : -CUDART_INF_F;
    unsigned m = __ballot_sync(kFull, v > thr);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __shfl_sync(kFull, v, src);
      if (!(cv > thr)) continue;  // the threshold rose since the ballot
      // entries scoring >= cv have lower indices: they stay ahead
      int p = 0;
      for (int j = lane; j < n; j += 32) p += lv[j] >= cv;
      p = warp_sum(p);
      const int n_new = min(n + 1, k);
      // shift [p, n_new - 1) one place back, 32 entries a step, from the end
      for (int end = n_new; end > p + 1; end -= 32) {
        const int j = end - 1 - lane;
        float tv = 0.f;
        int ti = 0;
        if (j > p) {
          tv = lv[j - 1];
          ti = li[j - 1];
        }
        __syncwarp();
        if (j > p) {
          lv[j] = tv;
          li[j] = ti;
        }
        __syncwarp();
      }
      if (lane == 0) {
        lv[p] = cv;
        li[p] = c0 + base + src;
      }
      __syncwarp();
      n = n_new;
      thr = n < k ? -CUDART_INF_F : lv[k - 1];
    }
  }
  __syncwarp();
  if (lane == 0) *cnt = n;
}

// One block per (policy, query) row of the (P, Q, K) output: K rounds,
// each taking the best head of the nsplit sorted partial lists, by (value
// descending, split ascending).
template <bool MULTI>
__global__ void sim_topk_merge(const float* __restrict__ part_val,
                               const int* __restrict__ part_idx, int nsplit,
                               int nq, int k, float* __restrict__ out_val,
                               int* __restrict__ out_idx) {
  extern __shared__ int head[];
  __shared__ float wv[32];
  __shared__ int ws[32];
  __shared__ float win_v;
  __shared__ int win_s;
  const int row = blockIdx.x;
  // partial list s of this row: part + (s * nq) * k
  const size_t prow =
      (MULTI ? (size_t)(row / nq) * nsplit * nq + row % nq : row) * (size_t)k;
  part_val += prow;
  part_idx += prow;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) / 32;
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x) head[s] = 0;
  __syncthreads();
  int j = 0;
  for (; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bs = INT_MAX;
    for (int s = threadIdx.x; s < nsplit; s += blockDim.x) {
      const int h = head[s];
      if (h < k) {
        const float v = part_val[(size_t)s * nq * k + h];
        if (v > bv) {  // s ascends within a thread: ties keep the lower
          bv = v;
          bs = s;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int os = __shfl_xor_sync(kFull, bs, off);
      if (ov > bv || (ov == bv && os < bs)) {
        bv = ov;
        bs = os;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      ws[warp] = bs;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? wv[lane] : -CUDART_INF_F;
      bs = lane < nwarps ? ws[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int os = __shfl_xor_sync(kFull, bs, off);
        if (ov > bv || (ov == bv && os < bs)) {
          bv = ov;
          bs = os;
        }
      }
      if (lane == 0) {
        win_v = bv;
        win_s = bs;
      }
    }
    __syncthreads();
    if (win_s == INT_MAX) break;  // every list is exhausted
    if (threadIdx.x == 0) {
      const int s = win_s;
      out_val[(size_t)row * k + j] = win_v;
      out_idx[(size_t)row * k + j] = part_idx[(size_t)s * nq * k + head[s]];
      head[s] += 1;
    }
    __syncthreads();
  }
  for (int t = j + threadIdx.x; t < k; t += blockDim.x) {
    out_val[(size_t)row * k + t] = -CUDART_INF_F;
    out_idx[(size_t)row * k + t] = 0;
  }
}

}  // namespace
