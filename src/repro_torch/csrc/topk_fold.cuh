// The Top-K folds and merges shared by the Top-K kernels (sim_topk.cu: int8
// on __dp4a; sim_topk_q8.cu: int8 on wgmma; sim_topk_f32.cu: fp32):
//  - fold_row: a warp folds one row of a parked score tile into that row's
//    sorted K-list, one insertion at a time (sim_topk.cu, sim_topk_q8.cu);
//  - insert/pop: a thread's own sorted list of N entries in registers, a
//    fixed compare-and-select ladder;
//  - warp_sort/merge_path: a warp sorts a batch of candidates and merges it
//    into a sorted list in one pass (sim_topk_f32.cu's K > 32 fold);
//  - the merges of the per-split partial lists: merge_rows (a warp per row,
//    lane lists of N <= 8 entries), merge_lists (a block per row, a warp a
//    share of the splits, merge_path throughout) and sim_topk_merge (any K,
//    one head a round).
// Every order is (value descending, index ascending).  Internal linkage:
// each kernel file compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

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


// (s, c) into the descending list (v, ix) of N entries, behind every
// entry >= s (those have lower indices); the caller checked s > v[N - 1]
template <int N>
__device__ __forceinline__ void insert(float (&v)[N], int (&ix)[N], float s,
                                       int c) {
#pragma unroll
  for (int j = N - 1; j > 0; --j) {
    const bool up = s > v[j - 1];  // entry j - 1 moves down to j
    const bool at = s > v[j];      // s lands at j when entry j - 1 stays
    ix[j] = up ? ix[j - 1] : at ? c : ix[j];
    v[j] = up ? v[j - 1] : at ? s : v[j];
  }
  if (s > v[0]) {
    v[0] = s;
    ix[0] = c;
  }
}

// drop the head of the list when take
template <int N>
__device__ __forceinline__ void pop(float (&v)[N], int (&ix)[N], bool take) {
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {
    v[j] = take ? v[j + 1] : v[j];
    ix[j] = take ? ix[j + 1] : ix[j];
  }
  v[N - 1] = take ? -CUDART_INF_F : v[N - 1];
  ix[N - 1] = take ? INT_MAX : ix[N - 1];
}

// partial list s of a row (its first k entries; the rest and a split past
// nsplit read as -inf)
template <int N>
__device__ __forceinline__ void load_list(const float* __restrict__ part_val,
                                          const int* __restrict__ part_idx,
                                          size_t prow, int s, int nsplit,
                                          int nq, int k, float (&x)[N],
                                          int (&xi)[N]) {
  const size_t at = prow + (size_t)s * nq * k;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool in = s < nsplit && j < k;
    x[j] = in ? part_val[at + j] : -CUDART_INF_F;
    xi[j] = in ? part_idx[at + j] : 0;
  }
}

// The merge for K <= N: one warp per (policy, query) row of the (P, Q, K)
// output.  Lane l folds the partial lists of splits l, l + 32, ... into its
// own sorted list with the insert ladder (its splits ascend, so equal
// scores keep the lower index ahead; a split's list descends, so its first
// entry that cannot enter ends it), each list read whole and the next
// one's loads in flight while this one folds.  Then K rounds take the best
// head among the lanes by (value descending, index ascending), which is
// the order of the union: the indices are distinct.  No barrier between
// rounds (sim_topk_merge re-reads the heads and takes two barriers a
// round: about 9 us for one row of 257 splits on an H100,
// chip_ab_flash.py --q8).
template <bool MULTI, int N>
__global__ void __launch_bounds__(128)
    merge_rows(const float* __restrict__ part_val,
               const int* __restrict__ part_idx, int nsplit, int nq,
               int nrows, int k, float* __restrict__ out_val,
               int* __restrict__ out_idx) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= nrows) return;
  // partial list s of this row: part + (s * nq) * k
  const size_t prow =
      (MULTI ? (size_t)(row / nq) * nsplit * nq + row % nq : row) * (size_t)k;
  float v[N];
  int ix[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] = -CUDART_INF_F;
    ix[j] = INT_MAX;
  }
  // a split's whole list is read at once, the next one's before this one
  // is folded: one load latency per lane, not one per entry
  float x[N], y[N];
  int xi[N], yi[N];
  load_list(part_val, part_idx, prow, lane, nsplit, nq, k, x, xi);
  for (int s = lane; s < nsplit; s += 32) {
    load_list(part_val, part_idx, prow, s + 32, nsplit, nq, k, y, yi);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!(x[j] > v[N - 1])) break;  // the list descends
      insert(v, ix, x[j], xi[j]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      x[j] = y[j];
      xi[j] = yi[j];
    }
  }
  for (int j = 0; j < k; ++j) {
    float hv = v[0];
    int hi = ix[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, hv, off);
      const int oi = __shfl_xor_sync(kFull, hi, off);
      if (ov > hv || (ov == hv && oi < hi)) {
        hv = ov;
        hi = oi;
      }
    }
    pop(v, ix, v[0] == hv && ix[0] == hi);
    if (lane == 0) {
      out_val[(size_t)row * k + j] = hv;
      out_idx[(size_t)row * k + j] = hv > -CUDART_INF_F ? hi : 0;
    }
  }
}

// (a, ai) comes before (b, bi): value descending, index ascending.  The
// indices of one list are distinct, so this is a strict order; a NaN
// comes before nothing and never enters a list.
__device__ __forceinline__ bool ahead(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// Sort n2 (a power of two) entries (v, ix) best first; one warp, a bitonic
// network.  Padding entries (-inf, INT_MAX) sort last.
__device__ inline void warp_sort(float* v, int* ix, int n2, int lane) {
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const bool best_first = (lo & size) == 0;
        const float a = v[lo], b = v[hi];
        const int ai = ix[lo], bi = ix[hi];
        if (ahead(b, bi, a, ai) == best_first) {
          v[lo] = b;
          v[hi] = a;
          ix[lo] = bi;
          ix[hi] = ai;
        }
      }
      __syncwarp();
    }
}

// (cv, ci)[0, min(na + nb, k)): the head of the merge of the sorted lists
// (av, ai)[0, na) and (bv, bi)[0, nb); one warp.  Lane l writes outputs
// [l c, l c + c), c = ceil(n / 32): one binary search along the merge path
// finds where its run starts, then it walks the run.  C must not overlap
// A or B.
__device__ inline void merge_path(const float* av, const int* ai, int na,
                                  const float* bv, const int* bi, int nb,
                                  int k, float* cv, int* ci, int lane) {
  const int nc = min(na + nb, k), run = (nc + 31) / 32;
  const int s0 = min(nc, lane * run), s1 = min(nc, s0 + run);
  int lo = max(0, s0 - nb), hi = min(s0, na);
  while (lo < hi) {  // the entries of A among the first s0 outputs
    const int mid = (lo + hi) >> 1;
    if (ahead(av[mid], ai[mid], bv[s0 - mid - 1], bi[s0 - mid - 1]))
      lo = mid + 1;
    else
      hi = mid;
  }
  for (int s = s0, a = lo, b = s0 - lo; s < s1; ++s) {
    const bool take_a = a < na && (b >= nb || ahead(av[a], ai[a], bv[b], bi[b]));
    cv[s] = take_a ? av[a] : bv[b];
    ci[s] = take_a ? ai[a] : bi[b];
    a += take_a;
    b += !take_a;
  }
  __syncwarp();
}

// `bytes` (0 to SIZE) of src into shared dst by cp.async, the rest of
// SIZE zero-filled; a thread's copies do not wait on each other
template <int SIZE>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The merge for K > 8 (fp32): one block per (policy, query) row, W warps.
// Warp w takes the partial lists of splits w, w + W, ... in batches of nb:
// a batch's lists are copied to shared memory at once (cp.async, every
// load in flight together, the next batch's while this one merges), then
// merged into the warp's list one by one (merge_path, into the other of
// two buffers); then the warps' lists are merged pairwise in log2(W)
// rounds.  Shared memory: 2 + 2 nb lists of k (value, index) entries a
// warp.
template <bool MULTI>
__global__ void __launch_bounds__(512)
    merge_lists(const float* __restrict__ part_val,
                const int* __restrict__ part_idx, int nsplit, int nq, int k,
                int nb, float* __restrict__ out_val,
                int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const int row = blockIdx.x, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  const size_t prow =
      (MULTI ? (size_t)(row / nq) * nsplit * nq + row % nq : row) * (size_t)k;
  const size_t lists = (size_t)(2 + 2 * nb) * k;  // entries of a warp
  // warp w's buffers: [0, 1] its list, then two batches of nb
  float* buf_v = reinterpret_cast<float*>(merge_smem) + (size_t)w * 2 * lists;
  int* buf_i = reinterpret_cast<int*>(buf_v + lists);
  const int mine = (nsplit - w + nw - 1) / nw;  // splits of this warp
  const int batches = (mine + nb - 1) / nb;
  auto fetch = [&](int bt) {  // batch bt into batch buffer bt % 2
    const int first = bt * nb, cnt = min(nb, mine - first);
    const int at0 = 2 + (bt % 2) * nb;
    for (int e = lane; e < cnt * k; e += 32) {
      const int b = e / k, j = e % k;
      const size_t at = prow + (size_t)(w + (first + b) * nw) * nq * k + j;
      cp_async<4>(buf_v + (at0 + b) * k + j, part_val + at, 4);
      cp_async<4>(buf_i + (at0 + b) * k + j, part_idx + at, 4);
    }
    cp_commit();
  };
  int cur = 0, n = 0;  // the warp's list is buffer cur, n entries
  if (batches > 0) fetch(0);
  for (int bt = 0; bt < batches; ++bt) {
    if (bt + 1 < batches) {
      fetch(bt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const int cnt = min(nb, mine - bt * nb), at0 = 2 + (bt % 2) * nb;
    for (int b = 0; b < cnt; ++b) {
      merge_path(buf_v + cur * k, buf_i + cur * k, n, buf_v + (at0 + b) * k,
                 buf_i + (at0 + b) * k, k, k, buf_v + (1 - cur) * k,
                 buf_i + (1 - cur) * k, lane);
      cur = 1 - cur;
      n = k;
    }
    __syncwarp();  // the batch buffer is free for batch bt + 2
  }
  for (int step = 1; step < nw; step <<= 1) {
    __syncthreads();
    // every live list says where it is, in its batch area's head
    const bool take = w % (2 * step) == 0 && w + step < nw;
    if (w % step == 0 && lane == 0) {
      buf_i[2 * k] = cur;
      buf_i[2 * k + 1] = n;
    }
    __syncthreads();
    int o_n = 0;
    const float* o_v = nullptr;
    const int* o_i = nullptr;
    if (take) {
      const float* ov = reinterpret_cast<const float*>(merge_smem) +
                        (size_t)(w + step) * 2 * lists;
      const int* oi = reinterpret_cast<const int*>(ov + lists);
      const int o_cur = oi[2 * k];
      o_n = oi[2 * k + 1];
      o_v = ov + o_cur * k;
      o_i = oi + o_cur * k;
    }
    __syncthreads();  // every reader has the heads before the next write
    if (take) {
      merge_path(buf_v + cur * k, buf_i + cur * k, n, o_v, o_i, o_n, k,
                 buf_v + (1 - cur) * k, buf_i + (1 - cur) * k, lane);
      cur = 1 - cur;
      n = min(n + o_n, k);
    }
  }
  if (w == 0) {
    const float* lv = buf_v + cur * k;
    const int* li = buf_i + cur * k;
    for (int j = lane; j < k; j += 32) {
      const bool in = j < n && lv[j] > -CUDART_INF_F;
      out_val[(size_t)row * k + j] = in ? lv[j] : -CUDART_INF_F;
      out_idx[(size_t)row * k + j] = in ? li[j] : 0;
    }
  }
}

}  // namespace
