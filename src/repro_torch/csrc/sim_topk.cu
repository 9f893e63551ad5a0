// Int8 Top-K on __dp4a: (Q, D) int8 queries with per-row fp32 scales x
// (N, D) int8 candidates with per-row fp32 scales -> per query the K best
// scores sorted descending, ties toward the lower candidate index: exact
// int8 x int8 -> int32 dots (__dp4a), then the score
// (float(acc) * qscale[row]) * cscale[col] in that order.
//
// Replaces: repro/kernels/similarity_topk.py::sim_topk_q8_pallas
// (_make_sim_topk_q8_kernel), the int8 candidate scan of the quantized
// lookup, for the calls TMA cannot read.  The int8 calls
// whose rows TMA can read (D a multiple of 16 up to 1,024, 16-byte-aligned
// bases: every embedder width the repo runs) go to the tensor-core kernel
// of sim_topk_q8.cu instead; this file serves the rest (D = 130, offset
// rows: similarity_topk.q8_route).  The fp32 Top-K is sim_topk_f32.cu.
//
// What bounds it on an H100: the int8 scan reads a quarter of the fp32
// bytes (50 MB for the 65,537 x 768 slab: 0.015 ms) and, at 512 queries,
// does 51.5 G int8 operations: 0.026 ms at the tensor cores' 1,979 TOPS.
// This kernel uses __dp4a on the CUDA cores, not the tensor cores, so it
// stays well above that bound.
//
// Design:
//  - The TPU kernel folds candidate tiles in order through a revisited
//    output block.  Hopper blocks run in no order, so, as in B1, the
//    candidate axis is split across blocks (grid.y).  Each block keeps a
//    running sorted K-list per query over the tiles of its split and
//    writes it as a partial list; a second pass merges the per-split
//    lists by (value descending, split ascending), which is (value
//    descending, index ascending) globally because splits cover ascending
//    candidate ranges.
//  - Per tile the block computes the (BQ x BC) score tile with a register
//    micro-tile (B1's two tile shapes), parks it in shared memory, and
//    then each warp folds whole rows into their lists: a ballot against
//    the row's current K-th score finds the few columns that can enter,
//    and each is inserted behind every entry with a score >= its own (the
//    list holds only lower indices of this split, so equal scores stay
//    ahead).  Columns are visited in ascending order, so the tie rule
//    holds inside the block.  The fold and the merge pass live in
//    topk_fold.cuh, shared with sim_topk_q8.cu.
//  - Any K up to N is served: the lists live in shared memory when
//    BQ * K * 8 bytes fit in 16 KB, else in the partial output buffer in
//    device memory (same code through a generic pointer).  The wrapper
//    caps the split count so that each split has at least 2K candidates.
//  - Rows are read 16 bytes per load when D is a multiple of 16 and
//    the rows are 16-byte aligned; otherwise byte by byte.  Either way the
//    ragged depth and row edges are masked with zeros, so no padding is
//    needed.  int32 accumulation is exact for D * 127^2 < 2^31.
//  - Columns at or past n_valid score -inf and never enter a list; a row
//    with fewer than K live columns comes back with (-inf, 0) in its tail.
//    No --use_fast_math: the two scale products are __fmul_rn, so the
//    scores are bit-equal to the plain version's and the host gemm's.
//
// The policy-stacked entry (sim_topk_multi_launch, int8) replaces
// repro/kernels/ops.py::sim_topk_q8_multi_raw, which walks P int8 policy
// slabs with lax.map over the TPU kernel inside one dispatch: the
// quantized arena's snapshot scan.  The policy is a grid axis (grid.z):
// block (x, y, p) reads slab p at offset p*S*D, its scales at p*S, and
// policy p's count from n_valid_dev[p] on the card; the merge runs over
// P*Q rows.  A policy's slice equals a single-slab launch on that slab
// (exact int32 sums, the same score products, the same fold and merge).
// At the arena's shape (Q = 512, P = 15, S = 6,852, D = 768, k = 8):
// 80.8 G int8 operations, 0.041 ms on the tensor cores, against 79 MB of
// int8 slab (0.024 ms); on __dp4a it stays far above that bound.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "topk_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 16;  // 32-bit words of depth per shared-memory slice

// One depth slice (kSlice words = 64 int8 values) of rows [r0, r0 + ROWS),
// four values per word, lowest address in the low byte (what __dp4a and a
// little-endian vector load both expect).
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_i8(const signed char* __restrict__ src,
                                        int r0, int n, int d, int k0,
                                        int (*dst)[ROWS + 4]) {
  if (VEC) {
    for (int e = threadIdx.x; e < ROWS * (kSlice / 4); e += kThreads) {
      const int r = e / (kSlice / 4), part = e % (kSlice / 4);
      const int gr = r0 + r, gk = k0 + part * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < n && gk < d)
        v = __ldg(reinterpret_cast<const int4*>(src + (size_t)gr * d + gk));
      dst[part * 4 + 0][r] = v.x;
      dst[part * 4 + 1][r] = v.y;
      dst[part * 4 + 2][r] = v.z;
      dst[part * 4 + 3][r] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kSlice; e += kThreads) {
      const int r = e / kSlice, w = e % kSlice;
      const int gr = r0 + r, gk = k0 + w * 4;
      unsigned word = 0;
      if (gr < n) {
        const signed char* p = src + (size_t)gr * d;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gk + b < d) word |= (unsigned)(unsigned char)p[gk + b] << (8 * b);
      }
      dst[w][r] = (int)word;
    }
  }
}

// The body of both partial kernels.  MULTI: grid.z is the policy, whose
// slab starts at p*nc*d (its scales at p*nc) and whose count is
// n_valid_dev[p]; without it the policy offsets compile away.
template <int BQ, int BC, int TM, int TN, bool VEC, bool MULTI>
__device__ __forceinline__ void topk_partial(
    const void* __restrict__ qv, const void* __restrict__ cv,
    const float* __restrict__ qscale, const float* __restrict__ cscale,
    int nq, int nc, int d, int n_valid, const int* __restrict__ n_valid_dev,
    int k, int tiles_per_split, int list_in_smem, float* part_val,
    int* part_idx) {
  using Word = int;
  constexpr int TXN = BC / TN;  // threads along the candidate axis
  static_assert(TXN * (BQ / TM) == kThreads, "tile does not match block");
  constexpr int kStep = kSlice * 4;  // depth per slice
  __shared__ __align__(16) Word qs[kSlice][BQ + 4];
  __shared__ __align__(16) Word cs[kSlice][BC + 4];
  __shared__ float sc[BQ][BC + 1];
  __shared__ int cnt[BQ];
  extern __shared__ __align__(16) unsigned char dyn[];

  const int tid = threadIdx.x;
  const int tx = tid % TXN, ty = tid / TXN;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int pol = MULTI ? (int)blockIdx.z : 0;  // the policy slab
  if constexpr (MULTI) {  // slab p and its scales
    cv = static_cast<const signed char*>(cv) + (size_t)pol * nc * d;
    cscale += (size_t)pol * nc;
  }
  const int limit = max(0, min(MULTI ? n_valid_dev[pol] : n_valid, nc));
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (limit + BC - 1) / BC);
  // this block's partial lists: rows q0.. of (policy, split)
  const size_t part_row = (size_t)pol * gridDim.y * nq + (size_t)split * nq;

  // row r's list: lv + r*k, li + r*k
  float* lv;
  int* li;
  if (list_in_smem) {
    lv = reinterpret_cast<float*>(dyn);
    li = reinterpret_cast<int*>(dyn + (size_t)BQ * k * sizeof(float));
  } else {
    lv = part_val + (part_row + q0) * k;
    li = part_idx + (part_row + q0) * k;
  }
  for (int r = tid; r < BQ; r += kThreads) cnt[r] = 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BC;
    Word acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < d; k0 += kStep) {
      load_i8<BQ, VEC>(static_cast<const signed char*>(qv), q0, nq, d, k0, qs);
      load_i8<BC, VEC>(static_cast<const signed char*>(cv), c0, nc, d, k0, cs);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        Word a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = qs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx * TN + j;
        const int gq = q0 + row, gc = c0 + col;
        const float qsc = gq < nq ? qscale[gq] : 0.f;
        const float csc = gc < nc ? cscale[gc] : 0.f;
        sc[row][col] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qsc), csc);
      }
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += kWarps)
      if (q0 + r < nq)
        fold_row(sc[r], c0, BC, limit, k, lv + (size_t)r * k,
                 li + (size_t)r * k, &cnt[r], lane);
    __syncthreads();
  }

  __syncthreads();
  // the partial list of each row, padded with (-inf, 0)
  for (int r = warp; r < BQ; r += kWarps) {
    if (q0 + r >= nq) continue;
    const int n = cnt[r];
    float* ov = part_val + (part_row + q0 + r) * k;
    int* oi = part_idx + (part_row + q0 + r) * k;
    for (int j = lane; j < k; j += 32) {
      if (j >= n) {
        ov[j] = -CUDART_INF_F;
        oi[j] = 0;
      } else if (list_in_smem) {
        ov[j] = lv[(size_t)r * k + j];
        oi[j] = li[(size_t)r * k + j];
      }
    }
  }
}

// Single slab: the compiler's own register choice.
template <int BQ, int BC, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(kThreads)
sim_topk_partial(const void* __restrict__ qv, const void* __restrict__ cv,
                 const float* __restrict__ qscale,
                 const float* __restrict__ cscale, int nq, int nc, int d,
                 int n_valid, int k, int tiles_per_split, int list_in_smem,
                 float* part_val, int* part_idx) {
  topk_partial<BQ, BC, TM, TN, VEC, false>(
      qv, cv, qscale, cscale, nq, nc, d, n_valid, nullptr, k,
      tiles_per_split, list_in_smem, part_val, part_idx);
}

// Policy-stacked int8: held to four resident blocks per SM (at most 64
// registers a thread), the single-slab kernels' budget; left alone, the
// compiler spends more registers on the policy offsets and loses
// occupancy.
template <int BQ, int BC, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
sim_topk_multi_partial(const void* __restrict__ qv,
                       const void* __restrict__ cv,
                       const float* __restrict__ qscale,
                       const float* __restrict__ cscale, int nq, int nc,
                       int d, const int* __restrict__ n_valid_dev, int k,
                       int tiles_per_split, int list_in_smem, float* part_val,
                       int* part_idx) {
  topk_partial<BQ, BC, TM, TN, VEC, true>(
      qv, cv, qscale, cscale, nq, nc, d, 0, n_valid_dev, k, tiles_per_split,
      list_in_smem, part_val, part_idx);
}

template <int BQ, int BC, int TM, int TN, bool VEC>
cudaError_t launch_partial(const void* q, const void* c, const float* qs,
                           const float* cs, int nq, int nc, int d, int n_valid,
                           const int* n_valid_dev, int n_pol, int k,
                           int nsplit, int per, int list_in_smem, float* pv,
                           int* pi, cudaStream_t stream) {
  const size_t dyn = list_in_smem ? (size_t)BQ * k * 8 : 0;
  if (n_pol == 0) {
    const dim3 grid((nq + BQ - 1) / BQ, nsplit);
    sim_topk_partial<BQ, BC, TM, TN, VEC><<<grid, kThreads, dyn, stream>>>(
        q, c, qs, cs, nq, nc, d, n_valid, k, per, list_in_smem, pv, pi);
  } else {
    const dim3 grid((nq + BQ - 1) / BQ, nsplit, n_pol);
    sim_topk_multi_partial<BQ, BC, TM, TN, VEC>
        <<<grid, kThreads, dyn, stream>>>(q, c, qs, cs, nq, nc, d,
                                          n_valid_dev, k, per, list_in_smem,
                                          pv, pi);
  }
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_shape(int small, const void* q, const void* c,
                         const float* qs, const float* cs, int nq, int nc,
                         int d, int n_valid, const int* n_valid_dev,
                         int n_pol, int k, int nsplit, int per,
                         int list_in_smem, float* pv, int* pi,
                         cudaStream_t stream) {
  if (small)
    return launch_partial<8, 128, 1, 4, VEC>(
        q, c, qs, cs, nq, nc, d, n_valid, n_valid_dev, n_pol, k, nsplit, per,
        list_in_smem, pv, pi, stream);
  return launch_partial<64, 64, 4, 4, VEC>(
      q, c, qs, cs, nq, nc, d, n_valid, n_valid_dev, n_pol, k, nsplit, per,
      list_in_smem, pv, pi, stream);
}

// n_pol = 0: one slab with a host count; n_pol >= 1: n_pol stacked slabs
// with their counts in n_valid_dev
int launch(const void* q, const void* c, const float* qscale,
           const float* cscale, int vec, int nq, int nc, int d,
           int n_valid, const int* n_valid_dev, int n_pol, int k, int small,
           int nsplit, int tiles_per_split, int list_in_smem, float* part_val,
           int* part_idx, float* out_val, int* out_idx, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (vec)
    err = launch_shape<true>(
        small, q, c, qscale, cscale, nq, nc, d, n_valid, n_valid_dev, n_pol,
        k, nsplit, tiles_per_split, list_in_smem, part_val, part_idx, stream);
  else
    err = launch_shape<false>(
        small, q, c, qscale, cscale, nq, nc, d, n_valid, n_valid_dev, n_pol,
        k, nsplit, tiles_per_split, list_in_smem, part_val, part_idx, stream);
  if (err != cudaSuccess) return (int)err;
  const int nrows = (n_pol > 0 ? n_pol : 1) * nq;
  const size_t heads = (size_t)nsplit * sizeof(int);
  if (n_pol > 0)
    sim_topk_merge<true><<<nrows, 128, heads, stream>>>(
        part_val, part_idx, nsplit, nq, k, out_val, out_idx);
  else
    sim_topk_merge<false><<<nrows, 128, heads, stream>>>(
        part_val, part_idx, nsplit, nq, k, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/c are int8 with per-row fp32 scales; vec = 1 takes 16-byte loads
// (d % 16 == 0 and 16-byte aligned rows, checked by the wrapper).
// part_val/part_idx hold nsplit * nq * k partials; the wrapper allocates
// them and chooses small (8 x 128 tiles), nsplit, tiles_per_split and
// whether the lists fit in shared memory (8 * k * BQ <= 16384 bytes).
int sim_topk_launch(const void* q, const void* c, const float* qscale,
                    const float* cscale, int vec, int nq, int nc, int d,
                    int n_valid, int k, int small, int nsplit,
                    int tiles_per_split, int list_in_smem, float* part_val,
                    int* part_idx, float* out_val, int* out_idx, int device,
                    cudaStream_t stream) {
  return launch(q, c, qscale, cscale, vec, nq, nc, d, n_valid, nullptr,
                0, k, small, nsplit, tiles_per_split, list_in_smem, part_val,
                part_idx, out_val, out_idx, device, stream);
}

// Policy-stacked int8 Top-K: c is (n_pol, n_slots, d) int8 with cscale
// (n_pol, n_slots), n_valid_dev (n_pol,) int32 on the card, out_val/
// out_idx (n_pol, nq, k); part_val/part_idx hold n_pol * nsplit * nq * k
// partials.  Other arguments as sim_topk_launch.
int sim_topk_multi_launch(const void* q, const void* c, const float* qscale,
                          const float* cscale, int vec, int nq, int n_slots,
                          int d, const int* n_valid_dev, int n_pol, int k,
                          int small, int nsplit, int tiles_per_split,
                          int list_in_smem, float* part_val, int* part_idx,
                          float* out_val, int* out_idx, int device,
                          cudaStream_t stream) {
  if (n_pol < 1) return (int)cudaErrorInvalidValue;
  return launch(q, c, qscale, cscale, vec, nq, n_slots, d, 0,
                n_valid_dev, n_pol, k, small, nsplit, tiles_per_split,
                list_in_smem, part_val, part_idx, out_val, out_idx, device,
                stream);
}

}  // extern "C"
