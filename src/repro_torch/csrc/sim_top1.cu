// Top-1 cosine retrieval: (Q, D) queries x (N, D) candidates -> per query
// the best score and the lowest candidate index that reaches it.
//
// Replaces: repro/kernels/similarity_topk.py::sim_top1_pallas
// (_sim_top1_kernel), the hit and routing legs of the fused decision pass.
//
// What bounds it on an H100: at the replay's chunk width (Q = 512,
// N = 65,537, D = 768) the work is 2*Q*N*D = 51.5 GFLOP of IEEE fp32 FMA,
// about 0.77 ms at the 67 TFLOP/s fp32 rate outside the tensor cores, so it
// is compute-bound.  At lookup width (Q <= 16) it reads the 201 MB slab
// once, about 0.06 ms at 3.35 TB/s, so it is memory-bound.
//
// Design:
//  - The TPU kernel merges candidate tiles sequentially through a
//    revisited output block.  Hopper blocks run in no order, so the
//    candidate axis is split across blocks (grid.y) and each block loops
//    over the candidate tiles of its split, keeping a running (max, argmax)
//    in registers.  A second, tiny pass merges the per-split partials in
//    ascending split order with a strict '>', so ties go to the lower
//    index exactly as the TPU merge and jnp.argmax do.  The split count is
//    chosen by the wrapper so that the grid fills the card even at Q = 8.
//  - The query tile index is grid.x (the fastest-varying block index), so
//    the blocks that share a candidate range run at the same time and the
//    slab is served mostly from L2 after its first read.
//  - Dots run in IEEE fp32 with fmaf in ascending k order: no TF32 and no
//    tensor cores, because a TF32 score near tau_hit flips hit decisions.
//  - Two tile shapes: 64x64 with a 4x4 register micro-tile per thread for
//    wide query blocks (compute-bound), and 8x128 with a 1x4 micro-tile for
//    lookups (memory-bound, so few queries should not waste FMAs on
//    padding rows).
//  - Columns at or past n_valid (the free tail) and past N score -inf.  A
//    row whose columns are all masked comes back as (-inf, 0).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // depth of one shared-memory k slice

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int BQ, int BC, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
sim_top1_partial(const float* __restrict__ q, const float* __restrict__ c,
                 int nq, int nc, int d, int n_valid, int tiles_per_split,
                 float* __restrict__ part_val, int* __restrict__ part_idx) {
  constexpr int TXN = BC / TN;  // threads along the candidate axis
  static_assert(TXN * (BQ / TM) == kThreads, "tile does not match block");
  static_assert(TXN <= 32 && (TXN & (TXN - 1)) == 0, "row group is a warp part");
  // transposed tiles: k-major so a thread's TM rows / TN columns are
  // contiguous; the +4 pad keeps 16-byte alignment and spreads the
  // transposing stores over banks
  __shared__ __align__(16) float qs[kBK][BQ + 4];
  __shared__ __align__(16) float cs[kBK][BC + 4];

  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int ntiles = (nc + BC - 1) / BC;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);
  const int limit = min(n_valid, nc);

  float best_v[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_v[i] = -CUDART_INF_F;
    best_i[i] = 0x7fffffff;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BC;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kBK) {
      for (int e = tid; e < BQ * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int gq = q0 + r, gk = k0 + kk;
        qs[kk][r] = (gq < nq && gk < d) ? __ldg(q + (size_t)gq * d + gk) : 0.f;
      }
      for (int e = tid; e < BC * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int gc = c0 + r, gk = k0 + kk;
        cs[kk][r] = (gc < nc && gk < d) ? __ldg(c + (size_t)gc * d + gk) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = qs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx * TN + j;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = col < limit ? acc[i][j] : -CUDART_INF_F;
        if (better(v, col, best_v[i], best_i[i])) {
          best_v[i] = v;
          best_i[i] = col;
        }
      }
    }
  }

  // reduce each row over the TXN threads that share it (consecutive lanes)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = TXN / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      if (better(ov, oi, best_v[i], best_i[i])) {
        best_v[i] = ov;
        best_i[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty * TM + i;
      if (row < nq) {
        part_val[(size_t)split * nq + row] = best_v[i];
        part_idx[(size_t)split * nq + row] = best_i[i];
      }
    }
  }
}

// ascending split order with a strict '>': equal maxima keep the earlier
// split, i.e. the lower candidate index
__global__ void sim_top1_merge(const float* __restrict__ part_val,
                               const int* __restrict__ part_idx, int nsplit,
                               int nq, float* __restrict__ out_val,
                               int* __restrict__ out_idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nq) return;
  float bv = part_val[r];
  int bi = part_idx[r];
  for (int s = 1; s < nsplit; ++s) {
    const float v = part_val[(size_t)s * nq + r];
    if (v > bv) {
      bv = v;
      bi = part_idx[(size_t)s * nq + r];
    }
  }
  out_val[r] = bv;
  out_idx[r] = bi;
}

}  // namespace

extern "C" {

// part_val/part_idx hold nsplit * nq partials; the wrapper allocates them.
int sim_top1_launch(const float* q, const float* c, int nq, int nc, int d,
                    int n_valid, int small, int nsplit, int tiles_per_split,
                    float* part_val, int* part_idx, float* out_val,
                    int* out_idx, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (small) {
    dim3 grid((nq + 7) / 8, nsplit);
    sim_top1_partial<8, 128, 1, 4><<<grid, kThreads, 0, stream>>>(
        q, c, nq, nc, d, n_valid, tiles_per_split, part_val, part_idx);
  } else {
    dim3 grid((nq + 63) / 64, nsplit);
    sim_top1_partial<64, 64, 4, 4><<<grid, kThreads, 0, stream>>>(
        q, c, nq, nc, d, n_valid, tiles_per_split, part_val, part_idx);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sim_top1_merge<<<(nq + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, nsplit, nq, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
