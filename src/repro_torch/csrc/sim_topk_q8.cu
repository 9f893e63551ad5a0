// Int8 Top-K on the tensor cores: (Q, D) int8 queries with per-row fp32
// scales x (N, D) int8 candidates with per-row fp32 scales -> per query
// the K best scores (float(q8 . c8) * qscale[row]) * cscale[col], sorted
// descending, ties toward the lower candidate index.
//
// Replaces: repro/kernels/similarity_topk.py::sim_topk_q8_pallas
// (_make_sim_topk_q8_kernel), the int8 candidate scan of the quantized
// lookups, and repro/kernels/ops.py::sim_topk_q8_multi_raw (lax.map of it
// over P policy slabs: the quantized arena's snapshot scan).  It takes
// every int8 call whose rows TMA can read (D a multiple of 16, at most
// 1,024, 16-byte-aligned bases); the others stay on the __dp4a kernel of
// sim_topk.cu.  Numerically it is that kernel: int8 x int8 -> int32 sums
// are exact in any order (D * 127^2 < 2^31), and the score is
// __fmul_rn(__fmul_rn(__int2float_rn(acc), qscale), cscale), so the
// values are bit-equal to the plain version and the host gemm.
//
// What bounds it on an H100: at the staged peek's width (Q = 512,
// N = 65,537, D = 768) the operations, 2 * Q * N * D = 51.5 G int8
// operations, 0.026 ms at the tensor cores' 1,979 TOPS, against 50 MB of
// slab (0.015 ms at 3.35 TB/s); at a lookup's width (Q <= 16) the bytes.
// The arena's stacked scan (Q = 512, P = 15, S = 6,852): 80.8 G
// operations, 0.041 ms, against 79 MB (0.024 ms).
//
// Design:
//  - The product is wgmma m64n64k32.s32.s8.s8: 64 queries (M) against 64
//    candidate rows (N), both operands K-major in shared memory, as the
//    row-major q8 and c8 already are.  The queries take the M side, as in
//    B1: at Q <= 16 most of each instruction is wasted, but there the
//    bytes bound the scan, not the tensor cores.
//  - A block is one consumer warpgroup and one producer warp (160
//    threads).  The producer's one thread loads the block's query tile
//    once (D / 128 boxes of 64 rows x 128 bytes, resident for the whole
//    walk), then streams the candidates through a ring of NS = 6 chunks of
//    64 rows x 128 bytes with cp.async.bulk.tensor (TMA), each guarded by
//    a full and an empty mbarrier.  The boxes land 128-byte swizzled, the
//    layout the wgmma descriptors name.  TMA fills rows past the tensor
//    and depth past D with zeros, so the ragged edges need no padding copy
//    and add exact zeros.  At D = 768 a block takes 48 KB of queries,
//    48 KB of ring and 8 KB of stash (below): two blocks share an SM, and
//    each one's epilogue runs under the other's products (one block an
//    SM with eight stages measured 57% slower at Q = 512 on an H100,
//    chip_ab_flash.py --q8 --ablate).
//  - The consumer issues a chunk's four k-steps into one accumulator
//    (32 int32 a thread), keeps one chunk's group in flight (wait_group 1)
//    and frees each stage as its group completes.  Every wgmma is issued
//    on a path that depends only on the grid and the arguments (ptxas
//    serialises one it cannot prove warp-uniform).
//  - The candidate axis is split across blocks (grid.y), the query tile
//    is grid.x (fastest), so the blocks that share a candidate range run
//    together and re-read it from L2.  The wrapper plans the splits
//    (split_plan) to fill one wave of the blocks the card holds at once
//    (sim_topk_q8_wgmma_slots asks the card): a block's fold is cheap
//    once its lists are warm, so the longest splits that fill the card
//    win, and a second, partial wave only adds a tail (the ablation in
//    chip_ab_flash.py --q8, PERF.md).  A merge pass takes the per-split
//    lists by (value descending, index ascending).
//  - The fold, for K <= 8 (the lookups' K): the accumulator layout gives
//    each thread two query rows and 16 of every 64 columns, so each
//    thread keeps its own sorted lists of its 8 best columns per row in
//    registers, inserting with a fixed compare-and-select ladder (no
//    shuffles, no shared memory, nothing serial across the warp).  A
//    column is a candidate only if it beats the lane's 8th score and is
//    no lower than a bound the row's 8th best already reaches (from the
//    four lanes' 8th, 4th and 2nd scores: 8 entries of the row lie above
//    it).  The candidates of a tile go to a per-thread stash in shared
//    memory and only they are inserted, so a warp runs as many insertions
//    as its busiest lane has, not one for every slot any lane fills.
//    Columns are visited in ascending order within a lane, so equal
//    scores keep the lower index ahead.  At the split's end the four
//    lanes' lists of a row are merged by (value descending, index
//    ascending); the merge pass takes a warp per output row, each lane
//    folding whole split lists into its own with the same ladder.
//  - The fold, for K > 8: each warp parks its 16 rows of the tile in
//    shared memory and folds them with fold_row, the __dp4a kernel's
//    warp-per-row ballot fold, into lists in shared memory (when 64 K
//    entries fit in 16 KB) or in the partial output; its merge is the
//    __dp4a kernel's, sim_topk_merge (topk_fold.cuh).
//  - Columns at or past n_valid never enter a list; a row with fewer than
//    K live columns ends in (-inf, 0).  The policy-stacked entry reads
//    one tensor map over the flat (P * S, D) slab: block (x, y, p) walks
//    rows p * S onwards under policy p's count n_valid_dev[p], read on the
//    card, so rows past it (the next policy's) are masked by the count and
//    the last policy's tail is zero-filled.  A policy's slice is
//    bit-equal to a single-slab launch on that slab.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "topk_fold.cuh"

namespace {

constexpr int BM = 64;                     // queries per block (wgmma M)
constexpr int BN = 64;                     // candidate rows per tile (N)
constexpr int SPAN = 128;                  // depth bytes of a chunk
constexpr int KSTEPS = SPAN / 32;          // wgmma k32 steps per chunk
constexpr int MAX_D = 1024;                // depth of the resident queries
constexpr int NS = 6;                      // chunks in the ring
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int KR = 8;                      // register lists serve K <= KR
constexpr int CHUNK = BM * SPAN;           // 8 KB: a query or row chunk
constexpr int PARK = BN + 8;               // floats of a parked row
constexpr int BARS = 8 * (2 * NS + 1);
constexpr int kEncodeError = 1000;         // + the CUresult of the encode
static_assert(BM == BN, "query and candidate chunks share one box");

// bytes of dynamic shared memory: 1,024 of slack to align the chunks, the
// query chunks, the ring, the mbarriers; for K <= KR the consumers'
// stashes of 16 scores, else the row counts, the parked tiles of the four
// warps and (list_in_smem) the lists
__host__ __device__ constexpr int smem_bytes(int kc, bool reg, int k,
                                             bool list_in_smem) {
  return 1024 + (kc + NS) * CHUNK + (BARS + 15) / 16 * 16 +
         (reg ? 16 * kConsumers * 4
              : BM * 4 + 4 * 16 * PARK * 4 + (list_in_smem ? BM * k * 8 : 0));
}

// d (64 x 64, int32) (+)= a (64 x 32, int8, smem) . b (64 x 32, int8,
// smem)^T, both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ float score(int acc, float qs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), qs), cs);
}

// the best head (value descending, index ascending) of the row's four
// lanes (a quad)
__device__ __forceinline__ void quad_best(float& hv, int& hi) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov = __shfl_xor_sync(kFull, hv, off);
    const int oi = __shfl_xor_sync(kFull, hi, off);
    if (ov > hv || (ov == hv && oi < hi)) {
      hv = ov;
      hi = oi;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_min(float x) {
  x = fminf(x, __shfl_xor_sync(kFull, x, 1));
  return fminf(x, __shfl_xor_sync(kFull, x, 2));
}

// a score the row's 8th best already reaches: at least 8 entries of its
// four lanes' lists are >= it (8 of one lane, 4 of each of two, or 2 of
// each of four), so a column below it is not among the row's K <= 8 best
__device__ __forceinline__ float row_bound(const float (&v)[KR]) {
  const float x = v[3], y = __shfl_xor_sync(kFull, x, 1);
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  const float second = fmaxf(fminf(hi, __shfl_xor_sync(kFull, hi, 2)),
                             fmaxf(lo, __shfl_xor_sync(kFull, lo, 2)));
  return fmaxf(quad_max(v[KR - 1]), fmaxf(second, quad_min(v[1])));
}

// one row's 16 scores of the tile into this lane's list (v, ix): R = 0
// for row ra, 2 for rb (its accumulators 4 i + R + {0, 1}).  The scores
// that can enter go to the lane's stash (16 floats, 128 apart), and only
// those are inserted, in ascending column order: the warp runs as many
// insertions as its busiest lane has, not one for each slot that any lane
// fills.
template <int R>
__device__ __forceinline__ void fold_rows(const int (&acc)[32], float qs,
                                          const float (&cs)[16], unsigned live,
                                          float (&v)[KR], int (&ix)[KR],
                                          float* stash, int col0) {
  const float bound = row_bound(v);
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float s = score(acc[4 * (j / 2) + R + j % 2], qs, cs[j]);
    if ((live >> j & 1) && s > v[KR - 1] && s >= bound) {
      stash[j * kConsumers] = s;
      m |= 1u << j;
    }
  }
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const float s = stash[j * kConsumers];
    if (s > v[KR - 1]) insert(v, ix, s, col0 + 8 * (j / 2) + j % 2);
  }
}

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// REG: K <= KR, lists in registers; otherwise parked tiles and fold_row.
// MULTI: grid.z is the policy, whose rows start at p * nc in the flat
// map, whose scales start at p * nc and whose count is n_valid_dev[p].
template <bool REG, bool MULTI>
__global__ void __launch_bounds__(kThreads)
    topk_q8_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const float* __restrict__ qscale,
                   const float* __restrict__ cscale, int nq, int nc, int d,
                   int n_valid, const int* __restrict__ n_valid_dev, int k,
                   int tiles_per_split, int list_in_smem,
                   float* __restrict__ part_val, int* __restrict__ part_idx) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const int kc = (d + SPAN - 1) / SPAN;
  const uint32_t q_sm = base;                // [chunk][64 rows][128 bytes]
  const uint32_t ring = base + kc * CHUNK;   // NS chunks of 64 rows
  const uint32_t full = ring + NS * CHUNK, empty = full + 8 * NS,
                 qbar = empty + 8 * NS;

  const int q0 = blockIdx.x * BM, split = blockIdx.y;
  const int pol = MULTI ? (int)blockIdx.z : 0;
  if constexpr (MULTI) cscale += (size_t)pol * nc;
  // the count, broadcast so that the compiler sees it is warp-uniform
  const int limit = __shfl_sync(
      kFull, max(0, min(MULTI ? n_valid_dev[pol] : n_valid, nc)), 0);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, (limit + BN - 1) / BN);
  const size_t part_row = ((size_t)pol * gridDim.y + split) * nq;
  const int wg = __shfl_sync(kFull, (int)threadIdx.x / kConsumers, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers && t_end > t_begin) {
      mbar_expect_tx(qbar, kc * CHUNK);
      for (int c = 0; c < kc; ++c)
        tma_load_2d(q_sm + c * CHUNK, &qmap, qbar, c * SPAN, q0);
      const int row0 = pol * nc;
      int it = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int c = 0; c < kc; ++c, ++it) {
          const int st = it % NS;
          if (it >= NS) mbar_wait(empty + 8 * st, (it / NS - 1) & 1);
          mbar_expect_tx(full + 8 * st, CHUNK);
          tma_load_2d(ring + st * CHUNK, &cmap, full + 8 * st, c * SPAN,
                      row0 + t * BN);
        }
    }
    return;
  }

  // the consumer warpgroup: this thread holds query rows ra and rb = ra + 8
  // of the tile, and columns 8 i + 2 quad + {0, 1} of every 64
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const float qsa = q0 + ra < nq ? qscale[q0 + ra] : 0.f;
  const float qsb = q0 + rb < nq ? qscale[q0 + rb] : 0.f;

  // REG: this lane's lists of rows ra and rb, and its stash of 16 scores
  float va[KR], vb[KR];
  int ia[KR], ib[KR];
  float* stash = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          (kc + NS) * CHUNK +
                                          (BARS + 15) / 16 * 16) +
                 threadIdx.x;
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    va[j] = vb[j] = -CUDART_INF_F;
    ia[j] = ib[j] = INT_MAX;
  }
  // otherwise: row r's list at lv + r k, its length cnt[r]; the warp's
  // parked tile
  uint8_t* extra = smem_raw + (base - raw) + (kc + NS) * CHUNK +
                   (BARS + 15) / 16 * 16;
  int* cnt = reinterpret_cast<int*>(extra);
  float* park = reinterpret_cast<float*>(extra + BM * 4) + warp * 16 * PARK;
  float* lv = list_in_smem
                  ? reinterpret_cast<float*>(extra + BM * 4 + 4 * 16 * PARK * 4)
                  : part_val + (part_row + q0) * k;
  int* li = list_in_smem ? reinterpret_cast<int*>(lv + (size_t)BM * k)
                         : part_idx + (part_row + q0) * k;
  if constexpr (!REG) {
    if (lane < 16) cnt[warp * 16 + lane] = 0;
    __syncwarp();
  }

  if (t_end > t_begin) mbar_wait(qbar, 0);
  int acc[32];
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BN;
    for (int c = 0; c < kc; ++c, ++it) {
      const int st = it % NS;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      wg_fence();
      // depth past D is zero in both operands: every chunk takes 4 steps
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_s8(acc, sw128(q_sm + c * CHUNK + kk * 32),
                 sw128(ring + st * CHUNK + kk * 32), c > 0 || kk > 0);
      wg_commit();
      if (c > 0) {  // the previous chunk's products are done: free it
        wg_wait<1>();
        release(empty + 8 * ((it - 1) % NS), lane);
      }
    }
    wg_wait<0>();
    reg_fence(acc);
    release(empty + 8 * ((it - 1) % NS), lane);

    if constexpr (REG) {
      // this lane's 16 columns of the tile: slot j is column
      // c0 + 8 (j / 2) + 2 quad + j % 2, ascending in j
      float cs[16];
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * (j / 2) + 2 * quad + j % 2;
        cs[j] = col < limit ? __ldg(cscale + col) : 0.f;
        live |= (unsigned)(col < limit) << j;
      }
      // rows past Q (the tile's zero-filled tail) take no columns
      fold_rows<0>(acc, qsa, cs, q0 + ra < nq ? live : 0u, va, ia, stash,
                   c0 + 2 * quad);
      fold_rows<2>(acc, qsb, cs, q0 + rb < nq ? live : 0u, vb, ib, stash,
                   c0 + 2 * quad);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + 2 * quad;
        const float cs0 = c0 + col < limit ? __ldg(cscale + c0 + col) : 0.f;
        const float cs1 =
            c0 + col + 1 < limit ? __ldg(cscale + c0 + col + 1) : 0.f;
        *reinterpret_cast<float2*>(park + (lane / 4) * PARK + col) =
            make_float2(score(acc[4 * i], qsa, cs0),
                        score(acc[4 * i + 1], qsa, cs1));
        *reinterpret_cast<float2*>(park + (lane / 4 + 8) * PARK + col) =
            make_float2(score(acc[4 * i + 2], qsb, cs0),
                        score(acc[4 * i + 3], qsb, cs1));
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int row = warp * 16 + r;
        if (q0 + row < nq)
          fold_row(park + r * PARK, c0, BN, limit, k, lv + (size_t)row * k,
                   li + (size_t)row * k, &cnt[row], lane);
      }
    }
  }

  if constexpr (REG) {
    // the row's K best among its four lanes' lists, best first
    for (int j = 0; j < k; ++j) {
      float ha = va[0], hb = vb[0];
      int hia = ia[0], hib = ib[0];
      quad_best(ha, hia);
      quad_best(hb, hib);
      pop(va, ia, va[0] == ha && ia[0] == hia);
      pop(vb, ib, vb[0] == hb && ib[0] == hib);
      if (quad == 0) {
        const bool fa = ha > -CUDART_INF_F, fb = hb > -CUDART_INF_F;
        if (q0 + ra < nq) {
          part_val[(part_row + q0 + ra) * k + j] = ha;
          part_idx[(part_row + q0 + ra) * k + j] = fa ? hia : 0;
        }
        if (q0 + rb < nq) {
          part_val[(part_row + q0 + rb) * k + j] = hb;
          part_idx[(part_row + q0 + rb) * k + j] = fb ? hib : 0;
        }
      }
    }
  } else {
    // each of the warp's rows: its list, padded with (-inf, 0)
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      if (q0 + row >= nq) continue;
      const int n = cnt[row];
      float* ov = part_val + (part_row + q0 + row) * k;
      int* oi = part_idx + (part_row + q0 + row) * k;
      for (int j = lane; j < k; j += 32) {
        if (j >= n) {
          ov[j] = -CUDART_INF_F;
          oi[j] = 0;
        } else if (list_in_smem) {
          ov[j] = lv[(size_t)row * k + j];
          oi[j] = li[(size_t)row * k + j];
        }
      }
    }
  }
}

// a (rows, d) int8 operand read in boxes of 64 rows x 128 bytes, swizzled
// as the descriptors expect; rows and depth past the tensor read as zeros
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int rows, int d) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {(cuuint32_t)SPAN, (cuuint32_t)BM};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool REG, bool MULTI>
cudaError_t launch_partial(const CUtensorMap& qm, const CUtensorMap& cm,
                           dim3 grid, size_t smem, const float* qs,
                           const float* cs, int nq, int nc, int d,
                           int n_valid, const int* n_valid_dev, int k,
                           int per, int list_in_smem, float* pv, int* pi,
                           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      topk_q8_kernel<REG, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  topk_q8_kernel<REG, MULTI><<<grid, kThreads, smem, stream>>>(
      qm, cm, qs, cs, nq, nc, d, n_valid, n_valid_dev, k, per, list_in_smem,
      pv, pi);
  return cudaGetLastError();
}

template <bool REG, bool MULTI>
int resident(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_q8_kernel<REG, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, topk_q8_kernel<REG, MULTI>, kThreads, smem);
  return (int)err;
}

}  // namespace

extern "C" {

// How many blocks of the launch sim_topk_q8_wgmma_launch would make for
// (d, k, list_in_smem, n_pol > 0) the card holds at once: blocks an SM
// (shared memory bounds it) times the SMs, in *slots.  The wrapper plans
// its splits to fill one such wave.
int sim_topk_q8_wgmma_slots(int d, int k, int list_in_smem, int multi,
                            int device, int* slots) {
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bool reg = k <= KR;
  const size_t smem =
      smem_bytes((d + SPAN - 1) / SPAN, reg, k, list_in_smem != 0);
  const int r = reg ? (multi ? resident<true, true>(smem, &per_sm)
                             : resident<true, false>(smem, &per_sm))
                    : (multi ? resident<false, true>(smem, &per_sm)
                             : resident<false, false>(smem, &per_sm));
  *slots = sms * per_sm;
  return r;
}

// Int8 Top-K on wgmma.  n_pol = 0: one slab c (nc, d) with scales cscale
// (nc,) and a host count n_valid; n_pol >= 1: n_pol stacked slabs c
// (n_pol, nc, d) with scales (n_pol, nc) and counts n_valid_dev (n_pol,)
// int32 on the card, outputs (n_pol, nq, k).  q (nq, d) with qscale (nq,).
// d a multiple of 16 and at most 1,024, q and c 16-byte aligned (the
// wrapper routes every other call to sim_topk_launch).  part_val/part_idx
// hold max(n_pol, 1) * nsplit * nq * k partials; list_in_smem (K > 8
// only) when 64 K entries fit in 16 KB.
int sim_topk_q8_wgmma_launch(const void* q, const void* c,
                             const float* qscale, const float* cscale,
                             int nq, int nc, int d, int n_valid,
                             const int* n_valid_dev, int n_pol, int k,
                             int nsplit, int tiles_per_split,
                             int list_in_smem, float* part_val,
                             int* part_idx, float* out_val, int* out_idx,
                             int device, cudaStream_t stream) {
  if (d % 16 != 0 || d > MAX_D || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16 || k < 1 || list_in_smem > 1 ||
      (list_in_smem && BM * k * 8 > 16384))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int groups = n_pol > 0 ? n_pol : 1;
  CUtensorMap qm, cm;
  CUresult r = make_map(encode, &qm, q, nq, d);
  if (r == CUDA_SUCCESS) r = make_map(encode, &cm, c, groups * nc, d);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const bool reg = k <= KR;
  const size_t smem =
      smem_bytes((d + SPAN - 1) / SPAN, reg, k, list_in_smem != 0);
  const dim3 grid((nq + BM - 1) / BM, nsplit, groups);
  if (reg && n_pol > 0)
    err = launch_partial<true, true>(qm, cm, grid, smem, qscale, cscale, nq,
                                     nc, d, 0, n_valid_dev, k,
                                     tiles_per_split, 0, part_val, part_idx,
                                     stream);
  else if (reg)
    err = launch_partial<true, false>(qm, cm, grid, smem, qscale, cscale, nq,
                                      nc, d, n_valid, nullptr, k,
                                      tiles_per_split, 0, part_val, part_idx,
                                      stream);
  else if (n_pol > 0)
    err = launch_partial<false, true>(qm, cm, grid, smem, qscale, cscale, nq,
                                      nc, d, 0, n_valid_dev, k,
                                      tiles_per_split, list_in_smem,
                                      part_val, part_idx, stream);
  else
    err = launch_partial<false, false>(qm, cm, grid, smem, qscale, cscale,
                                       nq, nc, d, n_valid, nullptr, k,
                                       tiles_per_split, list_in_smem,
                                       part_val, part_idx, stream);
  if (err != cudaSuccess) return (int)err;
  const int nrows = groups * nq;
  const size_t heads = (size_t)nsplit * sizeof(int);
  if (reg && n_pol > 0)
    merge_rows<true, KR><<<(nrows + 3) / 4, 128, 0, stream>>>(
        part_val, part_idx, nsplit, nq, nrows, k, out_val, out_idx);
  else if (reg)
    merge_rows<false, KR><<<(nrows + 3) / 4, 128, 0, stream>>>(
        part_val, part_idx, nsplit, nq, nrows, k, out_val, out_idx);
  else if (n_pol > 0)
    sim_topk_merge<true><<<nrows, 128, heads, stream>>>(
        part_val, part_idx, nsplit, nq, k, out_val, out_idx);
  else
    sim_topk_merge<false><<<nrows, 128, heads, stream>>>(
        part_val, part_idx, nsplit, nq, k, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
