// Top-K similarity in fp32: (Q, D) queries x (N, D) candidates -> per query
// the K best IEEE fp32 dot products, sorted descending, ties toward the
// lower candidate index.
//
// Replaces: repro/kernels/similarity_topk.py::sim_topk_pallas
// (_make_sim_topk_kernel, _topk_fold): the topic routing of the pruned
// lookup (ops.route_topics and kernels/fused.py over the (T, D+1) [rep |
// spread] matrix) and KernelBackend.topk_rows.
//
// Arithmetic: each (query, candidate) score is one fmaf chain from +0 in
// ascending depth: no split of the depth, no TF32, no fast math.  Every
// launch shape gives a pair the same bits, and they are the bits of the
// SIMT kernel this one replaced, so the routing bounds that gate the
// pruned lookup's certificate do not move.  Depth past D reads as zeros
// (fmaf(0, 0, acc) = acc).
//
// What bounds it on an H100: at a lookup's width (Q <= 16) the bytes of the
// candidates, read once (the routing matrix, 4,096 x 772 floats, 12.6 MB:
// 3.8 us at 3.35 TB/s; the 65,537 x 768 slab, 201 MB: 60 us); at Q = 512
// the FMAs, 2 Q N D at 67 TFLOP/s outside the tensor cores (routing 512
// queries over 4,096 topics: 3.2 GFLOP, 0.048 ms).
//
// Design:
//  - Skinny kernel (Q <= 16): the candidate rows carry the parallelism.  A
//    block is 1-4 warps sharing the queries (zero-padded to QT rows, a
//    power of two, in shared memory).  Each warp walks its own 32-row tiles
//    of the block's split through its own ring of NS chunks (32 rows x 64
//    floats of depth for one query, x 32 for more: three chunks in flight
//    a warp, 26 or 14 KB), 16 bytes a lane by cp.async, each row piece
//    read by neighbouring lanes (4-byte copies where a row is not 16-byte
//    aligned), so no block barrier stands in its loop (K <= 32).  Lane l
//    scores row l of the tile against every query (QT accumulators; the
//    queries are broadcast from shared memory; rows padded by 16 bytes
//    keep the float4 reads conflict-free).  The wrapper plans one wave of
//    the blocks the card holds at once (sim_topk_f32_slots asks the card),
//    with fewer warps a block where the candidates are few, so that the
//    4,096-row routing matrix spreads over 128 SMs.
//  - Wide kernel (Q > 16): 128 queries x 128 candidates a block of 256
//    threads, each an 8 x 8 register micro-tile (64 FMAs for 16 float4
//    reads a depth step of 4), both operands through a ring of four depth
//    chunks of 16 (cp.async), two block barriers a chunk.
//  - The fold, K <= 32: a list lives across a warp's registers (lane j
//    holds entry j).  A ballot against the K-th score picks the columns
//    that can enter; each takes a ballot for its position and one shuffle
//    of the tail.  Columns arrive in ascending order within a warp, so
//    equal scores keep the lower index ahead.  The skinny kernel's warps
//    merge their lists at the split's end (merge_path); the wide kernel
//    keeps each row's list in shared memory between its tiles.
//  - The fold, K > 32: the warps park a round's scores; a warp takes each
//    of its queries' columns that beat the K-th score, sorts them
//    (warp_sort) and merges them into the sorted list in one pass
//    (merge_path into a second buffer): nothing shifts a long list one
//    insertion at a time.  The lists live in shared memory (two buffers of
//    K entries a query) where they fit, else in a scratch buffer in device
//    memory.
//  - Splits and merge: the candidate axis is split across blocks, each
//    writes one sorted partial list a query, and a merge pass takes them by
//    (value descending, index ascending): merge_rows (a warp a row, K <=
//    8), merge_lists (a block a row, K > 8), or sim_topk_merge where
//    merge_lists' shared memory does not fit (topk_fold.cuh).
//  - Columns at or past n_valid are not read and never enter a list; a row
//    with fewer than K live columns ends in (-inf, 0).  Queries and
//    candidates take a row stride: the routing matrix's device mirror pads
//    its rows to a 16-byte pitch (772 floats for D + 1 = 769).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "topk_fold.cuh"

namespace {

constexpr int SKINNY_Q = 16;      // queries the skinny kernel takes
constexpr int RW = 32;            // candidate rows of a warp's tile
constexpr int NS = 4;             // chunks in a warp's ring
// depth floats of a skinny chunk: 64 for one query (a warp alone on an
// SM needs the deeper copies in flight), else 32 (two blocks an SM); the
// shared row pitch KC + 4 keeps float4 reads of 32 rows conflict-free
template <int QT>
struct Chunk {
  static constexpr int KC = QT == 1 ? 64 : 32;
  static constexpr int CP = KC + 4;
  static constexpr int STAGE = RW * CP;  // floats of one chunk
};
constexpr int MAXW = 4;           // warps of a skinny block
constexpr int BATCH = RW * MAXW;  // columns of a K > 32 round
constexpr int KREG = 32;          // register lists serve K <= KREG

constexpr int WB = 128;       // wide tile: queries and candidates
constexpr int WK = 16;        // depth of a wide chunk
constexpr int WP = WK + 4;    // its shared row pitch (80 bytes)
constexpr int WNS = 4;        // chunks in the wide ring
constexpr int kWide = 256;    // threads of a wide block
constexpr int PARK = WB + 1;  // floats of a parked wide row

constexpr int kSmemMax = 227 * 1024;  // shared memory a block may use

// rows [r0, r0 + ROWS) x depth [k0, k0 + DEPTH) of src (row stride ld)
// into dst (row pitch PITCH) by NT threads, this one thread t.  Rows at or
// past n and depth past d are zero-filled, not read.  VEC: 16-byte copies
// (ld a multiple of 4 floats, src 16-byte aligned), a row's pieces on
// neighbouring threads.
template <int ROWS, int DEPTH, int PITCH, int NT, bool VEC>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          long long ld, int r0, int n, int d,
                                          int k0, int t) {
  if constexpr (VEC) {
    constexpr int PARTS = DEPTH / 4;
    static_assert(ROWS * PARTS % NT == 0, "pieces do not divide");
#pragma unroll
    for (int i = 0; i < ROWS * PARTS / NT; ++i) {
      const int p = t + i * NT, r = p / PARTS, part = p % PARTS;
      const int gr = r0 + r, gk = k0 + part * 4;
      const int bytes = gr < n ? max(0, min(16, (d - gk) * 4)) : 0;
      cp_async<16>(dst + r * PITCH + part * 4,
                   bytes ? src + (size_t)gr * ld + gk : src, bytes);
    }
  } else {
    static_assert(ROWS * DEPTH % NT == 0, "pieces do not divide");
#pragma unroll 8
    for (int i = 0; i < ROWS * DEPTH / NT; ++i) {
      const int p = t + i * NT, r = p / DEPTH, kk = p % DEPTH;
      const int gr = r0 + r, gk = k0 + kk;
      const bool in = gr < n && gk < d;
      cp_async<4>(dst + r * PITCH + kk, in ? src + (size_t)gr * ld + gk : src,
                  in ? 4 : 0);
    }
  }
}

// Fold one 32-column step into a list held across the warp: lane j holds
// entry j (lv, li) of the n entries, thr is the K-th score (or -inf while
// the list is short); this lane's column col scores s.  Columns ascend
// within the step and from step to step.  After each insertion the ballot
// is taken again against the risen threshold, so the columns it shuts out
// cost nothing.
__device__ __forceinline__ void fold_reg(float s, int col, bool live,
                                         float& lv, int& li, int& n,
                                         float& thr, int k, int lane) {
  unsigned m = __ballot_sync(kFull, live && s > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    const float cv = __shfl_sync(kFull, s, src);
    // entries >= cv have lower indices: they stay ahead
    const int p = __popc(__ballot_sync(kFull, lane < n && lv >= cv));
    const float uv = __shfl_up_sync(kFull, lv, 1);
    const int ui = __shfl_up_sync(kFull, li, 1);
    if (lane == p) {
      lv = cv;
      li = col - lane + src;
    } else if (lane > p) {
      lv = uv;
      li = ui;
    }
    n = min(n + 1, k);
    thr = n < k ? -CUDART_INF_F : __shfl_sync(kFull, lv, k - 1);
    m &= (m - 1) & __ballot_sync(kFull, live && s > thr);
  }
}

// One K > 32 round of one query (one warp): the round's scores park[0, bc)
// of columns c0 + j join the query's sorted list.  list: two buffers of k
// (value, index) entries, [v0 | i0 | v1 | i1]; state: (length, current
// buffer); sv/si: a batch buffer of bc entries.
__device__ void fold_batch(const float* park, int c0, int bc, int col_end,
                           int k, float* list, int* state, float* sv, int* si,
                           int lane) {
  const int n = state[0], cur = state[1];
  const float* lv = list + (size_t)cur * 2 * k;
  const int* li = reinterpret_cast<const int*>(lv + k);
  const float thr = n < k ? -CUDART_INF_F : lv[k - 1];
  int m = 0;  // the columns that beat the K-th score, ascending
  for (int base = 0; base < bc; base += 32) {
    const int j = base + lane;
    const float v = j < bc && c0 + j < col_end ? park[j] : -CUDART_INF_F;
    const bool pass = v > thr;
    const unsigned bal = __ballot_sync(kFull, pass);
    if (pass) {
      const int at = m + __popc(bal & ((1u << lane) - 1));
      sv[at] = v;
      si[at] = c0 + j;
    }
    m += __popc(bal);
  }
  if (m == 0) return;
  int m2 = 1;
  while (m2 < m) m2 <<= 1;
  for (int t = m + lane; t < m2; t += 32) {
    sv[t] = -CUDART_INF_F;
    si[t] = INT_MAX;
  }
  __syncwarp();
  warp_sort(sv, si, m2, lane);
  float* ov = list + (size_t)(1 - cur) * 2 * k;
  merge_path(lv, li, n, sv, si, m, k, ov, reinterpret_cast<int*>(ov + k),
             lane);
  if (lane == 0) {
    state[0] = min(n + m, k);
    state[1] = 1 - cur;
  }
  __syncwarp();
}

// query i's sorted list of n entries (list, state as fold_batch) as its
// partial output row, padded with (-inf, 0)
__device__ __forceinline__ void write_list(const float* list,
                                           const int* state, int k,
                                           float* ov, int* oi, int lane) {
  const int n = state[0];
  const float* lv = list + (size_t)state[1] * 2 * k;
  const int* li = reinterpret_cast<const int*>(lv + k);
  for (int j = lane; j < k; j += 32) {
    ov[j] = j < n ? lv[j] : -CUDART_INF_F;
    oi[j] = j < n ? li[j] : 0;
  }
}

// The skinny kernel: grid.x is the split (tiles_per_split 32-row tiles),
// blockDim.x / 32 warps.  REG: K <= KREG, register lists; otherwise
// parked rounds and batched merges, with the lists in shared memory
// (lists == nullptr) or at lists + blockIdx.x * QT * 4 k.
template <int QT, bool VEC, bool REG>
__global__ void __launch_bounds__(MAXW * 32)
    topk_skinny(const float* __restrict__ q, long long ldq,
                const float* __restrict__ c, long long ldc, int nq, int nc,
                int d, int n_valid, int k, int tiles_per_split, float* lists,
                float* __restrict__ part_val, int* __restrict__ part_idx) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KC = Chunk<QT>::KC, CP = Chunk<QT>::CP;
  constexpr int STAGE = Chunk<QT>::STAGE;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  const int kc = (d + KC - 1) / KC, dp = kc * KC;
  const int limit = max(0, min(n_valid, nc));
  const int tiles = (limit + RW - 1) / RW;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, tiles);
  const int col_end = min(limit, t_end * RW);
  float* qs = smem;                                   // [QT][dp]
  float* rings = qs + QT * dp;                        // [nw][NS][STAGE]
  float* ring = rings + warp * NS * STAGE;
  // K > 32: the round's scores [QT][BATCH], the warps' batch buffers, the
  // lists' states (length, buffer) and the lists
  float* park = rings + nw * NS * STAGE;
  float* sv = park + QT * BATCH + warp * 2 * BATCH;
  int* si = reinterpret_cast<int*>(sv + BATCH);
  int* state = reinterpret_cast<int*>(park + QT * BATCH + nw * 2 * BATCH);
  float* lbase = lists != nullptr
                     ? lists + (size_t)blockIdx.x * QT * 4 * k
                     : reinterpret_cast<float*>(state + 2 * QT);

  // the queries, 4-byte copies that do not wait on each other (a load
  // and a store an element would serialise on the load's latency)
  for (int e = threadIdx.x; e < QT * dp; e += blockDim.x) {
    const int i = e / dp, kk = e % dp;
    const bool in = i < nq && kk < d;
    cp_async<4>(qs + e, in ? q + (size_t)i * ldq + kk : q, in ? 4 : 0);
  }
  cp_commit();
  if (!REG && threadIdx.x < 2 * QT) state[threadIdx.x] = 0;
  cp_wait<0>();
  __syncthreads();

  // round r holds tiles t_begin + r nw + w of the warps w; with K > 32
  // every warp walks every round (the rounds share barriers), its rows
  // past the split zero-filled and masked
  const int span = max(0, t_end - t_begin);
  const int my_tiles =
      REG ? max(0, (span - warp + nw - 1) / nw) : (span + nw - 1) / nw;
  const int total = my_tiles * kc;
  auto issue = [&](int j) {
    if (j < total) {
      const int tile = t_begin + (j / kc) * nw + warp;
      copy_rows<RW, KC, CP, 32, VEC>(ring + (j % NS) * STAGE, c, ldc,
                                     tile * RW, col_end, d, (j % kc) * KC,
                                     lane);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) issue(j);

  float lv[QT], thr[QT], acc[QT];
  int li[QT], ln[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    lv[i] = thr[i] = -CUDART_INF_F;
    li[i] = ln[i] = 0;
    acc[i] = 0.f;
  }
  for (int it = 0; it < total; ++it) {
    __syncwarp();  // every lane is done with the stage refilled next
    issue(it + NS - 1);
    cp_wait<NS - 1>();
    __syncwarp();  // chunk it has landed for every lane
    const int ch = it % kc;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] = 0.f;
    }
    const float* row = ring + (it % NS) * STAGE + lane * CP;
    const float* qc = qs + ch * KC;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(row + kk);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qc + i * dp + kk);
        acc[i] = fmaf(qv.x, cv.x, acc[i]);
        acc[i] = fmaf(qv.y, cv.y, acc[i]);
        acc[i] = fmaf(qv.z, cv.z, acc[i]);
        acc[i] = fmaf(qv.w, cv.w, acc[i]);
      }
    }
    if (ch != kc - 1) continue;
    const int r = it / kc;
    const int col = (t_begin + r * nw + warp) * RW + lane;
    const bool live = col < col_end;
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < QT; ++i)
        if (i < nq) fold_reg(acc[i], col, live, lv[i], li[i], ln[i], thr[i], k,
                             lane);
    } else {
#pragma unroll
      for (int i = 0; i < QT; ++i)
        park[i * BATCH + warp * RW + lane] = live ? acc[i] : -CUDART_INF_F;
      __syncthreads();
      const int c0 = (t_begin + r * nw) * RW;
      for (int i = warp; i < nq; i += nw)
        fold_batch(park + i * BATCH, c0, nw * RW, col_end, k,
                   lbase + (size_t)i * 4 * k, state + 2 * i, sv, si, lane);
      __syncthreads();
    }
  }

  if constexpr (REG) {
    // the warps' lists of each query, padded with (-inf, INT_MAX) to k
    // entries, merged into the block's partial list
    cp_wait<0>();
    __syncthreads();
    float* wv = rings;  // [nw][QT][KREG] values, then indices
    int* wi = reinterpret_cast<int*>(wv + nw * QT * KREG);
    float* bv = reinterpret_cast<float*>(wi + nw * QT * KREG) +
                warp * 4 * KREG;  // two merge buffers of this warp
    int* bi = reinterpret_cast<int*>(bv + 2 * KREG);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const bool in = i < nq && lane < ln[i];
      wv[(warp * QT + i) * KREG + lane] = in ? lv[i] : -CUDART_INF_F;
      wi[(warp * QT + i) * KREG + lane] = in ? li[i] : INT_MAX;
    }
    __syncthreads();
    for (int i = warp; i < nq; i += nw) {
      const float* av = wv + i * KREG;
      const int* ai = wi + i * KREG;
      for (int w2 = 1; w2 < nw; ++w2) {
        const int buf = w2 % 2;
        merge_path(av, ai, k, wv + (w2 * QT + i) * KREG,
                   wi + (w2 * QT + i) * KREG, k, k, bv + buf * KREG,
                   bi + buf * KREG, lane);
        av = bv + buf * KREG;
        ai = bi + buf * KREG;
      }
      const size_t at = ((size_t)blockIdx.x * nq + i) * k;
      if (lane < k) {
        const float v = av[lane];
        part_val[at + lane] = v;
        part_idx[at + lane] = v > -CUDART_INF_F ? ai[lane] : 0;
      }
    }
  } else {
    for (int i = warp; i < nq; i += nw) {
      const size_t at = ((size_t)blockIdx.x * nq + i) * k;
      write_list(lbase + (size_t)i * 4 * k, state + 2 * i, k, part_val + at,
                 part_idx + at, lane);
    }
  }
}

// The wide kernel: grid (query tiles of 128, splits of tiles_per_split
// 128-column tiles), 256 threads.  Thread (tx, ty) = (tid % 16, tid / 16)
// holds queries ty + 16 i and candidates tx + 16 j, i, j < 8.  REG: each
// row's list in shared memory between tiles, folded in registers;
// otherwise batched merges, lists as the skinny kernel's (lists + block *
// 128 * 4 k when not in shared memory).
template <bool VEC, bool REG>
__global__ void __launch_bounds__(kWide, 1)
    topk_wide(const float* __restrict__ q, long long ldq,
              const float* __restrict__ c, long long ldc, int nq, int nc,
              int d, int n_valid, int k, int tiles_per_split, float* lists,
              float* __restrict__ part_val, int* __restrict__ part_idx) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * WB, split = blockIdx.y;
  const int limit = max(0, min(n_valid, nc));
  const int tiles = (limit + WB - 1) / WB;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, tiles);
  const int col_end = min(limit, t_end * WB);
  const int kc = (d + WK - 1) / WK;
  const int total = max(0, t_end - t_begin) * kc;
  float* ring = smem;                       // [WNS][2][WB][WP]
  float* park = ring + WNS * 2 * WB * WP;   // [WB][PARK]
  float* extra = park + WB * PARK;
  // REG: the rows' lists [WB][KREG] (values, indices) and lengths
  float* rv = extra;
  int* ri = reinterpret_cast<int*>(rv + WB * KREG);
  int* rn = ri + WB * KREG;
  // K > 32: the warps' batch buffers, the rows' states, the lists
  float* sv = extra + warp * 2 * WB;
  int* si = reinterpret_cast<int*>(sv + WB);
  int* state = reinterpret_cast<int*>(extra + 8 * 2 * WB);
  float* lbase =
      lists != nullptr
          ? lists + ((size_t)split * gridDim.x + blockIdx.x) * WB * 4 * k
          : reinterpret_cast<float*>(state + 2 * WB);
  if constexpr (REG) {
    for (int e = tid; e < WB * KREG; e += kWide) {
      rv[e] = -CUDART_INF_F;
      ri[e] = 0;
    }
    if (tid < WB) rn[tid] = 0;
  } else {
    if (tid < 2 * WB) state[tid] = 0;
  }

  auto issue = [&](int j) {
    if (j < total) {
      float* st = ring + (j % WNS) * 2 * WB * WP;
      const int k0 = (j % kc) * WK;
      copy_rows<WB, WK, WP, kWide, VEC>(st, q, ldq, q0, nq, d, k0, tid);
      copy_rows<WB, WK, WP, kWide, VEC>(st + WB * WP, c, ldc,
                                        (t_begin + j / kc) * WB, col_end, d,
                                        k0, tid);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < WNS - 1; ++j) issue(j);

  float acc[8][8];
  for (int it = 0; it < total; ++it) {
    __syncthreads();  // the stage refilled next is read by no one
    issue(it + WNS - 1);
    cp_wait<WNS - 1>();
    __syncthreads();  // chunk it has landed for every thread
    const int ch = it % kc;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* as = ring + (it % WNS) * 2 * WB * WP;
    const float* bs = as + WB * WP;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * WP + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * WP + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
    if (ch != kc - 1) continue;
    const int c0 = (t_begin + it / kc) * WB;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        park[(ty + 16 * i) * PARK + tx + 16 * j] = acc[i][j];
    __syncthreads();
    for (int r = 0; r < 16; ++r) {  // warp w folds rows 16 w + r
      const int row = warp * 16 + r;
      if (q0 + row >= nq) break;
      if constexpr (REG) {
        float lv = rv[row * KREG + lane];
        int li = ri[row * KREG + lane], n = rn[row];
        float thr = n < k ? -CUDART_INF_F : __shfl_sync(kFull, lv, k - 1);
#pragma unroll
        for (int base = 0; base < WB; base += 32) {
          const int col = c0 + base + lane;
          fold_reg(park[row * PARK + base + lane], col, col < col_end, lv, li,
                   n, thr, k, lane);
        }
        rv[row * KREG + lane] = lv;
        ri[row * KREG + lane] = li;
        if (lane == 0) rn[row] = n;
      } else {
        fold_batch(park + row * PARK, c0, WB, col_end, k,
                   lbase + (size_t)row * 4 * k, state + 2 * row, sv, si, lane);
      }
    }
  }

  __syncthreads();
  for (int r = 0; r < 16; ++r) {  // each row's list as its partial output
    const int row = warp * 16 + r;
    if (q0 + row >= nq) break;
    const size_t at = ((size_t)split * nq + q0 + row) * k;
    if constexpr (REG) {
      if (lane < k) {
        const bool in = lane < rn[row];
        part_val[at + lane] = in ? rv[row * KREG + lane] : -CUDART_INF_F;
        part_idx[at + lane] = in ? ri[row * KREG + lane] : 0;
      }
    } else {
      write_list(lbase + (size_t)row * 4 * k, state + 2 * row, k,
                 part_val + at, part_idx + at, lane);
    }
  }
}

using Kernel = void (*)(const float*, long long, const float*, long long, int,
                        int, int, int, int, int, float*, float*, int*);

template <bool VEC, bool REG>
Kernel skinny_for(int nq) {
  if (nq <= 1) return topk_skinny<1, VEC, REG>;
  if (nq <= 2) return topk_skinny<2, VEC, REG>;
  if (nq <= 4) return topk_skinny<4, VEC, REG>;
  if (nq <= 8) return topk_skinny<8, VEC, REG>;
  return topk_skinny<16, VEC, REG>;
}

Kernel kernel_for(int nq, int k, bool vec) {
  const bool reg = k <= KREG;
  if (nq > SKINNY_Q)
    return vec ? (reg ? topk_wide<true, true> : topk_wide<true, false>)
               : (reg ? topk_wide<false, true> : topk_wide<false, false>);
  return vec ? (reg ? skinny_for<true, true>(nq) : skinny_for<true, false>(nq))
             : (reg ? skinny_for<false, true>(nq)
                    : skinny_for<false, false>(nq));
}

// bytes of dynamic shared memory of a launch (see the kernels' layouts)
size_t smem_bytes(int nq, int d, int k, int warps, bool in_smem) {
  const bool reg = k <= KREG;
  size_t f;  // floats
  if (nq <= SKINNY_Q) {
    int qt = 1;
    while (qt < nq) qt <<= 1;
    const int kc = qt == 1 ? Chunk<1>::KC : Chunk<2>::KC;
    const int stage = qt == 1 ? Chunk<1>::STAGE : Chunk<2>::STAGE;
    const int dp = (d + kc - 1) / kc * kc;
    f = (size_t)qt * dp + (size_t)warps * NS * stage;
    if (!reg) {
      f += (size_t)qt * BATCH + (size_t)warps * 2 * BATCH + 2 * qt;
      if (in_smem) f += (size_t)qt * 4 * k;
    }
  } else {
    f = (size_t)WNS * 2 * WB * WP + (size_t)WB * PARK;
    if (reg) {
      f += (size_t)WB * KREG * 2 + WB;
    } else {
      f += (size_t)8 * 2 * WB + 2 * WB;
      if (in_smem) f += (size_t)WB * 4 * k;
    }
  }
  return f * sizeof(float);
}

int threads_of(int nq, int warps) {
  return nq > SKINNY_Q ? kWide : 32 * warps;
}

// the skinny kernel's warps a block, fewer than asked where their rings
// and the queries would not fit its shared memory (a wide D); 0 when not
// even one warp's do
int fit_warps(int nq, int d, int k, int warps) {
  if (nq > SKINNY_Q) return warps;
  while (warps > 0 && smem_bytes(nq, d, k, warps, false) > (size_t)kSmemMax)
    --warps;
  return warps;
}

// the lists of K > 32 stay in shared memory when the block's whole layout
// with them fits
bool lists_fit(int nq, int d, int k, int warps) {
  return k > KREG && smem_bytes(nq, d, k, warps, true) <= (size_t)kSmemMax;
}

// lists a batch of merge_lists copies at once for this K
int merge_batch(int k) { return k <= 64 ? 8 : 2; }

// warps of merge_lists for this K (each holds 2 + 2 merge_batch(k) lists
// of k entries of 8 bytes), 0 when one warp's do not fit: sim_topk_merge
int merge_warps(int k) {
  const int fit = kSmemMax / ((2 + 2 * merge_batch(k)) * 8 * k);
  return fit >= 16 ? 16 : fit >= 8 ? 8 : fit >= 4 ? 4 : fit >= 2 ? 2 : fit;
}

}  // namespace

extern "C" {

// The blocks of a launch for (nq, d, k, warps, vec) the card holds at once
// (in *slots: blocks an SM times the SMs) and whether its K > 32 lists fit
// in shared memory (*in_smem).  The wrapper plans its splits from these.
int sim_topk_f32_slots(int nq, int d, int k, int warps, int vec, int device,
                       int* slots, int* in_smem) {
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  warps = fit_warps(nq, d, k, warps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const bool fit = lists_fit(nq, d, k, warps);
  const size_t smem = smem_bytes(nq, d, k, warps, fit);
  const Kernel kernel = kernel_for(nq, k, vec != 0);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads_of(nq, warps), smem);
  *slots = sms * per_sm;
  *in_smem = fit;
  return (int)err;
}

// fp32 Top-K.  q (nq, d) with row stride ldq, c (nc, d) with row stride
// ldc (floats); vec: both strides multiples of 4 and both bases 16-byte
// aligned.  nq <= 16: the skinny kernel, `warps` warps a block, nsplit
// blocks of tiles_per_split 32-row tiles; nq > 16: the wide kernel,
// (ceil(nq / 128), nsplit) blocks of tiles_per_split 128-column tiles.
// K > 32 with list_in_smem = 0 (sim_topk_f32_slots says) keeps the lists in
// `lists`: blocks * rows * 4 k floats (rows: the power of two >= nq, or
// 128).  part_val/part_idx hold nsplit * nq * k partials.
int sim_topk_f32_launch(const float* q, long long ldq, const float* c,
                        long long ldc, int nq, int nc, int d, int n_valid,
                        int k, int vec, int warps, int nsplit,
                        int tiles_per_split, int list_in_smem, float* lists,
                        float* part_val, int* part_idx, float* out_val,
                        int* out_idx, int device, cudaStream_t stream) {
  if (nq < 1 || d < 1 || k < 1 || warps < 1 || warps > MAXW || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  warps = fit_warps(nq, d, k, warps);
  if (warps < 1 || (k > KREG && !list_in_smem && lists == nullptr) ||
      (list_in_smem && !lists_fit(nq, d, k, warps)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Kernel kernel = kernel_for(nq, k, vec != 0);
  const size_t smem = smem_bytes(nq, d, k, warps, list_in_smem != 0);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = nq > SKINNY_Q ? dim3((nq + WB - 1) / WB, nsplit)
                                  : dim3(nsplit);
  kernel<<<grid, threads_of(nq, warps), smem, stream>>>(
      q, ldq, c, ldc, nq, nc, d, n_valid, k, tiles_per_split,
      list_in_smem ? nullptr : lists, part_val, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mw = merge_warps(k);
  if (k <= 8) {
    merge_rows<false, 8><<<(nq + 3) / 4, 128, 0, stream>>>(
        part_val, part_idx, nsplit, nq, nq, k, out_val, out_idx);
  } else if (mw > 0) {
    const int nb = merge_batch(k), bytes = (2 + 2 * nb) * 8 * k * mw;
    err = cudaFuncSetAttribute(merge_lists<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    merge_lists<false><<<nq, 32 * mw, bytes, stream>>>(
        part_val, part_idx, nsplit, nq, k, nb, out_val, out_idx);
  } else {
    sim_topk_merge<false><<<nq, 128, (size_t)nsplit * sizeof(int), stream>>>(
        part_val, part_idx, nsplit, nq, k, out_val, out_idx);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
