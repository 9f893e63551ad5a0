// Top-1 cosine retrieval: (Q, D) queries x (N, D) candidates -> per query
// the best score and the lowest candidate index that reaches it.
//
// Replaces: repro/kernels/similarity_topk.py::sim_top1_pallas
// (_sim_top1_kernel), the hit and routing legs of the fused decision pass
// and the fused lookup's union rescore.
//
// What bounds it on an H100: at the replay's chunk width (Q = 512,
// N = 65,537, D = 768) the operations.  The kernel does three TF32
// products of 2*Q*N*D = 51.5 GFLOP each (below): 154.6 GFLOP, 0.312 ms at
// the 495 TFLOP/s TF32 tensor-core rate.  At lookup width (Q <= 16) the
// bytes: it reads the 201 MB slab once, about 0.06 ms at 3.35 TB/s.  At
// the union rescore's width (Q = 1, N = 8) neither: the latency of one
// block's walk over the depth.
//
// Numerics (three-way TF32): each fp32 operand x is split into
// hi = x rounded to TF32 (nearest, ties away: add 2^12 to the bits and
// clear the low 13) and lo = (x - hi) rounded the same way; x - hi is
// exact, so x = hi + lo up to 2^-22 |x|, and no TF32 input carries bits
// the tensor core might drop.  Per 8-deep k step, in ascending k and in
// this fixed order, the tensor core adds hi_q.hi_c, hi_q.lo_c and
// lo_q.hi_c (the products of two TF32 values are exact; lo_q.lo_c,
// 2^-22 of a term, is left out).  Every 32-deep chunk starts a fresh
// accumulator, which is added to the score in IEEE fp32 once the chunk is
// done: the tensor core's own accumulation rounds (perhaps toward zero),
// and over the 288 products of a D = 768 dot that bias would grow to
// several times the error of an IEEE fmaf chain; over 12 products it does
// not (an emulation on the CPU, tests/test_torch_numerics.py, and the
// card test against float64, tests/test_torch_gpu.py).  A TF32 product
// alone would flip decisions near tau_hit.
//
// Every score of a (query, row) pair is the same instruction sequence on
// the same operand bits whatever launched it: any Q and N, any split,
// the row's place in a tile, a stacked slice or a single slab, a count
// from the host or the card (the fused lookups' certificates rest on
// this, kernels/fused.py).  There is one tile shape and one arithmetic.
//
// Design:
//  - The TPU kernel merges candidate tiles sequentially through a
//    revisited output block.  Hopper blocks run in no order, so the
//    candidate axis is split across blocks (grid.y), each block walks the
//    candidate tiles of its split keeping a running (max, argmax) per
//    query in registers, and a second, tiny pass merges the per-split
//    partials in ascending split order with a strict '>': ties go to the
//    lower index, as the TPU merge and jnp.argmax do.  The query tile is
//    grid.x (the fastest-varying block index), so the blocks that share a
//    candidate range run together and the slab is read from L2 after its
//    first read.
//  - A block is one warpgroup: 64 queries (wgmma M) against tiles of 64
//    candidates (N), the depth in 32-float chunks (one 128-byte row).  The
//    128 threads keep a ring of NS = 2 chunks with cp.async (16-byte
//    copies where every row and base is 16-byte aligned, 4-byte otherwise:
//    D = 770 rows are 3,080 bytes, which TMA cannot take), each copied
//    straight to its 128-byte-swizzled place; copies past D are
//    zero-filled, so the padded depth adds exact zeros.
//  - Per chunk the threads split the candidates in place into hi and lo
//    (the K-major B operand of wgmma m64n64k8.tf32) and the queries into hi
//    and lo registers in the A-operand layout (the swizzle keeps those
//    reads on 32 banks), issue the chunk's 12 wgmmas into a fresh
//    accumulator, wait, and add it to the score.  A block's chunk is a
//    chain of dependent steps; four blocks share an SM (49 KB of shared
//    memory and at most 128 registers each), so the others' products and
//    copies fill each one's gaps: measured on an H100, four blocks with
//    two stages beat three with three (chip_ab_flash.py --top1).
//  - Columns at or past n_valid (the free tail) score -inf; a row with no
//    column comes back as (-inf, 0).  n_valid comes as a host int or, when
//    n_valid_dev is not null, as an int32 on the card that the kernel reads
//    itself (the fused lookup's union rescore masks to a count it computed
//    on the card, with no host sync in between).
//
// The policy-stacked entry (sim_top1_multi_launch) replaces
// repro/kernels/ops.py::sim_top1_multi_raw, which walks P policy slabs
// with lax.map over the TPU kernel inside one dispatch: the multi-policy
// arena's snapshot scan, one per chunk.  Here the policy is a grid axis
// (grid.z): block (x, y, p) reads slab p at offset p*S*D and policy p's
// count n_valid_dev[p], so all P slabs are one launch plus one merge pass
// over P*Q rows.  A policy's slice is bit-equal to a single-slab launch on
// that slab: the same body.  At the arena's shape (Q = 512, P = 15,
// S = 6,852, D = 768) the work is 3 x 80.8 GFLOP, 0.49 ms at the TF32
// rate, against 316 MB of slab (0.094 ms).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int BM = 64;         // queries per block (wgmma M)
constexpr int BN = 64;         // candidates per tile (wgmma N)
constexpr int KC = 32;         // depth of a chunk: 128 bytes of fp32
constexpr int NS = 2;          // chunks in the cp.async ring
constexpr int C_BYTES = BN * KC * 4;  // a candidate chunk (hi, then lo)
constexpr int Q_BYTES = BM * KC * 4;  // a query chunk
constexpr int STAGE = 2 * C_BYTES + Q_BYTES;
constexpr int SMEM = 1024 + NS * STAGE;  // 49 KB: four blocks an SM

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// x rounded to TF32 (nearest, ties away from zero): its low 13 bits clear
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the A fragments: reg_fence for a [4][4] array (hopper.cuh has the
// one-dimensional ones)
__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// d (64 x 64, fp32) (+)= a (64 x 8, TF32 in registers) . b (64 x 8, TF32,
// K-major in shared memory)^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The body of both entries.  VEC: floats per cp.async (4: 16-byte copies,
// 1: 4-byte).  MULTI: grid.z is the policy, whose slab starts at p*nc*d and
// whose count is n_valid_dev[p].
template <int VEC, bool MULTI>
__global__ void __launch_bounds__(kThreads, 4)
    sim_top1_partial(const float* __restrict__ q, const float* __restrict__ c,
                     int nq, int nc, int d, int n_valid,
                     const int* __restrict__ n_valid_dev, int tiles_per_split,
                     float* __restrict__ part_val,
                     int* __restrict__ part_idx) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  // stage s: the candidate chunk [BN][KC] (copied in, then split in place
  // into its hi part) and its lo part, both 128-byte swizzled (16-byte
  // piece j of row r at piece j ^ (r % 8)), then the query chunk [BM][KC],
  // swizzled the same way
  float* const stage_g = reinterpret_cast<float*>(smem_raw + (base - raw));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  if (MULTI) c += (size_t)blockIdx.z * nc * d;
  const int limit =
      MULTI ? max(0, min(n_valid_dev[blockIdx.z], nc))
            : max(0, min(n_valid_dev != nullptr ? *n_valid_dev : n_valid, nc));
  const int ntiles = (limit + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);
  const int nch = (d + KC - 1) / KC;
  const int total_chunks = max(0, t_end - t_begin) * nch;
  const int qrows = min(BM, nq - q0);  // staged query rows; the rest are 0

  // query rows past Q never get a copy: zero them in every stage once
  for (int e = tid; e < NS * (BM - qrows) * KC; e += kThreads) {
    const int st = e / ((BM - qrows) * KC), r = e % ((BM - qrows) * KC);
    stage_g[(st * STAGE + 2 * C_BYTES) / 4 + qrows * KC + r] = 0.f;
  }

  // element (r, k) of a chunk: float r * KC + ((k / 4) ^ (r % 8)) * 4 + k % 4
  auto swz = [](int r, int k) { return r * KC + (((k / 4) ^ (r % 8)) * 4) + k % 4; };

  // chunk g (tile t_begin + g / nch, depth (g % nch) * KC) into stage g % NS
  auto load = [&](int g) {
    if (g < total_chunks) {
      const int c0 = (t_begin + g / nch) * BN, k0 = (g % nch) * KC;
      const uint32_t cs = base + (g % NS) * STAGE, qs = cs + 2 * C_BYTES;
      const int crows = min(BN, limit - c0);
      constexpr int PER_ROW = KC / VEC;
      for (int e = tid; e < crows * PER_ROW; e += kThreads) {
        const int r = e / PER_ROW, k = (e % PER_ROW) * VEC;
        const int bytes = k0 + k < d ? min(VEC, d - k0 - k) * 4 : 0;
        const float* src = c + (size_t)(c0 + r) * d + (bytes ? k0 + k : 0);
        if (VEC == 4)
          cp_async16(cs + swz(r, k) * 4, src, bytes);
        else
          cp_async4(cs + swz(r, k) * 4, src, bytes);
      }
      for (int e = tid; e < qrows * PER_ROW; e += kThreads) {
        const int r = e / PER_ROW, k = (e % PER_ROW) * VEC;
        const int bytes = k0 + k < d ? min(VEC, d - k0 - k) * 4 : 0;
        const float* src = q + (size_t)(q0 + r) * d + (bytes ? k0 + k : 0);
        if (VEC == 4)
          cp_async16(qs + swz(r, k) * 4, src, bytes);
        else
          cp_async4(qs + swz(r, k) * 4, src, bytes);
      }
    }
    cp_commit();  // one group per chunk, empty past the end
  };

  // this thread's rows r0 = 16 warp + gid and r1 = r0 + 8 of the block's
  // 64; columns 8 j + 2 tig + {0, 1} of a tile (accumulator i: row
  // (i & 2 ? r1 : r0), column 8 (i / 4) + 2 tig + (i & 1))
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  float bv0 = -CUDART_INF_F, bv1 = -CUDART_INF_F;
  int bi0 = INT_MAX, bi1 = INT_MAX;  // no column seen; the merge maps to 0
  float acc[32], score[32];
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) score[i] = 0.f;

  // Per chunk: split it, issue its 12 products into acc (a fresh
  // accumulator), wait, add acc to the score; after a tile's last chunk,
  // fold its scores into the running best.  The copies of the next NS - 1
  // chunks are in flight meanwhile, and the other blocks on the SM fill
  // the tensor core while this one splits.
  for (int g = 0; g < NS - 1; ++g) load(g);
  for (int g = 0; g < total_chunks; ++g) {
    cp_wait<NS - 2>();
    __syncthreads();  // chunk g is in; chunk g - 1's products are done
    load(g + NS - 1);  // into chunk g - 1's stage
    float* cs = stage_g + (g % NS) * STAGE / 4;
    const float* qs = cs + 2 * C_BYTES / 4;
    // the candidates: 512 16-byte pieces, 4 a thread, split in place
#pragma unroll
    for (int it = 0; it < BN * KC / 4 / kThreads; ++it) {
      float4* hp = reinterpret_cast<float4*>(cs) + tid + it * kThreads;
      const float4 x = *hp;
      float4 h, l;
      h.x = tf32(x.x); l.x = tf32(x.x - h.x);
      h.y = tf32(x.y); l.y = tf32(x.y - h.y);
      h.z = tf32(x.z); l.z = tf32(x.z - h.z);
      h.w = tf32(x.w); l.w = tf32(x.w - h.w);
      *hp = h;
      hp[C_BYTES / 16] = l;
    }
    // the queries, in the A layout of k step s: (r0, 8s + tig),
    // (r1, 8s + tig), (r0, 8s + tig + 4), (r1, 8s + tig + 4)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float x[4] = {qs[swz(r0, 8 * s + tig)], qs[swz(r1, 8 * s + tig)],
                          qs[swz(r0, 8 * s + tig + 4)],
                          qs[swz(r1, 8 * s + tig + 4)]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = tf32(x[i]);
        ah[s][i] = __float_as_uint(h);
        al[s][i] = __float_as_uint(tf32(x[i] - h));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // the split chunk is in shared memory
    const uint32_t hs = base + (g % NS) * STAGE, ls = hs + C_BYTES;
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32(acc, ah[s], sw128(hs + 32 * s), s > 0);
      wgmma_tf32(acc, ah[s], sw128(ls + 32 * s), 1);
      wgmma_tf32(acc, al[s], sw128(hs + 32 * s), 1);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(ah);
    reg_fence(al);
#pragma unroll
    for (int i = 0; i < 32; ++i) score[i] += acc[i];
    if (g % nch != nch - 1) continue;
    const int c0 = (t_begin + g / nch) * BN;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = c0 + 8 * (i / 4) + 2 * tig + (i & 1);
      const float v = col < limit ? score[i] : -CUDART_INF_F;
      if (i & 2) {
        if (better(v, col, bv1, bi1)) { bv1 = v; bi1 = col; }
      } else {
        if (better(v, col, bv0, bi0)) { bv0 = v; bi0 = col; }
      }
      score[i] = 0.f;
    }
  }
  cp_wait<0>();

  // a row's best over the 4 threads of its quad
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    float ov = __shfl_xor_sync(~0u, bv0, off);
    int oi = __shfl_xor_sync(~0u, bi0, off);
    if (better(ov, oi, bv0, bi0)) { bv0 = ov; bi0 = oi; }
    ov = __shfl_xor_sync(~0u, bv1, off);
    oi = __shfl_xor_sync(~0u, bi1, off);
    if (better(ov, oi, bv1, bi1)) { bv1 = ov; bi1 = oi; }
  }
  if (tig == 0) {
    const size_t part0 =
        ((MULTI ? (size_t)blockIdx.z * gridDim.y : 0) + split) * nq;
    if (q0 + r0 < nq) {
      part_val[part0 + q0 + r0] = bv0;
      part_idx[part0 + q0 + r0] = bi0;
    }
    if (q0 + r1 < nq) {
      part_val[part0 + q0 + r1] = bv1;
      part_idx[part0 + q0 + r1] = bi1;
    }
  }
}

// ascending split order with a strict '>': equal maxima keep the earlier
// split, i.e. the lower candidate index.  Row r of the (P, Q) output is
// policy r / nq, query r % nq; a row that saw no column comes back as
// (-inf, 0).
__global__ void sim_top1_merge(const float* __restrict__ part_val,
                               const int* __restrict__ part_idx, int nsplit,
                               int nq, int nrows, float* __restrict__ out_val,
                               int* __restrict__ out_idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrows) return;
  const size_t base = (size_t)(r / nq) * nsplit * nq + r % nq;
  float bv = part_val[base];
  int bi = part_idx[base];
  for (int s = 1; s < nsplit; ++s) {
    const float v = part_val[base + (size_t)s * nq];
    if (v > bv) {
      bv = v;
      bi = part_idx[base + (size_t)s * nq];
    }
  }
  out_val[r] = bv;
  out_idx[r] = bi == INT_MAX ? 0 : bi;
}

template <int VEC, bool MULTI>
cudaError_t launch_partial(dim3 grid, cudaStream_t stream, const float* q,
                           const float* c, int nq, int nc, int d,
                           int n_valid, const int* n_valid_dev,
                           int tiles_per_split, float* part_val,
                           int* part_idx) {
  cudaError_t err = cudaFuncSetAttribute(
      sim_top1_partial<VEC, MULTI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  // all of the SM's 228 KB as shared memory, so four blocks fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sim_top1_partial<VEC, MULTI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  sim_top1_partial<VEC, MULTI><<<grid, kThreads, SMEM, stream>>>(
      q, c, nq, nc, d, n_valid, n_valid_dev, tiles_per_split, part_val,
      part_idx);
  return cudaGetLastError();
}

// n_pol = 0: one slab with a host or device count; n_pol >= 1: n_pol
// stacked slabs with their counts in n_valid_dev
int launch(const float* q, const float* c, int nq, int nc, int d,
           int n_valid, const int* n_valid_dev, int n_pol, int nsplit,
           int tiles_per_split, float* part_val, int* part_idx,
           float* out_val, int* out_idx, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0 || nc <= 0 || d <= 0 || nsplit <= 0 || nsplit > 65535 ||
      n_pol > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + BM - 1) / BM, nsplit, n_pol > 0 ? n_pol : 1);
  // 16-byte copies need every row and both bases on 16-byte boundaries
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (n_pol == 0)
    err = vec ? launch_partial<4, false>(grid, stream, q, c, nq, nc, d,
                                         n_valid, n_valid_dev,
                                         tiles_per_split, part_val, part_idx)
              : launch_partial<1, false>(grid, stream, q, c, nq, nc, d,
                                         n_valid, n_valid_dev,
                                         tiles_per_split, part_val, part_idx);
  else
    err = vec ? launch_partial<4, true>(grid, stream, q, c, nq, nc, d, 0,
                                        n_valid_dev, tiles_per_split,
                                        part_val, part_idx)
              : launch_partial<1, true>(grid, stream, q, c, nq, nc, d, 0,
                                        n_valid_dev, tiles_per_split,
                                        part_val, part_idx);
  if (err != cudaSuccess) return (int)err;
  const int nrows = (n_pol > 0 ? n_pol : 1) * nq;
  sim_top1_merge<<<(nrows + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, nsplit, nq, nrows, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part_val/part_idx hold nsplit * nq partials; the wrapper allocates them.
// n_valid_dev, when not null, points at one int32 on the card that takes
// the place of n_valid.
int sim_top1_launch(const float* q, const float* c, int nq, int nc, int d,
                    int n_valid, const int* n_valid_dev, int nsplit,
                    int tiles_per_split, float* part_val, int* part_idx,
                    float* out_val, int* out_idx, int device,
                    cudaStream_t stream) {
  return launch(q, c, nq, nc, d, n_valid, n_valid_dev, 0, nsplit,
                tiles_per_split, part_val, part_idx, out_val, out_idx,
                device, stream);
}

// Policy-stacked Top-1: c is (n_pol, n_slots, d), n_valid_dev (n_pol,)
// int32 on the card, out_val/out_idx (n_pol, nq); part_val/part_idx hold
// n_pol * nsplit * nq partials.
int sim_top1_multi_launch(const float* q, const float* c, int nq,
                          int n_slots, int d, const int* n_valid_dev,
                          int n_pol, int nsplit, int tiles_per_split,
                          float* part_val, int* part_idx, float* out_val,
                          int* out_idx, int device, cudaStream_t stream) {
  if (n_pol < 1) return (int)cudaErrorInvalidValue;
  return launch(q, c, nq, n_slots, d, 0, n_valid_dev, n_pol, nsplit,
                tiles_per_split, part_val, part_idx, out_val, out_idx,
                device, stream);
}

}  // extern "C"
