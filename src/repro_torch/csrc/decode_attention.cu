// One-token GQA decode attention over a KV cache:
//   out[b, h] = softmax_j(scale * q[b, h] . k[b, j, h/G]) . v[b, j, h/G]
// over the keys j in [0, pos[b]] (clamped to the cache), fp32 arithmetic,
// the output in the input dtype (bf16 or fp32); scale is the caller's
// (1/sqrt(D) for GQA).  V has its own head dim DV <= D and may be the
// first DV columns of the K rows themselves (v_in_k): MLA's absorbed
// decode scores a 576-wide row [c_kv | k_rope] per key with one kv head
// for all 16 query heads (G = 16), V the row's 512-wide c_kv, and the
// scale 1/sqrt(hd + rope) = 1/sqrt(192) (repro/models/layers.py::mla_apply,
// XLA in the reference).  Then the kernel loads only the K tile and reads
// V from it, so each cache row is read once and never copied.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas
// (_decode_kernel), which walks one (batch, kv head) cell's cache in BK
// chunks with an online-softmax carry, the G query heads of the group as
// one (G, D) tile.
//
// What bounds it on an H100: the bytes of K and V up to each row's pos,
// read once: 2 (pos + 1) D sizeof(T) per (batch, kv head).  At G <= 12
// query rows a kv head the FMAs (4 G D a key) stay under that, so the
// tensor cores are not needed.  At the serving engine's 8 slots the bytes
// are kilobytes to a few megabytes, so launch latency and the card's fill
// bound it; at SHAPES["decode_32k"] (B = 128, S = 32,768) about 2.8 GB for
// the seeded positions, 0.83 ms at 3.35 TB/s.  MLA's 576-wide rows with V
// inside them are bytes-bound on paper too (1,152 bytes a key in bf16),
// but at G = 16 a key costs 16 x 1,088 FMAs on the SIMT units: this kernel
// runs them at 1.3% of the byte bound (PERF.md), a first version left for
// a later redesign.
//
// Design:
//  - Grid (B * Hkv, n_split): a block takes one kv head's query group and
//    one split of that row's valid keys.  pos is read on the card, and the
//    splits divide [0, pos] (not the whole cache), so no block reads a key
//    past pos; splits past the end write an empty partial.  The wrapper
//    plans the splits from the blocks the card holds at once
//    (decode_attention_slots): four waves were every cache full, and no
//    split longer than 2,048 keys, so a long row does not walk its cache
//    in one serial loop.  With n_split > 1 a merge kernel folds the
//    partials (m, l, unnormalised acc) per (b, h); with one split the
//    block writes the output itself.
//  - Copies: a producer warp's one thread streams stages of KS keys (128
//    for rows up to 128 bytes, 64 up to 512, else 32) of K and V with
//    cp.async.bulk.tensor (TMA: a 5-D map over (B, S, Hkv, NBOX, D /
//    NBOX), one box of KS rows x D for each; a box is at most 256 elements
//    wide, so MLA's 576-wide rows are 3 boxes of 192 that land row after
//    row) through a ring of up to 64 KB: two stages at
//    D = 64 bf16, one from 64-KB stages up (D >= 192 in bf16), where the
//    other blocks on the SM overlap a block's copies with their compute
//    (more blocks an SM measured faster than a deeper ring:
//    chip_ab_flash.py --decode, PERF.md).  A split takes only the stages
//    it needs, so the engine's short splits leave room for more blocks.
//    Each stage has a full and an empty mbarrier: no block barrier in the
//    loop.  The tiles stay in their own dtype in shared memory and are
//    widened in registers.  Keys past the cache read as zeros (TMA's fill)
//    and are masked.
//  - Four consumer warps split a stage's keys (and, where one warp's
//    output would not fit its registers, the group's heads: up to four
//    heads a warp, so nemotron's G = 12 takes four head groups of three).
//    Each warp keeps its own online-softmax state (m, l, acc) for its heads
//    over its keys, so the warps never wait on each other until the end,
//    where the block merges their states once.
//  - Scores: a key row past 128 bytes (D >= 128 in bf16) splits each
//    (head, key) dot over L = 8 lanes: a lane takes 16-byte slices of the
//    key row (every 8th) and the matching pre-scaled fp32 query, and a
//    3-deep shuffle reduction sums the lanes, so every lane works at G = 1
//    and a warp takes 4 keys at once (without the split, gemma's heads
//    measured 10x slower).  A shorter row is a lane's alone (8 slices, 32
//    keys a warp step, no reduction: the split measured 14% slower at
//    D = 64).  The softmax step runs a lane a key, every head's reductions
//    in flight together; P.V gives each lane D / 32 output dims of every
//    head it holds.
//  - The reference's -1e30 initial max and max(l, 1e-30) guard; masked keys
//    are skipped (exp(-1e30 - m) = 0), and an empty row (pos < 0) gives 0,
//    as the TPU kernel's zero-trip loop does.  expf (no fast math), q
//    pre-scaled by 1/sqrt(D) in fp32; sums run in another order than the
//    plain version's (within a bf16 ulp in bf16, 2e-5 in fp32).
//  - Any (D, DV) of the configs: (32..256, the same), MLA's (576, 512)
//    and its smoke variant's (80, 64), and G up to 16 (four warps of four
//    heads; deepseek's is 16); the wrapper raises beyond.  At 576/512 a
//    lane holds 16 output dims of each of its 4 heads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 128;            // four warps
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kEncodeError = 1000;  // + the CUresult of the encode

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// the largest power of two up to 32 that divides n
__host__ __device__ constexpr int pow2_part(int n) {
  return n % 32 == 0 ? 32 : n % 16 == 0 ? 16 : n % 8 == 0 ? 8 : n % 4 == 0 ? 4
                                                              : n % 2 == 0 ? 2
                                                                           : 1;
}

// The compile-time shape of a (dtype, K head dim D, V head dim DV) kernel.
template <typename T, int D, int DV>
struct Shape {
  static constexpr int ES = sizeof(T);
  static constexpr int EPS = 16 / ES;         // elements of a 16-byte slice
  static constexpr int NSL = D * ES / 16;     // slices of a key row
  static constexpr int RB = D * ES;           // bytes of a key row
  static constexpr int RBV = DV * ES;         // bytes of a value row
  // lanes of a key's dot: a lane a key for rows up to 128 bytes (8 slices
  // a lane, 32 keys a warp step, no reduction), else up to 8 lanes (a warp
  // takes 4 keys at once, a 3-deep reduction)
  static constexpr int L = RB <= 128 ? 1 : pow2_part(NSL) < 8 ? pow2_part(NSL)
                                                                : 8;
  static constexpr int SPL = NSL / L;         // slices of a lane
  static constexpr int KPS = 32 / L;          // keys of a warp step
  // keys of a stage: 128 for rows up to 128 bytes, 64 up to 512, else 32
  static constexpr int KS = RB <= 128 ? 128 : RB <= 512 ? 64 : 32;
  static constexpr int SBK = KS * RB;         // bytes of a stage's K tile
  static constexpr int SBV = KS * RBV;        // and of its V tile
  static constexpr int HMAX = 4;              // heads a warp may hold
  static constexpr int DPL = DV / 32;         // output dims of a lane
  // a TMA box is at most 256 elements a dimension: a K row wider than that
  // (MLA's 576) is NBOX boxes of BOXW columns, one more map dimension
  static constexpr int NBOX = D <= 256 ? 1 : D % 3 == 0 && D / 3 <= 256 ? 3
                                                                        : 4;
  static constexpr int BOXW = D / NBOX;
  static constexpr int NBOXV = DV <= 256 ? 1 : 2;
  static_assert(D % NBOX == 0 && BOXW <= 256 && BOXW * ES % 16 == 0,
                "K rows in whole 16-byte boxes");
  static_assert(DV % NBOXV == 0 && DV / NBOXV <= 256 && DV % 32 == 0,
                "V rows in whole boxes and lanes");
};

// bytes of a ring stage: the K tile, and the V tile unless V is read from
// the K rows (a column-prefix view of them)
template <typename T, int D, int DV>
__host__ __device__ inline int stage_bytes(int v_in_k) {
  using S = Shape<T, D, DV>;
  return S::SBK + (v_in_k ? 0 : S::SBV);
}

// Head groups of the four warps for G heads: the fewest (1, 2 or 4) whose
// share of heads fits a warp (hmax), 0 when none does.
__host__ __device__ inline int head_groups(int g, int hmax) {
  return g <= hmax ? 1 : g <= 2 * hmax ? 2 : g <= 4 * hmax ? 4 : 0;
}

// bytes of the ring area for ns stages: the stages, and at least the
// end-of-block merge's [4][heads a warp][DV + 2] floats, which reuse it
template <typename T, int D, int DV>
__host__ __device__ inline int ring_bytes(int g, int ns, int v_in_k) {
  const int wg = head_groups(g, Shape<T, D, DV>::HMAX);
  const int hw = (g + wg - 1) / wg;
  const int ring = ns * stage_bytes<T, D, DV>(v_in_k);
  const int merge = (4 * hw * (DV + 2) * 4 + 127) / 128 * 128;
  return ring > merge ? ring : merge;
}

// bytes of dynamic shared memory for ns ring stages: 128 of slack to align
// the ring, the ring area, the mbarriers, the pre-scaled queries, each
// warp's scores (its heads x its keys of a stage)
template <typename T, int D, int DV>
__host__ __device__ inline int smem_bytes(int g, int ns, int v_in_k) {
  using S = Shape<T, D, DV>;
  const int wg = head_groups(g, S::HMAX), hw = (g + wg - 1) / wg;
  const int kw = S::KS * wg / 4;
  return 128 + ring_bytes<T, D, DV>(g, ns, v_in_k) + 16 * ns + 4 * g * D +
         4 * 4 * hw * kw;
}

// the ring stages of a launch: what a split needs, at most 64 KB of them
// (2 at D = 64 bf16, 1 from 64-KB stages up; more blocks an SM measured
// faster than a deeper ring) and at most 4
template <typename T, int D, int DV>
__host__ __device__ inline int ring_stages(int stages, int v_in_k) {
  const int sb = stage_bytes<T, D, DV>(v_in_k);
  const int most = 65536 / sb < 1 ? 1 : 65536 / sb > 4 ? 4 : 65536 / sb;
  return stages < 1 ? 1 : stages > most ? most : stages;
}

// N values of a row at p (aligned to the largest word that divides N
// elements), widened to fp32
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  constexpr int B = N * (int)sizeof(T);
  constexpr int W = B % 16 == 0 ? 16 : B % 8 == 0 ? 8 : B % 4 == 0 ? 4 : 2;
  using Word = typename std::conditional<
      W == 16, uint4,
      typename std::conditional<
          W == 8, uint2,
          typename std::conditional<W == 4, uint32_t, uint16_t>::type>::type>::
      type;
  constexpr int E = W / (int)sizeof(T);
#pragma unroll
  for (int w = 0; w < B / W; ++w) {
    const Word x = reinterpret_cast<const Word*>(p)[w];
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < E; ++i) out[w * E + i] = to_f32(e[i]);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
    decode_ring_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const T* __restrict__ q, const int* __restrict__ pos,
                       int s_max, int hkv, int g, int n_split, int ns,
                       int v_in_k, float scale, T* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml) {
  using S = Shape<T, D, DV>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint8_t* ring = base;  // ns stages
  const int sb = stage_bytes<T, D, DV>(v_in_k);
  const int rb = ring_bytes<T, D, DV>(g, ns, v_in_k);
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring + rb));
  float* qs = reinterpret_cast<float*>(ring + rb + 16 * ns);
  const int wg = head_groups(g, S::HMAX), hw_n = (g + wg - 1) / wg;
  const int wk = 4 / wg, kw_n = S::KS / wk;  // key groups, keys a warp
  float* sc_all = qs + g * D;
  // V rows: the K rows' first DV columns, or a tile of their own
  const int vrow = v_in_k ? D : DV;

  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / hkv, kh = bk % hkv, h = hkv * g;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // this split's keys: an even share of [0, n_keys), in whole stages
  const int n_keys = min(max(pos[b] + 1, 0), s_max);
  const int per = ((n_keys + n_split - 1) / n_split + S::KS - 1) / S::KS *
                  S::KS;
  const int lo = split * per, hi = min(lo + per, n_keys);
  const int n_st = hi > lo ? (hi - lo + S::KS - 1) / S::KS : 0;

  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(bars + 8 * i, 1);                     // full
      mbar_init(bars + 8 * (ns + i), kConsumers / 32);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the queries, four loads in flight a thread before any store
  const T* qrow = q + ((size_t)b * h + (size_t)kh * g) * D;
  for (int i0 = tid; i0 < g * D; i0 += 4 * kThreads) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      x[u] = i < g * D ? to_f32(qrow[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < g * D) qs[i] = x[u] * scale;
    }
  }
  __syncthreads();

  if (warp == 4) {  // the producer: one thread issues every copy
    if (lane == 0)
      for (int s = 0; s < n_st; ++s) {
        const int st = s % ns;
        if (s >= ns) mbar_wait(bars + 8 * (ns + st), (s / ns - 1) & 1);
        const uint32_t dst =
            static_cast<uint32_t>(__cvta_generic_to_shared(ring + st * sb));
        mbar_expect_tx(bars + 8 * st, sb);
        tma_load_5d(dst, &kmap, bars + 8 * st, 0, 0, kh, lo + s * S::KS, b);
        if (!v_in_k)
          tma_load_5d(dst + S::SBK, &vmap, bars + 8 * st, 0, 0, kh,
                      lo + s * S::KS, b);
      }
    return;
  }

  // warp = kgrp * wg + hgrp: keys [kgrp kw_n, +kw_n) of each stage, heads
  // [hgrp hw_n, +hn) of the group
  const int hgrp = warp % wg, kgrp = warp / wg;
  const int h0 = hgrp * hw_n, hn = min(hw_n, g - h0);
  float* sc = sc_all + warp * hw_n * kw_n;  // [hw_n][kw_n] scores, weights
  const int grp = lane / S::L, pl = lane % S::L;
  auto slice = [&](int t) {
    return S::L == 1 ? (t + lane) % S::SPL : pl + S::L * t;
  };
  float m[S::HMAX], l[S::HMAX], acc[S::HMAX * S::DPL];
#pragma unroll
  for (int i = 0; i < S::HMAX; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < S::HMAX * S::DPL; ++i) acc[i] = 0.f;

  for (int s = 0; s < n_st; ++s) {
    const int st = s % ns;
    mbar_wait(bars + 8 * st, (s / ns) & 1);
    const T* ks = reinterpret_cast<const T*>(ring + st * sb);
    const T* vs = v_in_k ? ks : ks + S::KS * D;
    const int k0 = kgrp * kw_n;  // this warp's first key in the stage
    const int nk = max(0, min(kw_n, hi - (lo + s * S::KS + k0)));
    // scores: lanes grp * L .. + L take key k0 + j, each its slices
#pragma unroll 2
    for (int j0 = 0; j0 < nk; j0 += S::KPS) {
      const int j = j0 + grp;
      const T* krow = ks + (size_t)(k0 + min(j, kw_n - 1)) * D;
      // slice t of this lane: pl + L t; a lane alone on its row starts
      // at slice lane % SPL, so that neighbouring lanes' rows, 128 bytes
      // apart, fall on other banks (the order of a B9 sum is free).  One
      // slice at a time, widened, into every head's dot
      float dot[S::HMAX];
#pragma unroll
      for (int i = 0; i < S::HMAX; ++i) dot[i] = 0.f;
#pragma unroll
      for (int t = 0; t < S::SPL; ++t) {
        float x[S::EPS];
        load_row<T, S::EPS>(krow + slice(t) * S::EPS, x);
#pragma unroll
        for (int i = 0; i < S::HMAX; ++i) {
          if (i >= hn) continue;
          const float* qv = qs + (h0 + i) * D + slice(t) * S::EPS;
#pragma unroll
          for (int e = 0; e < S::EPS; e += 4) {
            const float4 y = *reinterpret_cast<const float4*>(qv + e);
            dot[i] = fmaf(y.x, x[e], dot[i]);
            dot[i] = fmaf(y.y, x[e + 1], dot[i]);
            dot[i] = fmaf(y.z, x[e + 2], dot[i]);
            dot[i] = fmaf(y.w, x[e + 3], dot[i]);
          }
        }
      }
      // the L lanes' sums, every head's reduction in flight together
#pragma unroll
      for (int o = S::L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < S::HMAX; ++i)
          dot[i] += __shfl_xor_sync(kAll, dot[i], o);
      if (pl == 0 && j < nk) {
#pragma unroll
        for (int i = 0; i < S::HMAX; ++i)
          if (i < hn) sc[i * kw_n + j] = dot[i];
      }
    }
    __syncwarp();
    // online softmax, a lane a key, every head's reductions together
    float mx[S::HMAX], sum[S::HMAX];
#pragma unroll
    for (int i = 0; i < S::HMAX; ++i) {
      mx[i] = kNeg;
      sum[i] = 0.f;
    }
    for (int j = lane; j < nk; j += 32)
#pragma unroll
      for (int i = 0; i < S::HMAX; ++i)
        if (i < hn) mx[i] = fmaxf(mx[i], sc[i * kw_n + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < S::HMAX; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kAll, mx[i], o));
#pragma unroll
    for (int i = 0; i < S::HMAX; ++i) mx[i] = fmaxf(m[i], mx[i]);  // m_new
    for (int j = lane; j < nk; j += 32)
#pragma unroll
      for (int i = 0; i < S::HMAX; ++i)
        if (i < hn) {
          const float p = expf(sc[i * kw_n + j] - mx[i]);
          sc[i * kw_n + j] = p;
          sum[i] += p;
        }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < S::HMAX; ++i)
        sum[i] += __shfl_xor_sync(kAll, sum[i], o);
#pragma unroll
    for (int i = 0; i < S::HMAX; ++i) {
      const float alpha = expf(m[i] - mx[i]);
      l[i] = alpha * l[i] + sum[i];
      m[i] = mx[i];
#pragma unroll
      for (int e = 0; e < S::DPL; ++e) acc[i * S::DPL + e] *= alpha;
    }
    __syncwarp();
    // P.V: this lane's DV / 32 dims of every head it holds
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vf[S::DPL];
      load_row<T, S::DPL>(vs + (size_t)(k0 + j) * vrow + lane * S::DPL, vf);
#pragma unroll
      for (int i = 0; i < S::HMAX; ++i) {
        if (i >= hn) continue;
        const float p = sc[i * kw_n + j];
#pragma unroll
        for (int e = 0; e < S::DPL; ++e)
          acc[i * S::DPL + e] = fmaf(p, vf[e], acc[i * S::DPL + e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (ns + st));
  }

  // the block's warps hold (m, l, acc) over their keys: merge them once
  // through the ring, when every warp is done with it
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  float* comb = reinterpret_cast<float*>(ring);      // [4][hw_n][DV]
  float* comb_ml = comb + 4 * hw_n * DV;             // [4][hw_n][2]
#pragma unroll
  for (int i = 0; i < S::HMAX; ++i) {
    if (i >= hw_n) continue;
#pragma unroll
    for (int e = 0; e < S::DPL; ++e)
      comb[(warp * hw_n + i) * DV + lane * S::DPL + e] = acc[i * S::DPL + e];
    if (lane == 0) {
      comb_ml[(warp * hw_n + i) * 2] = m[i];
      comb_ml[(warp * hw_n + i) * 2 + 1] = l[i];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  for (int f = tid; f < g * DV; f += kConsumers) {
    const int hh = f / DV, d = f % DV;
    const int hg = hh / hw_n, i = hh % hw_n;
    float mm = kNeg;
    for (int kg = 0; kg < wk; ++kg)
      mm = fmaxf(mm, comb_ml[((kg * wg + hg) * hw_n + i) * 2]);
    float num = 0.f, den = 0.f;
    for (int kg = 0; kg < wk; ++kg) {
      const int w = kg * wg + hg;
      const float a = expf(comb_ml[(w * hw_n + i) * 2] - mm);
      num = fmaf(comb[(w * hw_n + i) * DV + d], a, num);
      den = fmaf(comb_ml[(w * hw_n + i) * 2 + 1], a, den);
    }
    if (n_split == 1) {
      store(out + ((size_t)b * h + (size_t)kh * g + hh) * DV + d,
            num / fmaxf(den, 1e-30f));
    } else {
      const size_t row =
          ((size_t)b * h + (size_t)kh * g + hh) * n_split + split;
      part_acc[row * DV + d] = num;
      if (d == 0) {
        part_ml[row * 2] = mm;
        part_ml[row * 2 + 1] = den;
      }
    }
  }
}

// Folds the n_split partials of one (b, h) row: D threads, one per dim.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    int n_split, int d_head,
                                    T* __restrict__ out) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float m = kNeg;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - m);  // 0 for an empty split
    num = fmaf(part_acc[(row * n_split + s) * d_head + d], w, num);
    den = fmaf(ml[2 * s + 1], w, den);
  }
  store(out + row * d_head + d, num / fmaxf(den, 1e-30f));
}

// a (B, S, Hkv, width) cache as a 5-D map (width / nbox, nbox, Hkv, S, B)
// over rows row_elems apart, read in boxes of KS keys of one kv head,
// each row nbox boxes of width / nbox columns (a box is at most 256
// elements wide); keys past S read as zeros
template <typename T>
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int b, int s_max, int hkv, int width, int nbox,
                  int row_elems, int ks) {
  const cuuint64_t es = sizeof(T), bw = width / nbox;
  const cuuint64_t dims[5] = {bw, (cuuint64_t)nbox, (cuuint64_t)hkv,
                              (cuuint64_t)s_max, (cuuint64_t)b};
  const cuuint64_t row = (cuuint64_t)row_elems * es;
  const cuuint64_t strides[4] = {bw * es, row, (cuuint64_t)hkv * row,
                                 (cuuint64_t)s_max * hkv * row};
  const cuuint32_t box[5] = {(cuuint32_t)bw, (cuuint32_t)nbox, 1,
                             (cuuint32_t)ks, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                5, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* part_acc, float* part_ml, int b, int s_max,
           int hkv, int g, int v_in_k, int n_split, int stages, float scale,
           cudaStream_t stream) {
  using S = Shape<T, D, DV>;
  if (head_groups(g, S::HMAX) == 0) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap km, vm;
  CUresult r = make_map<T>(encode, &km, k, b, s_max, hkv, D, S::NBOX, D,
                           S::KS);
  // V a view of K: no map of its own (the kernel reads the K tile)
  if (r == CUDA_SUCCESS)
    r = make_map<T>(encode, &vm, v_in_k ? k : v, b, s_max, hkv,
                    v_in_k ? D : DV, v_in_k ? S::NBOX : S::NBOXV,
                    v_in_k ? D : DV, S::KS);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const int ns = ring_stages<T, D, DV>(stages, v_in_k);
  const int smem = smem_bytes<T, D, DV>(g, ns, v_in_k);
  cudaError_t err = cudaFuncSetAttribute(
      decode_ring_kernel<T, D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_ring_kernel<T, D, DV>
      <<<dim3(b * hkv, n_split), kThreads, smem, stream>>>(
          km, vm, (const T*)q, pos, s_max, hkv, g, n_split, ns, v_in_k,
          scale, (T*)out, part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_merge_kernel<T><<<b * hkv * g, DV, 0, stream>>>(
      part_acc, part_ml, n_split, DV, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int resident(int g, int v_in_k, int stages, int* blocks) {
  const int smem =
      smem_bytes<T, D, DV>(g, ring_stages<T, D, DV>(stages, v_in_k), v_in_k);
  cudaError_t err = cudaFuncSetAttribute(
      decode_ring_kernel<T, D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, decode_ring_kernel<T, D, DV>, kThreads, smem);
  return (int)err;
}

}  // namespace

// every (D, DV) the kernel is built for
#define DECODE_SHAPES(X) \
  X(32, 32) X(64, 64) X(128, 128) X(192, 192) X(256, 256) X(576, 512) X(80, 64)

extern "C" {

// The blocks of a launch at (g, d, dv, V in K, dtype, stages a split) the
// card holds at once (blocks an SM, shared memory bounds it, times the
// SMs), in *slots; -1 there when the kernel does not take this G at these
// head dims.
int decode_attention_slots(int g, int d, int dv, int v_in_k, int is_bf16,
                           int stages, int device, int* slots) {
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int r = (int)cudaErrorInvalidValue;
#define SLOTS_CASE(D, DV)                                                   \
  if (d == D && dv == DV) {                                                 \
    if (head_groups(g, Shape<float, D, DV>::HMAX) == 0) {                   \
      *slots = -1;                                                          \
      return 0;                                                             \
    }                                                                       \
    r = is_bf16 ? resident<__nv_bfloat16, D, DV>(g, v_in_k, stages,         \
                                                 &per_sm)                   \
                : resident<float, D, DV>(g, v_in_k, stages, &per_sm);       \
  }
  DECODE_SHAPES(SLOTS_CASE)
#undef SLOTS_CASE
  *slots = sms * per_sm;
  return r;
}

// q (B, Hkv*G, D), k (B, S, Hkv, D), out (B, Hkv*G, DV), all contiguous;
// v (B, S, Hkv, DV) contiguous, or (v_in_k) the first DV columns of k's
// rows, which the kernel then reads from the K tiles; k and v 16-byte
// aligned; pos (B,) int32 on the card.  is_bf16: T = bf16, else fp32;
// (D, DV) one of DECODE_SHAPES, G up to decode_attention_slots' reach;
// scale multiplies the scores.  stages: the ring stages a split needs
// (the ring takes at most 64 KB of them).  part_acc (B*H*n_split*DV) and
// part_ml (B*H*n_split*2) fp32 scratch when n_split > 1.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* pos, void* out, float* part_acc,
                            float* part_ml, int b, int s_max, int hkv, int g,
                            int d, int dv, int v_in_k, int n_split,
                            int stages, int is_bf16, float scale, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || hkv <= 0 || g <= 0 || n_split <= 0 || s_max <= 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
#define DECODE_CASE(D, DV)                                                  \
  if (d == D && dv == DV)                                                   \
    return is_bf16                                                          \
               ? launch<__nv_bfloat16, D, DV>(q, k, v, pos, out, part_acc,  \
                                              part_ml, b, s_max, hkv, g,    \
                                              v_in_k, n_split, stages,      \
                                              scale, stream)                \
               : launch<float, D, DV>(q, k, v, pos, out, part_acc, part_ml, \
                                      b, s_max, hkv, g, v_in_k, n_split,    \
                                      stages, scale, stream);
  DECODE_SHAPES(DECODE_CASE)
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
