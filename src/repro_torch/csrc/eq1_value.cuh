// RAC's Eq. 1 over a table of entries, the one body of victim_value.cu
// (B2, B7) and rac_value.cu (B3):
//   value[i] = 2^(-alpha * age_i) * tp_last[t_i] * tsi[i],
//   t_i = clamp(tid[i], 0, T - 1),
// +inf where the entry's mask says so (B2: occ <= 0; B3: valid false when
// a validity mask is given).  The two kernels differ in the age only: B2
// subtracts in wrapping int32 and then casts (t_now - t_last, clocks past
// 2^24 keep their precision); B3 casts t_last to f32 and then subtracts,
// as the TPU kernel does (its t_last may arrive as int32 and is cast here,
// one rounding as torch's cast would make).  Then exp2f without fast-math,
// then (decay * tp) * tsi: the parent kernels' order, so the bits are
// theirs.
//
// What bounds it on an H100: about 12-16 bytes an entry plus two gathers
// from topic tables that stay in L2, under a microsecond of bytes at
// N = 65,537; a call is latency and launch: a load, a dependent gather, a
// store.  The design shortens that chain and hides the launch:
//  - One wave, kEq1V = 4 entries a thread: the grid is at most the blocks
//    the card holds at once (eq1_slots), capped at ceil(work / threads),
//    where work is the 4-wide chunks plus the scalar entries (value_plan
//    in kernels/decision.py; tests/test_torch_values.py emulates the
//    walk).  Each thread issues its stream loads (tsi, tid, the mask) as
//    16-byte ld.global.nc vectors before any gather, then the gathers,
//    exp2f and a 16-byte store.  The ragged tail, and bases that are not
//    16-byte aligned (slices), take a scalar walk in the same kernel.
//  - Topic tables staged in shared memory by one bulk copy a table
//    (cp.async.bulk onto an mbarrier), issued at block start so its
//    latency overlaps the stream loads, the gathers then reading shared
//    memory, in 256-thread blocks (each block copies both tables: few
//    blocks).  Staging needs T % 4 == 0, 16-byte bases and 8 T bytes
//    within kEq1StageMax; larger tables are gathered through the
//    read-only cache in 64-thread blocks, spread over every SM (an SM's
//    L1 serves a scattered gather a line at a time).  The wrapper
//    chooses; chip_ab_flash.py --values --ablate measured both choices.
//  - Programmatic dependent launch: cudaLaunchKernelEx with programmatic
//    stream serialization, griddepcontrol.wait before the first global
//    read or write, then launch_dependents, so this launch and its block
//    start overlap the previous kernel's tail (B1's in fused_decide, the
//    previous call's in a graph).
//  - The host: one packed argument block (Eq1Args) through one pointer, no
//    cudaSetDevice unless the caller's device differs.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"

// The launch's arguments, packed by the wrapper (struct.Struct in
// kernels/decision.py: the field order and types there must match).  Outside
// the anonymous namespace: the C entries take it, and a type of internal
// linkage in their signatures would hide them from the library's exports.
struct Eq1Args {
  const float* tsi;      // (n_pol, n)
  const int* tid;        // (n_pol, n)
  const void* mask;      // kVictim: occ int (n_pol, n); kRac*: bool or null
  const float* tp_last;  // (n_pol, n_topics)
  const void* t_last;    // kVictim, kRacI32: int; kRacF32: float
  float* out;            // (n_pol, n)
  cudaStream_t stream;
  int n;                 // entries a policy
  int n_topics;          // topics a policy
  int n_pol;             // policies (grid.y)
  int n_vec;             // entries [0, n_vec) in V-wide chunks; 0: scalar
  int t_now;             // kVictim's clock
  int kind;              // Eq1Kind
  int v;                 // entries a chunk: kEq1V (checked)
  int staged;            // topic tables through shared memory
  int blocks;            // grid.x
  int threads;           // block size, at most kEq1Threads
  int device;
  float t_now_f;         // kRac*'s clock
  float neg_alpha;
};
static_assert(sizeof(Eq1Args) == 112, "kernels/decision.py packs 112 bytes");

namespace {

constexpr int kEq1Threads = 256;  // the largest block
constexpr int kEq1V = 4;          // entries a vector chunk (a 16-byte load)
// both topic tables staged: 8 bytes a topic, at most this many in all
constexpr int kEq1StageMax = 192 * 1024;

enum Eq1Kind : int { kVictim = 0, kRacF32 = 1, kRacI32 = 2 };

template <int K>
__device__ __forceinline__ float eq1_entry(const Eq1Args& a, float tp,
                                           uint32_t tl, float tsi, int m) {
  float decay;
  if (K == kVictim) {
    const int age = (int)((unsigned)a.t_now - tl);
    decay = exp2f(a.neg_alpha * (float)age);
  } else {
    const float t_last =
        K == kRacF32 ? __uint_as_float(tl) : (float)(int)tl;
    decay = exp2f(a.neg_alpha * (a.t_now_f - t_last));
  }
  const float val = decay * tp * tsi;
  return m ? val : CUDART_INF_F;
}

template <int V>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p + j));
    x[j] = w.x, x[j + 1] = w.y, x[j + 2] = w.z, x[j + 3] = w.w;
  }
}

template <int V>
__device__ __forceinline__ void ld_vec(const int* p, int (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p + j));
    x[j] = w.x, x[j + 1] = w.y, x[j + 2] = w.z, x[j + 3] = w.w;
  }
}

// the mask of a chunk as 0 / 1: occ > 0 (kVictim), the bool bytes (kRac*,
// one V-byte load), all live without a mask
template <int K, int V>
__device__ __forceinline__ void ld_mask(const void* mask, int c,
                                        int (&m)[V]) {
  if constexpr (K == kVictim) {
    int occ[V];
    ld_vec<V>(static_cast<const int*>(mask) + c * V, occ);
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = occ[j] > 0;
  } else if (mask == nullptr) {
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = 1;
  } else {
    const unsigned char* b = static_cast<const unsigned char*>(mask) + c * V;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(b + j));
#pragma unroll
      for (int e = 0; e < 4; ++e) m[j + e] = (w >> (8 * e)) & 0xFF;
    }
  }
}

template <int K>
__device__ __forceinline__ int ld_mask1(const void* mask, int i) {
  if (K == kVictim) return __ldg(static_cast<const int*>(mask) + i) > 0;
  if (mask == nullptr) return 1;
  return __ldg(static_cast<const unsigned char*>(mask) + i) != 0;
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void pdl_prologue() {
  // nothing global before this: the previous kernel may still be running
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <int K, bool STAGED>
__global__ void __launch_bounds__(kEq1Threads) eq1_kernel(const Eq1Args a) {
  constexpr int V = kEq1V;
  extern __shared__ __align__(16) uint32_t eq1_tables[];
  __shared__ __align__(8) uint64_t eq1_bar;
  const size_t pol = blockIdx.y;
  const size_t row = pol * (size_t)a.n;
  const float* tsi = a.tsi + row;
  const int* tid = a.tid + row;
  const void* mask =
      a.mask == nullptr
          ? nullptr
          : static_cast<const char*>(a.mask) +
                row * (K == kVictim ? sizeof(int) : sizeof(bool));
  float* out = a.out + row;
  const int nt = a.n_topics;
  const float* tp_g = a.tp_last + pol * nt;
  const uint32_t* tl_g = static_cast<const uint32_t*>(a.t_last) + pol * nt;
  const float* tp =
      STAGED ? reinterpret_cast<const float*>(eq1_tables) : tp_g;
  const uint32_t* tl = STAGED ? eq1_tables + nt : tl_g;
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&eq1_bar);
  if (STAGED) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  pdl_prologue();
  if (STAGED && threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)nt * 4u;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(eq1_tables);
    mbar_expect_tx(bar, 2 * bytes);
    bulk_copy(dst, tp_g, bytes, bar);
    bulk_copy(dst + bytes, tl_g, bytes, bar);
  }
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  bool ready = !STAGED;
  for (int c = g; c < a.n_vec / V; c += stride) {
    float s[V];
    int id[V], m[V];
    ld_vec<V>(tsi + c * V, s);
    ld_vec<V>(tid + c * V, id);
    ld_mask<K, V>(mask, c, m);
    if (!ready) mbar_wait(bar, 0), ready = true;
    float p[V];
    uint32_t l[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int t = min(max(id[j], 0), nt - 1);
      p[j] = STAGED ? tp[t] : __ldg(tp + t);
      l[j] = STAGED ? tl[t] : __ldg(tl + t);
    }
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      float4 o;
      o.x = eq1_entry<K>(a, p[j], l[j], s[j], m[j]);
      o.y = eq1_entry<K>(a, p[j + 1], l[j + 1], s[j + 1], m[j + 1]);
      o.z = eq1_entry<K>(a, p[j + 2], l[j + 2], s[j + 2], m[j + 2]);
      o.w = eq1_entry<K>(a, p[j + 3], l[j + 3], s[j + 3], m[j + 3]);
      *reinterpret_cast<float4*>(out + c * V + j) = o;
    }
  }
  for (int i = a.n_vec + g; i < a.n; i += stride) {
    const float s = __ldg(tsi + i);
    const int m = ld_mask1<K>(mask, i);
    const int t = min(max(__ldg(tid + i), 0), nt - 1);
    if (!ready) mbar_wait(bar, 0), ready = true;
    const float p = STAGED ? tp[t] : __ldg(tp + t);
    const uint32_t l = STAGED ? tl[t] : __ldg(tl + t);
    out[i] = eq1_entry<K>(a, p, l, s, m);
  }
  // the block's shared memory must outlive the copy into it
  if (!ready && threadIdx.x == 0) mbar_wait(bar, 0);
}

// the launch floor: the same grid, shared memory and attributes, and the
// same prologue, returning at once
__global__ void __launch_bounds__(kEq1Threads) eq1_floor_kernel(
    const Eq1Args a) {
  pdl_prologue();
}

using Eq1Fn = void (*)(Eq1Args);

// switch to the tensors' device only when the caller's differs
inline cudaError_t eq1_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

inline cudaError_t eq1_smem_ceiling(Eq1Fn fn) {
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kEq1StageMax);
}

// the kernel for a's kind and staging, on a's device; a staged kernel's
// shared-memory ceiling is raised once a device (a bit a device: a repeat
// after a race is harmless).  The wrapper's V must be the kernel's.
template <int K>
cudaError_t eq1_select(const Eq1Args& a, Eq1Fn* fn) {
  static unsigned raised = 0u;
  if (a.v != kEq1V) return cudaErrorInvalidValue;
  *fn = a.staged ? &eq1_kernel<K, true> : &eq1_kernel<K, false>;
  cudaError_t err = eq1_device(a.device);
  const unsigned bit = 1u << (a.device & 31);
  if (err == cudaSuccess && a.staged && !(raised & bit)) {
    err = eq1_smem_ceiling(*fn);
    if (err == cudaSuccess) raised |= bit;
  }
  return err;
}

inline int eq1_launch(Eq1Fn fn, const Eq1Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks, a.n_pol);
  cfg.blockDim = dim3(a.threads);
  cfg.dynamicSmemBytes = a.staged ? 8 * a.n_topics : 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int K>
int eq1_run(const Eq1Args* a) {
  Eq1Fn fn;
  const cudaError_t err = eq1_select<K>(*a, &fn);
  return err != cudaSuccess ? (int)err : eq1_launch(fn, *a);
}

// the blocks of this kind's kernel the card holds at once (blocks an SM
// times the SMs) for V, staging and the topic count in *a
template <int K>
int eq1_slots(const Eq1Args* a, int* slots) {
  Eq1Fn fn;
  cudaError_t err = eq1_select<K>(*a, &fn);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 a->device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, a->threads, a->staged ? 8 * a->n_topics : 0);
  *slots = sms * per_sm;
  return (int)err;
}

}  // namespace
