// One-token GQA decode attention over a KV cache:
//   out[b, h] = softmax_j(q[b, h] . k[b, j, h/G] / sqrt(D)) . v[b, j, h/G]
// over the keys j in [0, pos[b]] (clamped to the cache), fp32 arithmetic,
// the output in the input dtype (bf16 or fp32).
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas
// (_decode_kernel), which walks one (batch, kv head) cell's cache in BK
// chunks with an online-softmax carry, the G query heads of the group as
// one (G, D) tile.
//
// What bounds it on an H100: the bytes of K and V up to each row's pos,
// read once: 2 * (pos + 1) * D * sizeof(T) per (batch, kv head).  At the
// serving engine's 8 slots that is kilobytes to a few megabytes, so launch
// latency and the card's fill bound it; at SHAPES["decode_32k"] (B = 128,
// S = 32,768) about 5 GB, 1.6 ms at 3.35 TB/s.
//
// Design (simple and right first):
//  - Grid (B * Hkv, n_split): a block takes one kv head's query group and
//    one split of that row's valid keys.  pos is read on the card, and the
//    splits divide [0, pos] (not the whole cache), so no block reads a key
//    past pos and the work per block stays even whatever pos is; splits
//    past the end write an empty partial.  With n_split > 1 a merge kernel
//    folds the partials (m, l, unnormalised acc) per (b, h); with one split
//    the block writes the output itself.
//  - Keys go through shared memory in tiles of 32 (coalesced loads of each
//    key's D contiguous values from the (B, S, Hkv, D) cache, no repeat of
//    K/V); every loaded key and value is shared by the G query heads.
//  - Per tile: the G x 32 scores (q pre-scaled by 1/sqrt(D) as the TPU
//    kernel does, fp32 fmaf over D), then one warp per head does the online
//    softmax update (m, l, alpha) with shuffles, then each (head, dim) output
//    is owned by one thread that rescales by alpha and adds p . v.
//  - The reference's -1e30 initial max and max(l, 1e-30) guard; masked keys
//    are skipped (they would contribute exp(-1e30 - m) = 0).  An empty row
//    (pos < 0) gives 0, as the TPU kernel's zero-trip loop does.
//  - expf (no fast math), so the weights stay close to XLA's exp.
//  - Any D of the configs: 32, 64, 128, 192, 256.  Shared memory
//    (smem_floats) is largest at nemotron-4-340b's G = 12, D = 192:
//    17,348 floats, 68 KB of the 227 KB a block may use; gemma-7b's G = 1,
//    D = 256 needs 16,963.  The merge kernel's D threads (32 to 256) fit a
//    block at every D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile: one per lane in the softmax step
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// shared floats a block needs for G heads at head width D
__host__ __device__ constexpr int smem_floats(int g, int d) {
  return g * d               // q, pre-scaled
         + kTile * (d + 1)   // K tile (rows padded: conflict-free dots)
         + kTile * d         // V tile
         + g * kTile         // scores, then weights
         + 3 * g             // m, l, alpha per head
         + g * d;            // unnormalised output accumulators
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ pos,
                  int s_max, int hkv, int g, int n_split, float scale,
                  T* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + g * D;
  float* vs = ks + kTile * (D + 1);
  float* ps = vs + kTile * D;
  float* m_s = ps + g * kTile;
  float* l_s = m_s + g;
  float* a_s = l_s + g;
  float* acc = a_s + g;

  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / hkv, kh = bk % hkv;
  const int h = hkv * g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this split's keys: an even share of [0, n_keys), in whole tiles
  const int n_keys = min(max(pos[b] + 1, 0), s_max);
  const int per = ((n_keys + n_split - 1) / n_split + kTile - 1) / kTile *
                  kTile;
  const int lo = split * per, hi = min(lo + per, n_keys);

  const T* qrow = q + ((size_t)b * h + (size_t)kh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) {
    qs[i] = to_f32(qrow[i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * D;  // one key to the next
  const size_t base = ((size_t)b * s_max * hkv + kh) * D;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int nt = min(kTile, hi - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < nt * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const size_t at = base + (size_t)(t0 + j) * row_stride + d;
      ks[j * (D + 1) + d] = to_f32(k[at]);
      vs[j * D + d] = to_f32(v[at]);
    }
    __syncthreads();
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, j = i - gi * kTile;
      float s = 0.f;
      if (j < nt) {
        const float* qv = qs + gi * D;
        const float* kv = ks + j * (D + 1);
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qv[d], kv[d], s);
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += kWarps) {
      const bool valid = lane < nt;
      const float s = ps[gi * kTile + lane];
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, warp_max(valid ? s : kNeg));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[gi * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = alpha * l_s[gi] + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * D; i += kThreads) {
      const int gi = i / D, d = i - gi * D;
      const float* p = ps + gi * kTile;
      float a = 0.f;
      for (int j = 0; j < nt; ++j) a = fmaf(p[j], vs[j * D + d], a);
      acc[i] = acc[i] * a_s[gi] + a;
    }
  }
  __syncthreads();

  if (n_split == 1) {
    T* orow = out + ((size_t)b * h + (size_t)kh * g) * D;
    for (int i = tid; i < g * D; i += kThreads)
      store(orow + i, acc[i] / fmaxf(l_s[i / D], 1e-30f));
    return;
  }
  for (int i = tid; i < g * D; i += kThreads) {
    const int gi = i / D, d = i - gi * D;
    const size_t row = ((size_t)b * h + (size_t)kh * g + gi) * n_split + split;
    part_acc[row * D + d] = acc[i];
    if (d == 0) {
      part_ml[row * 2] = m_s[gi];
      part_ml[row * 2 + 1] = l_s[gi];
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
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - m);  // 0 for an empty split
    num = fmaf(part_acc[(row * n_split + s) * d_head + d], w, num);
    den = fmaf(ml[2 * s + 1], w, den);
  }
  store(out + row * d_head + d, num / fmaxf(den, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* part_acc, float* part_ml, int b, int s_max,
           int hkv, int g, int n_split, float scale, cudaStream_t stream) {
  const int smem = smem_floats(g, D) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_kernel<T, D><<<dim3(b * hkv, n_split), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pos, s_max, hkv, g, n_split,
      scale, (T*)out, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_merge_kernel<T><<<b * hkv * g, D, 0, stream>>>(
      part_acc, part_ml, n_split, D, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hkv*G, D), k/v (B, S, Hkv, D), out (B, Hkv*G, D), all contiguous;
// pos (B,) int32 on the card.  is_bf16: T = bf16, else fp32; D in {32, 64,
// 128, 192, 256}.  part_acc (B*H*n_split*D) and part_ml (B*H*n_split*2)
// fp32 scratch when n_split > 1.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* pos, void* out, float* part_acc,
                            float* part_ml, int b, int s_max, int hkv, int g,
                            int d, int n_split, int is_bf16, float scale,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || hkv <= 0 || g <= 0 || n_split <= 0 || s_max <= 0)
    return (int)cudaErrorInvalidValue;
  if (smem_floats(g, d) * (int)sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
#define DECODE_CASE(D)                                                      \
  case D:                                                                   \
    return is_bf16 ? launch<__nv_bfloat16, D>(q, k, v, pos, out, part_acc,  \
                                              part_ml, b, s_max, hkv, g,    \
                                              n_split, scale, stream)       \
                   : launch<float, D>(q, k, v, pos, out, part_acc, part_ml, \
                                      b, s_max, hkv, g, n_split, scale,     \
                                      stream);
  switch (d) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(192)
    DECODE_CASE(256)
  }
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
