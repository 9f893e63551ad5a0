// Causal GQA prefill attention with an online softmax:
//   o[b, h, i] = softmax_{j <= i}(q[b, h, i] . k[b, h/G, j] / sqrt(D))
//                . v[b, h/G, j]
// fp32 arithmetic, the output in the input dtype (bf16 or fp32).
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel): grid (batch, heads, query blocks), the query tile
// resident while K/V stream in chunks, the causal bound stopping the chunk
// loop at the diagonal, kv head h // G with no K/V repeat.
//
// What bounds it on an H100: the operations.  The causal products take
// about 2 * B * H * D * S * (S + 1) FLOP (QK^T and PV over the lower
// triangle): 32 GFLOP at B = 1, H = 15, S = 4,096, D = 64, 0.033 ms on the
// bf16 tensor cores (989 TFLOP/s) against 4 MB of Q, K, V and O (1.2 us
// at 3.35 TB/s).  This first kernel runs on the fp32 SIMT units (67 TFLOP/s
// peak) and reads its operands from shared memory, so it sits well below
// either bound; wgmma with bf16 operands and fp32 accumulators is the
// later work.
//
// Design (simple and right first):
//  - Grid (ceil(S / 64), H, B), 256 threads.  Block x takes query tile
//    n_tiles - 1 - x, so the longest causal rows start first.
//  - The 64-row query tile (pre-scaled by 1/sqrt(D), as the TPU kernel
//    does) stays in shared memory; 64-key K and V tiles stream through it
//    up to the tile that holds the block's last row (the causal bound).
//  - Thread (ty, tx) of a 16 x 16 layout owns rows 4ty..4ty+3 and key
//    columns tx + 16c of the score tile and output dims tx + 16c of the
//    accumulators, which stay in registers; the row max and sum reduce
//    over the 16 lanes of a half-warp with shuffles.  K rows are padded to
//    D + 1 floats so the 16 columns a half-warp reads fall in 16 banks.
//  - Masks col > row and col >= S with -1e30 (the reference's NEG), so
//    the ragged tail of S needs no padding: rows past S are not stored
//    and keys past S load as zeros and are masked.  Every row meets key 0
//    in its first tile, so its running max is finite from then on and a
//    masked score adds exp(-1e30 - m) = 0.
//  - The output divides by max(l, 1e-30), as the TPU kernel does; expf, no
//    fast math.
//  - Strides in elements for the batch, head and sequence axes of q, k, v
//    and o (the head dim contiguous), so the model's (B, S, H, D)
//    projections go in and come out without a transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int smem_floats(int d) {
  return BQ * (d + 1)    // Q tile (padded)
         + BK * (d + 1)  // K tile (padded)
         + BK * d        // V tile
         + BQ * BK;      // weights
}

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s, int g,
                 Strides qs_, Strides ks_, Strides vs_, Strides os_,
                 float scale) {
  constexpr int QP = D + 1, KP = D + 1, NC = D / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + BQ * QP;
  float* vs = ks + BK * KP;
  float* ps = vs + BK * D;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z, kh = hh / g;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * qs_.b + hh * qs_.h;
  const T* kb = k + b * ks_.b + kh * ks_.h;
  const T* vb = v + b * vs_.b + kh * vs_.h;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D, row = q0 + r;
    qs[r * QP + d] = row < s ? to_f32(qb[row * qs_.s + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int q_hi = min(q0 + BQ, s);       // rows [q0, q_hi)
  const int n_kt = (q_hi + BK - 1) / BK;  // causal bound: keys < q_hi
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is loaded; the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D, d = i - j * D, key = k0 + j;
      const bool in = key < s;
      ks[j * KP + d] = in ? to_f32(kb[key * ks_.s + d]) : 0.f;
      vs[j * D + d] = in ? to_f32(vb[key * vs_.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty * 4 + r) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * KP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        if (col > row || col >= s) sc[r][c] = kNeg;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off, 16));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[r][c] - m_new);
        ps[(ty * 4 + r) * BK + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(~0u, sum, off, 16);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty * 4 + r) * BK + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  T* ob = o + b * os_.b + hh * os_.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(ob + row * os_.s + tx + 16 * c, acc[r][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int s, const long long* st, float scale,
           cudaStream_t stream) {
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s, h / hkv, qs, ks, vs,
      os, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, S, D), k/v (B, Hkv, S, D), o (B, H, S, D), each given by its
// batch, head and sequence strides in elements (12 values: q, k, v, o),
// the head dim contiguous.  is_bf16: T = bf16, else fp32; D in {64, 128};
// H a multiple of Hkv.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int h, int hkv, int s, int d,
                           const long long* strides, int is_bf16,
                           float scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || hkv <= 0 || h % hkv != 0 || b > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, b, h, hkv, s,
                                               strides, scale, stream)
                   : launch<float, 64>(q, k, v, o, b, h, hkv, s, strides,
                                       scale, stream);
  if (d == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, b, h, hkv, s,
                                                strides, scale, stream)
                   : launch<float, 128>(q, k, v, o, b, h, hkv, s, strides,
                                        scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
