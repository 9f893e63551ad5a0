// Occupancy-masked RAC Eq. 1 over the slot table with a runtime clock:
//   value[i] = 2^(-alpha * (t_now - t_last[tid_i])) * tp_last[tid_i] * tsi[i]
// with free slots (occ == 0) scoring +inf and tid -1 clamped to 0.
//
// Replaces: repro/kernels/decision.py::victim_value_pallas
// (_victim_value_kernel), the victim leg of the fused decision pass.
//
// What bounds it on an H100: it moves about 16 bytes per slot (tsi, tid,
// occ in, value out) plus two gathers from topic tables that stay in L1/L2;
// at N = 65,537 that is about 1 MB, well under a microsecond at 3.35 TB/s,
// so in practice the launch itself bounds it.
//
// Design: one thread per slot, plain coalesced loads, the topic tables read
// through the read-only cache.  The arithmetic keeps the TPU kernel's
// order: the age is taken in int32 before the f32 cast (so clocks past
// 2^24 do not lose precision; wrapping subtraction like XLA's int32), then
// exp2f (no fast-math, to stay close to XLA's exp2), then (decay*tp)*tsi.
// t_now is a plain kernel argument: the scalar-prefetch operand has no
// counterpart to port.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void victim_value_kernel(const float* __restrict__ tsi,
                                    const int* __restrict__ tid,
                                    const int* __restrict__ occ,
                                    const float* __restrict__ tp_last,
                                    const int* __restrict__ t_last, int n,
                                    int n_topics, int t_now, float neg_alpha,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = min(max(tid[i], 0), n_topics - 1);
  const int age = (int)((unsigned)t_now - (unsigned)__ldg(t_last + t));
  const float decay = exp2f(neg_alpha * (float)age);
  const float val = decay * __ldg(tp_last + t) * tsi[i];
  out[i] = occ[i] > 0 ? val : CUDART_INF_F;
}

}  // namespace

extern "C" int victim_value_launch(const float* tsi, const int* tid,
                                   const int* occ, const float* tp_last,
                                   const int* t_last, int n, int n_topics,
                                   int t_now, float neg_alpha, float* out,
                                   int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  victim_value_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      tsi, tid, occ, tp_last, t_last, n, n_topics, t_now, neg_alpha, out);
  return (int)cudaGetLastError();
}
