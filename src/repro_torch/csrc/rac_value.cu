// Unmasked RAC Eq. 1 over a resident table:
//   value[i] = 2^(-alpha * (t_now - t_last[tid_i])) * tp_last[tid_i] * tsi[i]
//
// Replaces: repro/kernels/rac_value.py::rac_value_pallas
// (_rac_value_kernel), the per-eviction scorer behind RACPolicy.victim.
//
// What bounds it on an H100: about 12 bytes per entry (tsi, tid in, value
// out) plus gathers from topic tables that stay in L1/L2, so well under a
// microsecond at 3.35 TB/s for the 65,537-entry table; the launch bounds it
// in practice.
//
// Design: one thread per entry.  Unlike victim_value, the TPU kernel casts
// t_last to f32 *before* subtracting (the wrapper uploads t_last as f32 and
// t_now arrives as an f32 scalar), and that order is kept.  The backend
// shifts timestamps so t_now = 0, where the int and f32 orders agree for
// ages below 2^24.  exp2f without fast-math, then (decay*tp)*tsi.
#include <cuda_runtime.h>

namespace {

__global__ void rac_value_kernel(const float* __restrict__ tsi,
                                 const int* __restrict__ tid,
                                 const float* __restrict__ tp_last,
                                 const float* __restrict__ t_last, int n,
                                 int n_topics, float t_now, float neg_alpha,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = min(max(tid[i], 0), n_topics - 1);
  const float decay = exp2f(neg_alpha * (t_now - __ldg(t_last + t)));
  out[i] = decay * __ldg(tp_last + t) * tsi[i];
}

}  // namespace

extern "C" int rac_value_launch(const float* tsi, const int* tid,
                                const float* tp_last, const float* t_last,
                                int n, int n_topics, float t_now,
                                float neg_alpha, float* out, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rac_value_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      tsi, tid, tp_last, t_last, n, n_topics, t_now, neg_alpha, out);
  return (int)cudaGetLastError();
}
