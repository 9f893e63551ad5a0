// RAC Eq. 1 over a resident or block table, optionally masked:
//   value[i] = 2^(-alpha * (t_now - t_last[tid_i])) * tp_last[tid_i] * tsi[i]
// with tid clamped to [0, T - 1] and, given a validity mask, +inf where it
// is false (rac_value_masked: one launch, no select pass after it).
//
// Replaces: repro/kernels/rac_value.py::rac_value_pallas
// (_rac_value_kernel), the per-eviction scorer behind RACPolicy.victim,
// and the jnp.where that repro/kernels/ops.py::rac_value_masked fuses
// with it.
//
// What bounds it on an H100: about 12 bytes an entry (tsi, tid in, value
// out; one more with a mask) plus gathers from topic tables that stay in
// L2, well under a microsecond at 3.35 TB/s for the 65,537-entry table;
// latency and the launch bound it in practice.
//
// Design: the body in eq1_value.cuh.  Unlike victim_value, the TPU kernel
// casts t_last to f32 *before* subtracting (t_now arrives as an f32
// scalar), and that order is kept: t_last comes as f32 (kRacF32) or as
// int32 that the kernel casts (kRacI32: the backend's shifted table, with
// no cast launch of its own).  The backend shifts timestamps so t_now = 0,
// where the int and f32 orders agree for ages below 2^24.
#include "eq1_value.cuh"

extern "C" {

// One launch of Eq. 1 (kind kRacF32 or kRacI32 in a->kind), arguments
// packed as Eq1Args; a->mask null or a bool (N,) validity mask.
int rac_value_launch(const Eq1Args* a) {
  return a->kind == kRacI32 ? eq1_run<kRacI32>(a) : eq1_run<kRacF32>(a);
}

int rac_value_slots(const Eq1Args* a, int* slots) {
  return a->kind == kRacI32 ? eq1_slots<kRacI32>(a, slots)
                            : eq1_slots<kRacF32>(a, slots);
}

// The launch floor of a's launch: an empty kernel with the same grid,
// shared memory and attributes, and the same dependency prologue (timing
// only; counted nowhere).
int eq1_value_floor(const Eq1Args* a) {
  cudaError_t err = eq1_device(a->device);
  if (err == cudaSuccess && a->staged) err = eq1_smem_ceiling(eq1_floor_kernel);
  return err != cudaSuccess ? (int)err : eq1_launch(eq1_floor_kernel, *a);
}

}  // extern "C"
