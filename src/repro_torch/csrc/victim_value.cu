// Occupancy-masked RAC Eq. 1 over the slot table with a runtime clock:
//   value[i] = 2^(-alpha * (t_now - t_last[tid_i])) * tp_last[tid_i] * tsi[i]
// with free slots (occ <= 0) scoring +inf and tid clamped to [0, T - 1]
// (free slots carry -1).
//
// Replaces: repro/kernels/decision.py::victim_value_pallas
// (_victim_value_kernel), the victim leg of the fused decision pass, and
// ::victim_value_multi_pallas, which walks P policies' slot tables with
// lax.map over it inside one dispatch.
//
// What bounds it on an H100: about 16 bytes a slot (tsi, tid, occ in,
// value out) plus two gathers from topic tables that stay in L2: at
// N = 65,537 about 1 MB, 0.3 us at 3.35 TB/s; at P = 15, N = 6,852,
// T = 4,096 about 2.1 MB.  In practice latency and the launch bound it.
//
// Design: the body in eq1_value.cuh (one wave of blocks, V slots a thread
// from 16-byte loads, topic tables gathered or staged, programmatic
// dependent launch).  The age is taken in int32 before the f32 cast (clocks
// past 2^24 keep their precision; wrapping subtraction like XLA's int32).
// The policy-stacked entry is the same kernel with the policy as grid.y:
// policy p's slot tables start at p * N, its topic tables at p * T; t_now
// and alpha are shared (one simulated clock).
#include "eq1_value.cuh"

extern "C" {

// One launch of the masked Eq. 1 over a->n_pol stacked tables (1 for a
// single table), arguments packed as Eq1Args (kind kVictim).
int victim_value_launch(const Eq1Args* a) { return eq1_run<kVictim>(a); }

// The blocks a launch with a's V, staging and topic count the card holds
// at once, in *slots (the wrapper plans one wave).
int victim_value_slots(const Eq1Args* a, int* slots) {
  return eq1_slots<kVictim>(a, slots);
}

}  // extern "C"
