"""B8 (flash_attention) side by side on one card: each checkout's kernel at
chip_smoke.py's bf16 FLASH_SHAPES (device ms per call, from a CUDA graph of
many calls) and the paper LM's prefill of B=2 x 1,000 tokens (host wall ms
and CUDA-event ms per call), the checkouts timed in turns, each in a process
of its own that builds that checkout's kernels; one more prefill under
torch.profiler gives the card's busy time and B8's part of it.  With
``--top1`` the same for B1 (sim_top1, sim_top1_multi) at chip_smoke.py's
shapes, on seeded unit rows.  With ``--q8`` the same for B5 and B5-multi
(sim_topk_q8, sim_topk_q8_multi) at chip_smoke.py's shapes on seeded,
quantized unit rows, with B4 (sim_topk) at three of its shapes beside them
as a guard, and each checkout's ptxas register and spill counts for the
Top-K kernels.  With ``--topk`` the same for B4 (sim_topk, fp32) at
chip_smoke.py's shapes (the routing matrix at Q in {1, 512}, the slab at
Q = 8 and k in {1, 8, 16, 257}) on seeded unit rows, the routing rows at
the mirror's 16-byte pitch where the checkout takes a row stride, and
whether each checkout's outputs are bit-equal to the first root's; with
``--decode`` the same for B9 (decode_attention) at chip_smoke.py's
DECODE_SHAPES, with each output's max |difference| from the first root's.
With ``--values`` the same for B3, B2 and B7 (rac_value, victim_value,
victim_value_multi) at VALUE_ROWS (the main path's, the arena's and the
serve cache's shapes, B3 also through ops with the backend's int32
table) and for the fused_decide sequence (B1, B1, B2): device ms from a
CUDA graph, eager ms per call with outputs dropped and with outputs held
(the median of five runs), each row's launch floor where the checkout
has one, the host microseconds of each piece of the wrappers' issue path,
whether each output is bit-equal to the first root's, and the ptxas
registers.

    python3 chip_ab_flash.py [--top1 | --q8 | --topk | --decode | --values] ROOT ...
    python3 chip_ab_flash.py [--top1 | --q8 | --topk | --decode | --values] --ablate

ROOT is a directory holding ``src/repro_torch``: to hold a change against
its parent, unpack the parent's package into a directory ``.gitignore``
lists (``git archive <parent> src/repro_torch | tar -x -C build/parent``)
and run ``build/parent . . build/parent``.  ``--ablate`` writes variants of
this checkout's ``csrc/flash_attention.cu`` under ``build/ablate/`` (one
P.V product instead of three; P not split; no turns between the consumer
warpgroups; a multiply in place of ex2; the first, second and fourth
together) and times them in turns with the checkout; with ``--top1``,
of ``csrc/sim_top1.cu`` (three stages and three blocks an SM instead of two
and four; no split of the candidates; no split of the queries; no
wgmma; only the candidates' copies); with ``--q8``, of
``csrc/sim_topk_q8.cu`` (no wgmma; no insertions, the scores still
computed, filtered and stashed; only the copies; no merge pass; four and
eight ring stages instead of six, eight leaving one block an SM; splits
for two waves of blocks and for half a wave instead of one); with
``--topk``, of ``csrc/sim_topk_f32.cu`` and its wrapper (one ring stage;
the replaced kernel's grid at Q = 1, 32 blocks of 128 rows; the K > 32
lists in device memory; no ballot filter, every live column visited; no
fold at all; no split merge);
with ``--decode``, of ``csrc/decode_attention.cu`` and its wrapper (one
ring stage; 32-key stages; the replaced kernel's split plan; no lane
split of the dot, a lane a key; only the copies, no key scored); with
``--values``, of ``csrc/eq1_value.cuh`` and ``kernels/decision.py`` (the
parent's walk, one entry a thread in 256-thread blocks; no vector loads;
V = 8; 256- and 64-thread blocks; no programmatic dependent launch; the
other topic-table design; no work after the prologue).  A variant
computes wrong values (but for the stage counts, the wave sizes, the
grids, the lists' place, the filter and every Eq. 1 variant but the
last): it only says where the kernel's time goes.
Needs a CUDA card; prints one JSON line per run and the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's bf16 FLASH_SHAPES: (B, H, Hkv, S, D), graph reps
SHAPES = [((1, 15, 5, 4096, 64), 20), ((2, 15, 5, 1000, 64), 50),
          ((1, 15, 5, 32768, 64), 3)]
PREFILL_B, PREFILL_S = 2, 1_000
_SRC = "src/repro_torch/csrc/flash_attention.cu"
_RS = "    wgmma_rs(acc, {}, vd);\n"
_EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
_SPLIT = "    split3(sc[2 * j], sc[2 * j + 1], ph[j], pm[j], pl[j]);"
_TURNS = ('  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kConsumers) '
          ': "memory");',
          '  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(kConsumers)'
          '\n               : "memory");')
EDITS = {
    "one_pv": [(_RS.format("pm + 4 * kk") + _RS.format("pl + 4 * kk"), "")],
    "no_split": [(_SPLIT, "    ph[j] = pm[j] = pl[j] = "
                          "__float_as_uint(sc[2 * j]);")],
    "no_turns": [(t, "") for t in _TURNS],
    "no_ex2": [(_EX2, "  y = x * 0.001f;")],
}
EDITS["floor"] = EDITS["one_pv"] + EDITS["no_split"] + EDITS["no_ex2"]

# B1: chip_smoke.py's shapes, (label, Q, N or (P, S)), graph reps
TOP1_SRC = "src/repro_torch/csrc/sim_top1.cu"
TOP1_SHAPES = [("Q=512 N=65,537", 512, 65_537, 20), ("Q=8 N=65,537", 8,
                                                        65_537, 50),
               ("Q=512 T=4,096", 512, 4_096, 50), ("union Q=1 N=8", 1, 8,
                                                      200),
               ("union Q=16 N=128", 16, 128, 200),
               ("multi Q=512 P=15 S=6,852", 512, (15, 6_852), 10),
               ("multi Q=16 P=15 S=6,852", 16, (15, 6_852), 20)]
_T1_SPLIT = "    for (int it = 0; it < BN * KC / 4 / kThreads; ++it) {"
_T1_FRAG = ("      const float x[4] = {qs[swz(r0, 8 * s + tig)], "
            "qs[swz(r1, 8 * s + tig)],\n"
            "                          qs[swz(r0, 8 * s + tig + 4)],\n"
            "                          qs[swz(r1, 8 * s + tig + 4)]};")
_T1_MMA = "      wgmma_tf32(acc, {}, sw128({} + 32 * s), {});"
_T1_QCOPY = "      for (int e = tid; e < qrows * PER_ROW; e += kThreads) {"
TOP1_EDITS = {
    "three_stages": [("constexpr int NS = 2; ", "constexpr int NS = 3; "),
                     ("__launch_bounds__(kThreads, 4)",
                      "__launch_bounds__(kThreads, 3)")],
    "no_split": [(_T1_SPLIT, "    for (int it = 0; it < 0; ++it) {")],
    "no_afrag": [(_T1_FRAG, "      const float x[4] = {1.f, 2.f, 3.f, "
                            "4.f};")],
    "no_wgmma": [(_T1_MMA.format(a, b, c), "")
                 for a, b, c in (("ah[s]", "hs", "s > 0"),
                                 ("ah[s]", "ls", "1"),
                                 ("al[s]", "hs", "1"))],
}
TOP1_EDITS["copies_only"] = (
    TOP1_EDITS["no_split"] + TOP1_EDITS["no_afrag"] + TOP1_EDITS["no_wgmma"]
    + [(_T1_QCOPY, "      for (int e = tid; e < 0; e += kThreads) {")])

# B5 and B5-multi: chip_smoke.py's shapes, (label, Q, N or (P, S), k,
# graph reps); B4 beside them as a guard, (label, Q, N, D, k, reps)
Q8_SRC = "src/repro_torch/csrc/sim_topk_q8.cu"
_Q8_WRAP = "src/repro_torch/kernels/similarity_topk.py"
Q8_SHAPES = [("Q=1 N=65,537", 1, 65_537, 20), ("Q=512 N=65,537", 512,
                                                  65_537, 20),
             ("multi Q=512 P=15 S=6,852", 512, (15, 6_852), 10),
             ("multi Q=16 P=15 S=6,852", 16, (15, 6_852), 20)]
B4_SHAPES = [("B4 slab Q=8 N=65,537 k=8", 8, 65_537, 768, 8, 20),
             ("B4 slab Q=8 N=65,537 k=257", 8, 65_537, 768, 257, 20),
             ("B4 route Q=512 T=4,096 k=3", 512, 4_096, 769, 3, 50)]
_Q8_MMA = ("        wgmma_s8(acc, sw128(q_sm + c * CHUNK + kk * 32),\n"
           "                 sw128(ring + st * CHUNK + kk * 32), "
           "c > 0 || kk > 0);")
_Q8_NS = "constexpr int NS = 6; "
_Q8_FILL = "    fill = wave // q_tiles if wave else"
# (path, old, new); path None is Q8_SRC
Q8_EDITS = {
    "no_wgmma": [(None, _Q8_MMA, "        acc[kk] += c;")],
    "no_insert": [(None, "      m |= 1u << j;\n", "")],
    "no_merge": [(None, "  const size_t heads = (size_t)nsplit * sizeof(int);",
                  "  return 0;\n"
                  "  const size_t heads = (size_t)nsplit * sizeof(int);")],
    "stages4": [(None, _Q8_NS, "constexpr int NS = 4; ")],
    "stages8": [(None, _Q8_NS, "constexpr int NS = 8; ")],
    "two_waves": [(_Q8_WRAP, _Q8_FILL,
                   "    fill = 2 * wave // q_tiles if wave else")],
    "half_wave": [(_Q8_WRAP, _Q8_FILL,
                   "    fill = wave // 2 // q_tiles if wave else")],
}
Q8_EDITS["copies_only"] = Q8_EDITS["no_wgmma"] + [
    (None, "      fold_rows<0>(acc, qsa, cs, q0 + ra < nq ? live : 0u, va, ia, "
           "stash,\n                   c0 + 2 * quad);\n"
           "      fold_rows<2>(acc, qsb, cs, q0 + rb < nq ? live : 0u, vb, ib, "
           "stash,\n                   c0 + 2 * quad);\n", "")]


# B4: chip_smoke.py's shapes, (label, Q, N, D, k, graph reps); "route" rows
# are the (T, D+1) routing matrix and norm-augmented queries
TOPK_SRC = "src/repro_torch/csrc/sim_topk_f32.cu"
TOPK_SHAPES = [("route Q=1 T=4,096 D+1=769 k=3", 1, 4_096, 769, 3, 200),
               ("route Q=512 T=4,096 D+1=769 k=3", 512, 4_096, 769, 3, 50),
               ("slab Q=8 N=65,537 D=768 k=1", 8, 65_537, 768, 1, 20),
               ("slab Q=8 N=65,537 D=768 k=8", 8, 65_537, 768, 8, 20),
               ("slab Q=8 N=65,537 D=768 k=16", 8, 65_537, 768, 16, 20),
               ("slab Q=8 N=65,537 D=768 k=257", 8, 65_537, 768, 257, 10)]
TOPK_EDITS = {
    "one_stage": [(None, "constexpr int NS = 4; ", "constexpr int NS = 1; "),
                  (None, "constexpr int WNS = 4; ",
                   "constexpr int WNS = 1; ")],
    "old_grid": [(_Q8_WRAP,
                  "    warps = max(1, min(_F32_MAX_WARPS, tiles // n_sm)) "
                  "if skinny else 1",
                  "    warps = _F32_MAX_WARPS if skinny else 1")],
    "device_lists": [(None, "  return k > KREG && smem_bytes(nq, d, k, warps, "
                            "true) <= (size_t)kSmemMax;",
                      "  return false;")],
    "no_filter": [(None, "  unsigned m = __ballot_sync(kFull, live && s > thr);",
                   "  unsigned m = __ballot_sync(kFull, live);"),
                  (None, "    m &= (m - 1) & __ballot_sync(kFull, live && s > thr);",
                   "    m &= m - 1;"),
                  (None, "    const bool pass = v > thr;",
                   "    const bool pass = v > -CUDART_INF_F;")],
    "no_fold": [(None, "  unsigned m = __ballot_sync(kFull, live && s > thr);",
                 "  unsigned m = 0u & __ballot_sync(kFull, live && s > thr);"),
                (None, "  if (m == 0) return;", "  return;")],
    "no_merge": [(None, "  const int mw = merge_warps(k);",
                  "  return 0;\n  const int mw = merge_warps(k);")],
}
# B9: chip_smoke.py's DECODE_SHAPES, (B, H, Hkv, S_max, D), bf16?, reps
DECODE_SRC = "src/repro_torch/csrc/decode_attention.cu"
_DA_WRAP = "src/repro_torch/kernels/decode_attention.py"
DECODE_SHAPES = [((8, 15, 5, 512, 64), True, 50),
                 ((8, 15, 5, 2048, 64), True, 50),
                 ((8, 16, 16, 2048, 256), True, 50),
                 ((8, 96, 8, 2048, 192), True, 50),
                 ((8, 4, 2, 2048, 32), False, 50),
                 ((128, 15, 5, 32768, 64), True, 5)]
DECODE_EDITS = {
    "one_stage": [(None, "  const int most = 65536 / sb < 1 ? 1 :",
                   "  const int most = 1 ? 1 :")],
    "keys32": [(None, "  static constexpr int KS = RB <= 128 ? 128 : RB <= 512 "
                      "? 64 : 32;",
                "  static constexpr int KS = 32;"),
               (_DA_WRAP, "    return 128 if row <= 128 else 64 if row <= 512 "
                          "else 32",
                "    return 32")],
    "old_split": [(_DA_WRAP,
                   "    want = max(-(-_WAVES * wave // rows), "
                   "-(-s_max // _MAX_KEYS))",
                   "    want = min(32, -(-8 * 132 // rows))")],
    "no_lane_split": [(None, "  static constexpr int L = RB <= 128 ? 1 : "
                             "pow2_part(NSL) < 8 ? pow2_part(NSL)",
                       "  static constexpr int L = 1 ? 1 : pow2_part(NSL) < 8 "
                       "? pow2_part(NSL)")],
    "copies_only": [(None, "    const int nk = max(0, min(kw_n, hi - (lo + s * "
                           "S::KS + k0)));",
                     "    const int nk = 0;")],
}


# B3, B2 and B7 (the Eq. 1 kernels): (label, kernel, N or (P, N), T, graph
# reps).  T_REAL is the main replay's topic table at its last eviction
# (chip_smoke.py's main phase prints it: 512 rows); T_BIG a table past
# the staging budget, which takes the gathered design.
VALUES_SRC = "src/repro_torch/csrc/eq1_value.cuh"
_VAL_WRAP = "src/repro_torch/kernels/decision.py"
T_REAL, T_BIG = 512, 131_072
VALUE_ROWS = [("B3 main N=65,537 T=4,096", "rac", 65_537, 4_096, 200),
              (f"B3 main N=65,537 T={T_REAL}", "rac", 65_537, T_REAL, 200),
              (f"B3 gathered N=65,537 T={T_BIG:,}", "rac", 65_537, T_BIG,
               200),
              ("B3 arena N=6,852 T=4,096", "rac", 6_852, 4_096, 200),
              ("B3 serve N=64 T=256", "rac", 64, 256, 200),
              ("B3 ops, int32 t_last N=65,537 T=4,096", "rac_ops", 65_537,
               4_096, 200),
              ("B2 main N=65,537 T=4,096", "victim", 65_537, 4_096, 200),
              (f"B2 main N=65,537 T={T_REAL}", "victim", 65_537, T_REAL,
               200),
              (f"B2 gathered N=65,537 T={T_BIG:,}", "victim", 65_537, T_BIG,
               200),
              ("B2 serve N=65 T=256", "victim", 65, 256, 200),
              ("B7 arena P=15 N=6,852 T=4,096", "multi", (15, 6_852), 4_096,
               200)]
_VEC_LD = ("    const float4 w = __ldg(reinterpret_cast<const float4*>(p + j));\n"
           "    x[j] = w.x, x[j + 1] = w.y, x[j + 2] = w.z, x[j + 3] = w.w;")
_VEC_LDI = ("    const int4 w = __ldg(reinterpret_cast<const int4*>(p + j));\n"
            "    x[j] = w.x, x[j + 1] = w.y, x[j + 2] = w.z, x[j + 3] = w.w;")
_SCALAR_LD = ("#pragma unroll\n    for (int e = 0; e < 4; ++e) "
              "x[j + e] = __ldg(p + j + e);")
VALUE_EDITS = {
    # the parent's walk: one entry a thread, ceil(N / 256) blocks
    "one_per_thread": [(_VAL_WRAP, "    n_vec = n - n % v if aligned else 0",
                        "    n_vec = 0"),
                       (_VAL_WRAP, "STAGED_THREADS, GATHER_THREADS = 256, 64",
                        "STAGED_THREADS, GATHER_THREADS = 256, 256")],
    # V entries a thread on the same grid, each load and store 4 bytes
    "no_vector_loads": [(None, _VEC_LD, _SCALAR_LD),
                        (None, _VEC_LDI, _SCALAR_LD),
                        (None, "      *reinterpret_cast<float4*>(out + c * V + j)"
                               " = o;",
                         "      out[c * V + j] = o.x, out[c * V + j + 1] = o.y,"
                         "\n      out[c * V + j + 2] = o.z, "
                         "out[c * V + j + 3] = o.w;")],
    "v8": [(_VAL_WRAP, "V = 4\n", "V = 8\n"),
           (None, "constexpr int kEq1V = 4;", "constexpr int kEq1V = 8;")],
    "staged128": [(_VAL_WRAP, "STAGED_THREADS, GATHER_THREADS = 256, 64",
                   "STAGED_THREADS, GATHER_THREADS = 128, 64")],
    "gather128": [(_VAL_WRAP, "STAGED_THREADS, GATHER_THREADS = 256, 64",
                   "STAGED_THREADS, GATHER_THREADS = 256, 128")],
    "gather256": [(_VAL_WRAP, "STAGED_THREADS, GATHER_THREADS = 256, 64",
                   "STAGED_THREADS, GATHER_THREADS = 256, 256")],
    "gather32": [(_VAL_WRAP, "STAGED_THREADS, GATHER_THREADS = 256, 64",
                  "STAGED_THREADS, GATHER_THREADS = 256, 32")],
    "no_pdl": [(None, "programmaticStreamSerializationAllowed = 1;",
                "programmaticStreamSerializationAllowed = 0;")],
    # every table gathered (the staged design at T = 4,096)
    "other_tables": [(_VAL_WRAP, "STAGE_MAX = 192 * 1024", "STAGE_MAX = 0")],
    # no work: the prologue, then return (outputs unwritten)
    "floor": [(None, "  pdl_prologue();\n  if (STAGED && threadIdx.x == 0) {",
               "  pdl_prologue();\n  if (a.n >= 0) return;\n"
               "  if (STAGED && threadIdx.x == 0) {")],
}


def ptxas_registers(log: str, keep: str) -> dict:
    """{kernel (mangled name): (registers, spill stores + loads in bytes)}
    for the entry functions whose names hold ``keep``, from a build's
    ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif name and keep in name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1] + nums[2]
        elif name and keep in name and "Used" in line and "registers" in line:
            out[name] = (int(line.split("Used")[1].split()[0]), spill)
            name = None
    return out


def child_q8(out: dict) -> dict:
    """B5, B5-multi and the B4 guard of the checkout just built."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import similarity_topk as st
    from repro_torch.kernels.quant import quantize_rows_int8
    out["registers"] = ptxas_registers(_build.build_log, "topk")
    rng = np.random.default_rng(0)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def q8(x):
        a, s, _ = quantize_rows_int8(x.reshape(-1, x.shape[-1]))
        return (torch.from_numpy(a).to("cuda").view(x.shape),
                torch.from_numpy(s).to("cuda").view(x.shape[:-1]))
    queries = q8(unit(512, 768))
    slab = q8(unit(65_537, 768))
    slabs = q8(unit(15, 6_852, 768))
    counts = torch.full((15,), 6_852, dtype=torch.int32, device="cuda")
    for label, nq, n, reps in Q8_SHAPES:
        q, qs = (x[:nq].contiguous() for x in queries)
        if isinstance(n, tuple):
            out[label] = graph_ms(lambda: st.sim_topk_q8_multi(
                q, qs, *slabs, counts, 8), reps)
        else:
            out[label] = graph_ms(lambda: st.sim_topk_q8(
                q, qs, *slab, n, 8), reps)
    for label, nq, n, d, k, reps in B4_SHAPES:
        q = torch.from_numpy(unit(nq, d)).to("cuda")
        c = torch.from_numpy(unit(n, d)).to("cuda")
        out[label] = graph_ms(lambda: st.sim_topk(q, c, n, k), reps)
    return out


def eager_ms(fn, reps: int, keep: bool, blocks: int = 5) -> float:
    """Milliseconds per eager call over ``reps`` calls back to back (host
    issue included), the median of ``blocks`` such runs (the host's
    neighbours move single runs); ``keep`` holds every output until the
    end of a run, as chip_smoke.py's timer did before (each output then
    needs memory of its own from the allocator)."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        kept = []
        e0.record()
        for _ in range(reps):
            out = fn()
            if keep:
                kept.append(out)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
        del kept
    return sorted(times)[blocks // 2]


def host_us(fn, calls: int = 1000, blocks: int = 3) -> float:
    """Host microseconds per call of ``fn``: perf_counter over ``calls``,
    the median of ``blocks`` runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(times)[blocks // 2]


def value_inputs(kind: str, n, t: int):
    """Seeded tables on the card: chip_smoke.py's check_values inputs (B3:
    tid clamped, t_last shifted so t_now = 0, as f32; the ops row keeps it
    int32 as the backend passes it)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    shape = n if isinstance(n, tuple) else (n,)
    tshape = (shape[0], t) if isinstance(n, tuple) else (t,)

    def dev(x):
        return torch.from_numpy(x).to("cuda")
    tsi = dev(rng.random(shape).astype(np.float32) * 8)
    tid = dev(rng.integers(-1, t, shape).astype(np.int32))
    occ = dev((rng.random(shape) < 0.97).astype(np.int32))
    tp = dev(rng.random(tshape).astype(np.float32) * 20)
    tl = dev(rng.integers(0, 60_000, tshape).astype(np.int32))
    if kind.startswith("rac"):
        tid = tid.clamp(min=0)
        tl = tl - 72_000
        return tsi, tid, tp, tl if kind == "rac_ops" else tl.float()
    return tsi, tid, occ, tp, tl


def value_calls(kind: str, args):
    """(the wrapper call, the ops call, the plain call) for a row."""
    from repro_torch.kernels import decision, ops, rac_value, ref
    alpha = 0.001
    if kind == "rac":
        return (lambda: rac_value.rac_value(*args, alpha, 0),
                lambda: ops.rac_value(*args, alpha, 0),
                lambda: ref.rac_value_ref(*args, alpha, 0))
    if kind == "rac_ops":
        tsi, tid, tp, tl = args
        return (None, lambda: ops.rac_value(*args, alpha, 0),
                lambda: ref.rac_value_ref(tsi, tid, tp, tl.float(), alpha, 0))
    if kind == "victim":
        return (lambda: decision.victim_value(*args, 72_000, alpha),
                lambda: ops.victim_value(*args, 72_000, alpha=alpha),
                lambda: ref.victim_value_ref(*args, 72_000, alpha))
    return (lambda: decision.victim_value_multi(*args, 72_000, alpha),
            lambda: ops.victim_value_multi(*args, 72_000, alpha=alpha),
            lambda: ref.victim_value_multi_ref(*args, 72_000, alpha))


def value_pieces(kind: str, args) -> dict:
    """Host microseconds a call of each piece of the wrapper's issue path
    (the pieces this checkout has)."""
    import torch
    from repro_torch.kernels import _build, decision, ops
    from repro_torch.kernels import rac_value as rv
    from repro_torch.kernels.similarity_topk import _check
    lib = _build.library()
    tsi = args[0]
    dev = tsi.device
    n, t = tsi.shape[-1], args[-2].shape[-1]
    wrapper, ops_call, _ = value_calls(kind, args)
    out = torch.empty_like(tsi)
    pieces = {"wrapper": wrapper, "ops call (_counted, _as)": ops_call,
              "torch.empty": lambda: torch.empty(n, dtype=torch.float32,
                                                 device=dev),
              "torch.empty_like": lambda: torch.empty_like(tsi),
              "_build.library": _build.library,
              "_build.stream_of": lambda: _build.stream_of(tsi),
              "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
                  dev).cuda_stream,
              "data_ptr x6": lambda: [x.data_ptr() for x in (*args, out)]}
    dts = [x.dtype for x in args]
    pieces["_check x%d" % len(args)] = lambda: [
        _check("x", x, dt, x.dim(), dev) for x, dt in zip(args, dts)]
    new = hasattr(decision, "eq1_args")
    if new:
        if kind == "rac":
            a, _ = decision.eq1_args(decision.KIND_RAC_F32, args[0], args[1],
                                     None, args[2], args[3], out, n, t, 1, 0,
                                     0.0, -0.001)
            launch = lambda: lib.rac_value_launch(a)  # noqa: E731
            pieces["eq1_args (plan, pointers, stream, pack)"] = \
                lambda: decision.eq1_args(decision.KIND_RAC_F32, args[0],
                                          args[1], None, args[2], args[3],
                                          out, n, t, 1, 0, 0.0, -0.001)
        else:
            n_pol = args[0].shape[0] if kind == "multi" else 1
            a, _ = decision.eq1_args(decision.KIND_VICTIM, args[0], args[1],
                                     args[2], args[3], args[4], out, n, t,
                                     n_pol, 72_000, 0.0, -0.001)
            launch = lambda: lib.victim_value_launch(a)  # noqa: E731
            pieces["eq1_args (plan, pointers, stream, pack)"] = \
                lambda: decision.eq1_args(decision.KIND_VICTIM, args[0],
                                          args[1], args[2], args[3], args[4],
                                          out, n, t, n_pol, 72_000, 0.0,
                                          -0.001)
            pieces["_check_tables"] = lambda: decision._check_tables(
                tsi.dim(), dev, *args)
        pieces["floor launch"] = lambda: decision.floor_launch(a)
    else:
        stream = _build.stream_of(tsi)
        ptrs = [x.data_ptr() for x in args]
        if kind == "rac":
            launch = lambda: lib.rac_value_launch(  # noqa: E731
                *ptrs, n, t, 0.0, -0.001, out.data_ptr(), dev.index, stream)
        elif kind == "victim":
            launch = lambda: lib.victim_value_launch(  # noqa: E731
                *ptrs, n, t, 72_000, -0.001, out.data_ptr(), dev.index,
                stream)
        else:
            launch = lambda: lib.victim_value_multi_launch(  # noqa: E731
                *ptrs, n, t, args[0].shape[0], 72_000, -0.001,
                out.data_ptr(), dev.index, stream)
    pieces["C launch call (ctypes, device, launch)"] = launch
    del ops, rv
    return {k: host_us(f) for k, f in pieces.items() if f is not None}


def child_values(out: dict, save: str) -> dict:
    """B3, B2 and B7 of the checkout just built at VALUE_ROWS, the
    fused_decide sequence, each row's launch floor (where the checkout has
    one), the host pieces, and the outputs saved to ``save``."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, decision, ops
    out["registers"] = ptxas_registers(_build.build_log, "value")
    out["registers"].update(ptxas_registers(_build.build_log, "eq1"))
    results = {}
    for label, kind, n, t, reps in VALUE_ROWS:
        args = value_inputs(kind, n, t)
        wrapper, ops_call, plain = value_calls(kind, args)
        call = wrapper or ops_call
        got, want = call(), plain()
        # reported, not raised: an ablation's variant may compute nothing
        fin = torch.isfinite(want)
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30))[fin]
                    .max()) if fin.any() else 0.0
        row = {"ms": graph_ms(call, reps),
               "eager_ms": eager_ms(call, reps, keep=False),
               "eager_kept_ms": eager_ms(call, reps, keep=True),
               "rel_err_vs_plain": rel,
               "masks_equal_plain": torch.equal(fin, torch.isfinite(got))}
        if ops_call is not None and wrapper is not None:
            row["ops_eager_ms"] = eager_ms(ops_call, reps, keep=False)
        if hasattr(decision, "floor_launch") and kind != "rac_ops":
            # the floor of this row's launch: its packed arguments
            tsi = args[0]
            nn, tt = tsi.shape[-1], args[-2].shape[-1]
            o = torch.empty_like(tsi)
            if kind == "rac":
                a, _ = decision.eq1_args(decision.KIND_RAC_F32, args[0],
                                         args[1], None, args[2], args[3], o,
                                         nn, tt, 1, 0, 0.0, -0.001)
            else:
                a, _ = decision.eq1_args(
                    decision.KIND_VICTIM, args[0], args[1], args[2], args[3],
                    args[4], o, nn, tt,
                    tsi.shape[0] if kind == "multi" else 1, 72_000, 0.0,
                    -0.001)
            row["floor_ms"] = graph_ms(lambda: decision.floor_launch(a),
                                       reps)
        if label.startswith(("B3 main N=65,537 T=4", "B2 main N=65,537 T=4",
                             "B7")):
            row["host_us"] = value_pieces(kind, args)
        out[label] = row
        results[label] = got.cpu()
        del args
    # the fused_decide sequence: B1 (Q=512 over the slab), B1 (over the
    # topic table), B2, on one stream
    rng = np.random.default_rng(1)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(
            x / np.linalg.norm(x, axis=-1, keepdims=True)).to("cuda")
    q, slab, reps_ = unit(512, 768), unit(65_537, 768), unit(4_096, 768)
    tsi, tid, occ, tp, tl = value_inputs("victim", 65_537, 4_096)

    def fused():
        return ops.fused_decide(q, slab, 65_537, reps_, 4_096, tsi, tid, occ,
                                tp, tl, 72_000, alpha=0.001)

    def b1_pair():
        return (ops.sim_top1(q, slab, 65_537), ops.sim_top1(q, reps_, 4_096))
    # B1 takes ~1.1 ms of the ~1.2: B2's share is the sequence less the
    # pair, each timed three times in turns
    seq, pair = [], []
    for _ in range(3):
        seq.append(graph_ms(fused, 50))
        pair.append(graph_ms(b1_pair, 50))
    out["fused_decide Q=512 N=65,537 T=4,096 D=768"] = {
        "ms": min(seq), "runs_ms": seq, "b1_pair_runs_ms": pair,
        "b2_share_ms": sorted(a - b for a, b in zip(seq, pair))[1],
        "eager_ms": eager_ms(fused, 20, False)}
    results["fused_decide"] = fused()[4].cpu()
    torch.save(results, save)
    return out


def _unit_rows(rng, *shape):
    import numpy as np
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def child_topk(out: dict, save: str) -> dict:
    """B4 of the checkout just built, and its outputs saved to ``save``."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import similarity_topk as st
    out["registers"] = ptxas_registers(_build.build_log, "topk")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    d = 768
    reps = torch.from_numpy(_unit_rows(rng, 4_096, d)).to(dev)
    spread = torch.from_numpy(rng.uniform(0.05, 0.6, 4_096).astype(
        np.float32)).to(dev)
    chunk = torch.from_numpy(_unit_rows(rng, 512, d)).to(dev)
    slab = torch.from_numpy(_unit_rows(rng, 65_537, d)).to(dev)
    # a checkout that takes a row stride gets the mirror's 16-byte pitch
    pitch = -(-(d + 1) // 4) * 4 if hasattr(st, "topk_f32_launches") \
        else d + 1
    aug = torch.zeros((4_096, pitch), device=dev)
    aug[:, :d], aug[:, d] = reps, spread
    q_aug = torch.zeros((512, pitch), device=dev)
    q_aug[:, :d], q_aug[:, d] = chunk, chunk.norm(dim=1)
    results = {}
    for label, nq, n, width, k, reps_ in TOPK_SHAPES:
        if label.startswith("route"):
            q, c = q_aug[:nq, :width], aug[:, :width]
        else:
            q, c = chunk[:nq], slab
        out[label] = graph_ms(lambda: st.sim_topk(q, c, n, k), reps_)
        results[label] = [x.cpu() for x in st.sim_topk(q, c, n, k)]
    torch.save(results, save)
    return out


def child_decode(out: dict, save: str) -> dict:
    """B9 of the checkout just built, and its outputs saved to ``save``."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    out["registers"] = ptxas_registers(_build.build_log, "decode")
    gen = torch.Generator("cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    results = {}
    for (b, h, hkv, s, d), bf16, reps in DECODE_SHAPES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d)))
        pos_np = rng.integers(0, s, b).astype(np.int32)
        pos_np[0], pos_np[-1] = 0, s - 1
        pos = torch.from_numpy(pos_np).to("cuda")
        label = f"B={b} H={h} Hkv={hkv} S_max={s} D={d} {str(dtype)[6:]}"
        out[label] = graph_ms(lambda: da.decode_attention(q, k, v, pos),
                              reps)
        results[label] = da.decode_attention(q, k, v, pos).float().cpu()
        del q, k, v
    torch.save(results, save)
    return out


def compare(mode: str, first: str, other: str) -> dict:
    """Each shape of ``other``'s outputs against ``first``'s: bit-equal
    (B4) or the max |difference| (B9)."""
    import torch
    a, b = torch.load(first), torch.load(other)
    if mode == "topk":
        return {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
                for k in a}
    if mode == "values":
        return {k: torch.equal(a[k], b[k]) for k in a}
    return {k: float((a[k] - b[k]).abs().max()) for k in a}


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``, from a CUDA graph of ``reps`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def child(root: str, prefill: bool, mode: str, save: str) -> dict:
    """Time one checkout's B8 (and prefill), its B1, B5, B4 or B9, in this
    process."""
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import _build, flash_attention as fa
    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not {root}'s")
    _build.library()
    gen = torch.Generator("cuda").manual_seed(2)
    out = {"root": root, "build_s": _build.build_seconds}
    if mode == "q8":
        return child_q8(out)
    if mode == "topk":
        return child_topk(out, save)
    if mode == "decode":
        return child_decode(out, save)
    if mode == "values":
        return child_values(out, save)
    if mode == "top1":
        from repro_torch.kernels import similarity_topk as st
        rng = np.random.default_rng(0)

        def unit(*shape):
            x = rng.standard_normal(shape).astype(np.float32)
            x /= np.linalg.norm(x, axis=-1, keepdims=True)
            return torch.from_numpy(x).to("cuda")
        queries = unit(512, 768)
        for label, nq, n, reps in TOP1_SHAPES:
            q = queries[:nq].contiguous()
            if isinstance(n, tuple):
                slabs = unit(*n, 768)
                counts = torch.full((n[0],), n[1], dtype=torch.int32,
                                    device="cuda")
                out[label] = graph_ms(
                    lambda: st.sim_top1_multi(q, slabs, counts), reps)
            else:
                c = unit(n, 768)
                out[label] = graph_ms(lambda: st.sim_top1(q, c, n), reps)
        return out
    for (b, h, hkv, s, d), reps in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((b, h, s, d), (b, hkv, s, d),
                                          (b, hkv, s, d)))
        out[f"B={b} H={h} Hkv={hkv} S={s} D={d}"] = graph_ms(
            lambda: fa.flash_attention(q, k, v), reps)
        del q, k, v
    if prefill:
        from repro_torch.configs import get_config
        from repro_torch.models import Model, make_prefill_step
        cfg = get_config("paper")
        model = Model(cfg, "cuda")
        params = model.init(torch.Generator("cuda").manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            2, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to("cuda")
        step = make_prefill_step(model)
        batch = {"tokens": tokens}
        step(params, batch)
        torch.cuda.synchronize()
        walls, events = [], []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            step(params, batch)
            e1.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            events.append(e0.elapsed_time(e1))
        out["prefill_wall_ms"] = walls
        out["prefill_event_ms"] = events
        # one more under torch.profiler: the card's busy time, and B8's
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(params, batch)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out["prefill_device_ms"] = sum(
            e.time_range.elapsed_us() for e in kernels) / 1e3
        out["prefill_b8_device_ms"] = sum(
            e.time_range.elapsed_us() for e in kernels
            if "flash_kernel" in e.name) / 1e3
    return out


def ablation_roots(mode: str) -> list[str]:
    """Write the variants of this checkout's kernel; returns their roots."""
    path, variants = {"flash": (_SRC, EDITS), "top1": (TOP1_SRC, TOP1_EDITS),
                      "q8": (Q8_SRC, Q8_EDITS),
                      "topk": (TOPK_SRC, TOPK_EDITS),
                      "decode": (DECODE_SRC, DECODE_EDITS),
                      "values": (VALUES_SRC, VALUE_EDITS)}[mode]
    roots = []
    for name, edits in variants.items():
        root = os.path.join(HERE, "build", "ablate", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(HERE, "src", "repro_torch"),
                        os.path.join(root, "src", "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for edit in edits:
            where, old, new = edit if len(edit) == 3 else (None, *edit)
            file = os.path.join(root, where or path)
            with open(file) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"--ablate {name}: {where or path} no "
                                   f"longer holds {old!r}")
            with open(file, "w") as f:
                f.write(text.replace(old, new))
        roots.append(root)
    return roots


def main() -> None:
    args = sys.argv[1:]
    modes = ("--top1", "--q8", "--topk", "--decode", "--values")
    mode = next((m[2:] for m in modes if m in args), "flash")
    if args[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(args[1]),
                               "--no-prefill" not in args, mode,
                               args[args.index("--save") + 1]
                               if "--save" in args else "")),
              flush=True)
        return
    args = [a for a in args if a not in modes]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab_flash.py: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args == ["--ablate"]:
        variants = ablation_roots(mode)
        roots, extra = [HERE] + variants, ["--no-prefill"]
        roots = roots + roots
    elif args and not any(a.startswith("-") for a in args):
        roots, extra = [os.path.abspath(a) for a in args], []
    else:
        raise SystemExit(__doc__)
    if mode != "flash":
        extra = [f"--{mode}"]
    runs = []
    saved = os.path.join(HERE, "build", "ab_out")
    os.makedirs(saved, exist_ok=True)
    for i, root in enumerate(roots):
        save = os.path.join(saved, f"{mode}-{i}.pt")
        res = subprocess.run([sys.executable, __file__, "--child", root,
                              *extra, "--save", save], capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"{root}: exit {res.returncode}\n"
                             f"{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        if mode in ("topk", "decode", "values") and i > 0:
            runs[-1]["vs_first_root"] = compare(
                mode, os.path.join(saved, f"{mode}-0.pt"), save)
        print(json.dumps(runs[-1]), flush=True)


if __name__ == "__main__":
    main()
