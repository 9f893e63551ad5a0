"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any fault raises and exits non-zero; nothing is caught):

  1. device  - a CUDA card is required; prints its name and power limit.
  2. build   - compiles csrc/*.cu for sm_90a (one nvcc call) and prints
               the build seconds and the ptxas register report.
  3. kernels - each hand-written kernel against its plain PyTorch version on
               the card at the main path's shapes, then CUDA-event timings
               of kernel, plain version and library yardstick (device time
               per call, from a CUDA graph of many calls; ``eager_ms`` is
               the kernel's time per eager call, host issue included),
               printed as one JSON line {"kernels": [...]}.
  4. parity  - the first 8,000 requests of the trace at D=768, capacity
               4,096, replayed on the kernel backend on the card and on the
               port's NumpyBackend host oracle: hit, admit and eviction
               sequences must be identical.
  5. main    - run_policy_batched(RAC, backend="kernel", device="cuda") over
               the whole OASST-style trace at D=768, capacity 65,536 (a
               65,537 x 768 fp32 slab on the card), chunk 512; every kernel
               must have launched.

The last line of standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DIM = 768                  # GPTCache's default ONNX embedder width
CAPACITY = 65_536
TRACE_LEN = 72_000
CHUNK = 512
PARITY_LEN, PARITY_CAP = 8_000, 4_096
N_TOPICS = 4_096           # routing-table rows for the kernel check
ALPHA = 0.001
DEVICE = "cuda"

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

SIM_TOL = 1e-5             # fp32 dot products summed in another order
VALUE_RTOL = 1e-6          # exp2f and the product order match the plain one


def log(*a):
    print(*a, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # the plain versions and the library yardstick run IEEE fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line:
            log("  " + line.strip())


def _elapsed_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` eager calls back
    to back, after two warm-up calls: where the device outruns the host,
    this is the host's issue cost per call."""
    fn()
    fn()
    torch.cuda.synchronize()
    return _elapsed_ms(lambda: [fn() for _ in range(reps)]) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn``: ``reps`` calls are
    captured in one CUDA graph and replayed, so the host's issue cost
    (argument checks, allocation, the ctypes call) is not in the time."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return _elapsed_ms(g.replay) / reps


def timings(kernel, plain, library, reps: int) -> dict:
    """Device time per call of the kernel, its plain version and the
    library yardstick (CUDA graphs), and the kernel's eager time."""
    for fn in (plain, library):
        if fn is not None:
            fn()                                # warm-up off the capture
    return {"eager_ms": event_ms(kernel, reps), "ms": graph_ms(kernel, reps),
            "plain_ms": graph_ms(plain, reps),
            "library_ms": None if library is None else graph_ms(library, reps)}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def check_sim_top1(q, c, n_valid, reps):
    from repro_torch.kernels import ref, similarity_topk
    v, i = similarity_topk.sim_top1(q, c, n_valid)
    pv, pi = ref.sim_top1_ref(q, c, n_valid)
    torch.cuda.synchronize()
    err = float((v - pv).abs().max())
    if not err <= SIM_TOL:
        raise AssertionError(f"sim_top1 {tuple(q.shape)}x{tuple(c.shape)}: "
                             f"max |err| {err} > {SIM_TOL}")
    # indices must agree wherever the top-2 gap is wider than the tolerance
    scores = q @ c[:n_valid].T
    top2 = scores.topk(2, dim=1).values if n_valid > 1 else None
    clear = (top2[:, 0] - top2[:, 1] > 1e-4) if top2 is not None \
        else torch.ones_like(v, dtype=torch.bool)
    bad = int(((i != pi) & clear).sum())
    if bad:
        raise AssertionError(f"sim_top1: {bad} argmax disagreements")
    nq, d = q.shape
    nb, op = bound((nq * d + n_valid * d) * 4 + nq * 8,
                   2.0 * nq * n_valid * d)
    return {
        "shape": f"Q={nq} N={c.shape[0]} D={d} n_valid={n_valid}",
        "max_abs_err": err, "bound_ms": nb, "bound_by": op,
        **timings(lambda: similarity_topk.sim_top1(q, c, n_valid),
                  lambda: ref.sim_top1_ref(q, c, n_valid),
                  lambda: torch.mm(q, c.T), reps),
    }


def check_values(rng, n: int, t: int, reps: int):
    from repro_torch.kernels import decision, rac_value, ref
    dev = torch.device(DEVICE)
    tsi = torch.from_numpy(rng.random(n).astype(np.float32) * 8).to(dev)
    tid = torch.from_numpy(rng.integers(-1, t, n).astype(np.int32)).to(dev)
    occ = torch.from_numpy((rng.random(n) < 0.97).astype(np.int32)).to(dev)
    tp = torch.from_numpy(rng.random(t).astype(np.float32) * 20).to(dev)
    tl = torch.from_numpy(rng.integers(0, 60_000, t).astype(np.int32)).to(dev)
    t_now = 72_000
    out = {}

    def rel(a, b):
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)) \
                or not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError("+inf masks differ")
        e = ((a - b).abs() / b.abs().clamp(min=1e-30))[fin]
        return float(e.max()) if e.numel() else 0.0, \
            float((a - b)[fin].abs().max()) if e.numel() else 0.0

    vv = decision.victim_value(tsi, tid, occ, tp, tl, t_now, ALPHA)
    pv = ref.victim_value_ref(tsi, tid, occ, tp, tl, t_now, ALPHA)
    r, a = rel(vv, pv)
    if not r <= VALUE_RTOL:
        raise AssertionError(f"victim_value: rel err {r} > {VALUE_RTOL}")
    nb, op = bound(n * 16 + t * 8, 6.0 * n)
    out["victim_value"] = {
        "shape": f"N={n} T={t}", "max_abs_err": a, "max_rel_err": r,
        "bound_ms": nb, "bound_by": op,
        **timings(lambda: decision.victim_value(
            tsi, tid, occ, tp, tl, t_now, ALPHA),
            lambda: ref.victim_value_ref(tsi, tid, occ, tp, tl, t_now, ALPHA),
            None, reps)}

    # the backend shifts time so t_now = 0 and uploads t_last as f32
    tid0 = tid.clamp(min=0)
    tlf = (tl - t_now).to(torch.float32)
    rv = rac_value.rac_value(tsi, tid0, tp, tlf, ALPHA, 0)
    pr = ref.rac_value_ref(tsi, tid0, tp, tlf, ALPHA, 0)
    r, a = rel(rv, pr)
    if not r <= VALUE_RTOL:
        raise AssertionError(f"rac_value: rel err {r} > {VALUE_RTOL}")
    nb, op = bound(n * 12 + t * 8, 5.0 * n)
    out["rac_value"] = {
        "shape": f"N={n} T={t}", "max_abs_err": a, "max_rel_err": r,
        "bound_ms": nb, "bound_by": op,
        **timings(lambda: rac_value.rac_value(tsi, tid0, tp, tlf, ALPHA, 0),
                  lambda: ref.rac_value_ref(tsi, tid0, tp, tlf, ALPHA, 0),
                  None, reps)}
    return out


def phase_kernels(trace):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    embs = np.stack([r.emb for r in trace.requests]).astype(np.float32)
    slab = torch.from_numpy(embs[:CAPACITY + 1]).to(dev)
    chunk = torch.from_numpy(embs[-CHUNK:]).to(dev)
    reps = torch.from_numpy(unit_rows(rng, N_TOPICS, DIM)).to(dev)
    sim = [check_sim_top1(chunk, slab, CAPACITY + 1, 20),
           check_sim_top1(chunk[:8].contiguous(), slab, CAPACITY + 1, 50),
           check_sim_top1(chunk, reps, N_TOPICS, 50)]
    # the ragged and masked edges: an all-masked row is (-inf, 0), and
    # duplicated candidates resolve to the lowest index
    from repro_torch.kernels import similarity_topk
    v, i = similarity_topk.sim_top1(chunk[:5].contiguous(), slab, 0)
    if not bool((v == float("-inf")).all()) or int(i.abs().sum()) != 0:
        raise AssertionError("an all-masked row must be (-inf, 0)")
    dup = slab[:1].repeat(3000, 1).contiguous()
    v, i = similarity_topk.sim_top1(chunk[:5].contiguous(), dup, 3000)
    if int(i.abs().sum()) != 0:
        raise AssertionError("ties must go to the lower index")
    values = check_values(rng, CAPACITY + 1, N_TOPICS, 200)
    return sim, values


def recording(factory, log_: list):
    """Wrap a policy factory so the policy logs its hit, admit and
    eviction decisions in order."""
    def make(capacity, store):
        pol = factory(capacity, store)
        on_hit, on_admit, victim = pol.on_hit, pol.on_admit, pol.victim

        def hit(cid, req, t):
            log_.append(("hit", int(cid), int(t)))
            return on_hit(cid, req, t)

        def admit(cid, req, t):
            log_.append(("admit", int(cid), int(t)))
            return on_admit(cid, req, t)

        def evict(t):
            v = victim(t)
            log_.append(("evict", int(v), int(t)))
            return v

        pol.on_hit, pol.on_admit, pol.victim = hit, admit, evict
        return pol
    make.__name__ = getattr(factory, "__name__", "policy")
    return make


def phase_parity(trace):
    from repro_torch.core import make_rac, run_policy_batched
    from repro_torch.core.types import Trace
    sub = Trace(requests=trace.requests[:PARITY_LEN],
                n_topics=trace.n_topics, meta=dict(trace.meta))
    runs = {}
    for backend, device in (("kernel", DEVICE), ("numpy", "cpu")):
        events: list = []
        t0 = time.perf_counter()
        st = run_policy_batched(sub, PARITY_CAP,
                                recording(make_rac(), events),
                                hit_mode="semantic", backend=backend,
                                device=device, chunk=CHUNK)
        runs[backend] = (st, events)
        log(f"parity {backend}/{device}: hits={st.hits} misses={st.misses} "
            f"evictions={st.evictions} wall={time.perf_counter() - t0:.2f}s")
    (sk, ek), (sn, en) = runs["kernel"], runs["numpy"]
    if (sk.hits, sk.misses, sk.evictions) != (sn.hits, sn.misses,
                                               sn.evictions):
        raise AssertionError("parity: Stats differ")
    if ek != en:
        first = next(j for j, (a, b) in enumerate(zip(ek, en)) if a != b)
        raise AssertionError(f"parity: event {first} differs: "
                             f"{ek[first]} vs {en[first]}")
    if sk.evictions == 0 or sk.hits == 0:
        raise AssertionError("parity prefix made no evictions or no hits")
    log(f"parity: {len(ek)} hit/admit/evict events identical")


def phase_main(trace):
    from repro_torch.core import make_rac, run_policy_batched
    from repro_torch.kernels import decision, ops, rac_value, similarity_topk
    wrappers = {"sim_top1": similarity_topk, "victim_value": decision,
                "rac_value": rac_value}
    for mod in wrappers.values():
        mod.launches = 0
    before = dict(ops.dispatch_stats)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = run_policy_batched(trace, CAPACITY, make_rac(), hit_mode="semantic",
                            backend="kernel", device=DEVICE, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: m.launches for k, m in wrappers.items()}
    disp = {k: ops.dispatch_stats[k] - before[k] for k in before}
    n = len(trace.requests)
    log(f"main: requests={n} hits={st.hits} misses={st.misses} "
        f"evictions={st.evictions} hit_ratio={st.hit_ratio:.4f} "
        f"wall={wall:.2f}s ({n / wall:.1f} req/s)")
    log(f"main: dispatch={json.dumps(disp)} kernel_launches="
        f"{json.dumps(launches)} kernel_share_of_wall="
        f"{disp['kernel_s'] / wall:.4f} peak_device_bytes="
        f"{torch.cuda.max_memory_allocated()}")
    if st.hits + st.misses != n:
        raise AssertionError("main: hits + misses != requests")
    if st.evictions <= 0 or st.hits <= 0:
        raise AssertionError("main: the replay made no evictions or no hits")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"main: kernels never launched: {missing}")
    return launches


def main():
    t_start = time.perf_counter()
    kind = phase_device()
    phase_build()
    from repro_torch.core import OASSTConfig, oasst_style_trace
    t0 = time.perf_counter()
    trace = oasst_style_trace(OASSTConfig(dim=DIM, trace_len=TRACE_LEN,
                                          seed=0))
    log(f"trace: {len(trace.requests)} requests, "
        f"{len({r.cid for r in trace.requests})} unique, D={DIM} "
        f"({time.perf_counter() - t0:.1f}s)")
    sim, values = phase_kernels(trace)
    phase_parity(trace)
    launches = phase_main(trace)

    src = "src/repro_torch/csrc/"
    rows = [{"name": "sim_top1", "route": "cuda",
             "source": src + "sim_top1.cu",
             "replaces": "src/repro/kernels/similarity_topk.py:67",
             "launches": launches["sim_top1"],
             **{k: sim[0][k] for k in ("ms", "eager_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
             "max_abs_err": max(s["max_abs_err"] for s in sim),
             "library_call": "torch.mm (product only, IEEE fp32)",
             "shapes": sim}]
    for name, replaces in (("victim_value", "decision.py:50"),
                           ("rac_value", "rac_value.py:31")):
        v = values[name]
        rows.append({"name": name, "route": "cuda",
                     "source": src + name + ".cu",
                     "replaces": "src/repro/kernels/" + replaces,
                     "launches": launches[name],
                     **{k: v[k] for k in ("max_abs_err", "ms", "eager_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
                     "shapes": [v]})
    for r in rows:
        r["kernel_ms"] = r["ms"]
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
