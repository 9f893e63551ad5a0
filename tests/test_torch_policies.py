"""The port's 16 baselines against ``repro.core.policies``: the same
hit/admit/eviction sequence and the same ``Stats`` under ``run_policy``
and ``run_policy_batched`` at chunks {1, 7, 512}, in content and semantic
mode, on one seeded synthetic trace.  Also the seed threading of the
RNG-bearing baselines (TinyLFU, LHD, LeCaR, RANDOM draw the reference's
numbers in the reference's order), ``default_factories(seed=)``,
``run_many`` and the vectorized batch hooks against the scalar loop.

The policies are host state machines, so the backend only decides hits:
the reference runs on its numpy oracle, the port on the ``"kernel"``
backend on the CPU (the kernels' plain versions).
"""
import numpy as np
import pytest

from repro.core import SynthConfig as RSynth
from repro.core import simulator as rsim
from repro.core import synthetic_trace as r_synth
from repro.core.policies import BASELINES as R_BASELINES
from repro.core.policies import RNG_BASELINES as R_RNG
from repro.core.store import ResidentStore as RStore
from repro.core.types import Request as RRequest
from repro_torch.core import (BASELINES, RNG_BASELINES, SynthConfig,
                              default_factories, run_many, synthetic_trace)
from repro_torch.core import simulator as tsim
from repro_torch.core.store import ResidentStore
from repro_torch.core.types import Request

from test_torch_simulator import recording

DIM, CAP, LEN = 32, 40, 400
NAMES = sorted(BASELINES)


@pytest.fixture(scope="module")
def traces():
    kw = dict(trace_len=LEN, n_topics=10, dim=DIM, capacity_ref=CAP, seed=11)
    ref, port = r_synth(RSynth(**kw)), synthetic_trace(SynthConfig(**kw))
    assert [r.cid for r in ref.requests] == [r.cid for r in port.requests]
    return ref, port


def _stats(s):
    return (s.policy, s.capacity, s.requests, s.hits, s.misses, s.evictions,
            s.hr_full)


def _factory(classes, name):
    """A factory with a ``seed`` parameter, so ``seed=`` reaches it."""
    def make(capacity, store, seed=None):
        kw = {} if seed is None else {"seed": seed}
        return classes[name](capacity, store, **kw)
    make.__name__ = name
    return make


def _pair(traces, name, runner, **kw):
    """(reference (stats, log), port (stats, log)) of one replay."""
    ref_tr, port_tr = traces
    rlog, plog = [], []
    rst = getattr(rsim, runner)(
        ref_tr, CAP, recording(_factory(R_BASELINES, name), rlog),
        name=name, backend="numpy", **kw)
    pst = getattr(tsim, runner)(
        port_tr, CAP, recording(_factory(BASELINES, name), plog),
        name=name, backend="kernel", device="cpu", **kw)
    return (rst, rlog), (pst, plog)


def test_the_port_has_the_reference_baselines():
    assert sorted(BASELINES) == sorted(R_BASELINES)
    assert len(BASELINES) == 16
    assert RNG_BASELINES == R_RNG
    for name in NAMES:
        assert BASELINES[name].name == R_BASELINES[name].name == name
        assert BASELINES[name].requires_future == \
            R_BASELINES[name].requires_future


@pytest.mark.parametrize("hit_mode", ["content", "semantic"])
@pytest.mark.parametrize("name", NAMES)
def test_baseline_matches_reference(traces, name, hit_mode):
    """Identical Stats and hit/admit/eviction sequences, per request and
    batched at chunks {1, 7, 512} (content mode's batched replay is the
    per-request loop)."""
    runs = [("run_policy", {})]
    chunks = (1, 7, 512) if hit_mode == "semantic" else (7,)
    runs += [("run_policy_batched", {"chunk": c}) for c in chunks]
    for runner, kw in runs:
        (rst, rlog), (pst, plog) = _pair(traces, name, runner,
                                         hit_mode=hit_mode, **kw)
        assert _stats(pst) == _stats(rst), (runner, kw)
        assert plog == rlog, (runner, kw)
        assert rst.evictions > 0 and rst.hits > 0


@pytest.mark.parametrize("name", sorted(RNG_BASELINES))
def test_rng_baselines_follow_the_reference_seed(traces, name):
    """A seeded RNG baseline draws the reference's numbers in the
    reference's order: the same evictions for the same seed."""
    logs = {}
    for seed in (1, 2):
        for tag, classes, sim, tr in (
                ("ref", R_BASELINES, rsim, traces[0]),
                ("port", BASELINES, tsim, traces[1])):
            log: list = []
            fac = sim.with_seed(_factory(classes, name), seed)
            st = sim.run_policy(tr, CAP, recording(fac, log), name=name,
                                backend="numpy", hit_mode="content")
            logs[tag, seed] = (_stats(st), log)
        assert logs["port", seed] == logs["ref", seed]
    if name == "RANDOM":                     # its victims must move
        assert logs["port", 1][1] != logs["port", 2][1]


def test_with_seed_binds_only_factories_that_take_one():
    def plain(capacity, store):
        return (capacity, store)

    def seeded(capacity, store, seed=None):
        return (capacity, store, seed)
    assert tsim.with_seed(plain, 5) is plain
    assert tsim.with_seed(seeded, None) is seeded
    assert tsim.with_seed(seeded, 5)(3, "s") == (3, "s", 5)
    assert tsim.with_seed(seeded, 5).__name__ == "seeded"


@pytest.mark.parametrize("include_extra", [False, True])
def test_default_factories_match_reference(include_extra):
    port = default_factories(include_extra=include_extra, seed=3)
    ref = rsim.default_factories(include_extra=include_extra, seed=3)
    assert list(port) == list(ref)
    assert len(port) == (22 if include_extra else 15)
    for name in port:
        assert port[name].__name__ == ref[name].__name__


def test_default_factories_seed_and_run_many(traces):
    """``default_factories(seed=)`` binds the RNG baselines' seed, and
    ``run_many(seed=)`` overrides it, as in the reference."""
    ref_tr, port_tr = traces

    def counts(stats):
        return [(s.policy, s.hits, s.misses, s.evictions) for s in stats]

    names = ["RANDOM", "LeCaR", "LHD", "TinyLFU", "LRU"]
    runs = {}
    for seed in (7, 8):
        pf = default_factories(include_extra=True, seed=seed)
        rf = rsim.default_factories(include_extra=True, seed=seed)
        runs["port", seed] = counts(run_many(
            port_tr, 20, {n: pf[n] for n in names}, hit_mode="content",
            backend="numpy"))
        runs["ref", seed] = counts(rsim.run_many(
            ref_tr, 20, {n: rf[n] for n in names}, hit_mode="content",
            backend="numpy"))
        assert runs["port", seed] == runs["ref", seed]
    assert runs["port", 7] != runs["port", 8]
    pf = default_factories(include_extra=True, seed=7)
    over = counts(run_many(port_tr, 20, {n: pf[n] for n in names},
                           hit_mode="content", backend="numpy", seed=8))
    assert over == runs["port", 8]
    # batched=True routes each policy through run_policy_batched
    batched = counts(run_many(port_tr, CAP, {n: pf[n] for n in names},
                              hit_mode="semantic", backend="numpy",
                              batched=True, chunk=64))
    seq = counts(run_many(port_tr, CAP, {n: pf[n] for n in names},
                          hit_mode="semantic", backend="numpy", chunk=64))
    assert batched == seq


@pytest.mark.parametrize("name", NAMES)
def test_on_admit_batch_matches_scalar(name):
    """Batched admission leaves the same state as the scalar loop: the
    decisions on a shared tail agree, and agree with the reference's."""
    rng = np.random.default_rng(5)
    eye = np.eye(8, dtype=np.float32)
    tail = rng.integers(0, 30, size=200).tolist()

    def drive(classes, batched, store_cls=ResidentStore, req_cls=Request):
        store = store_cls(20, 8)
        pol = classes[name](20, store)
        warm = [req_cls(t=t, cid=c, emb=eye[c % 8]) for t, c in
                enumerate(range(12))]
        for r in warm:
            store.insert(r.cid, r.emb)
        if batched:
            pol.on_admit_batch([r.cid for r in warm], warm,
                               [r.t for r in warm])
        else:
            for r in warm:
                pol.on_admit(r.cid, r, r.t)
        ev, hits = [], 0
        for j, c in enumerate(tail):
            req = req_cls(t=len(warm) + j, cid=int(c), emb=eye[c % 8])
            if req.cid in store:
                hits += 1
                pol.on_hit(req.cid, req, req.t)
                continue
            store.insert(req.cid, req.emb)
            pol.on_admit(req.cid, req, req.t)
            while len(store) > 20:
                v = pol.victim(req.t)
                store.remove(v)
                ev.append(v)
        return hits, ev

    scalar = drive(BASELINES, False)
    assert drive(BASELINES, True) == scalar
    assert drive(R_BASELINES, True, RStore, RRequest) == scalar
