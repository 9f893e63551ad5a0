"""The port's trace simulator against ``repro.core.simulator``: ``Stats``
and the full hit/admit/eviction sequences of RAC must be equal, for the
exact incremental batched replay at chunks {1, 7, 512} and the
per-request loop, on a synthetic and an OASST-style trace.  The port runs
on the ``"kernel"`` backend on the CPU (the kernels' plain versions) and
on its ``"numpy"`` host oracle; the reference on its numpy oracle, which
the reference's own tests hold equal to its kernel backend.
"""
import numpy as np
import pytest

from repro.core import OASSTConfig as ROASST
from repro.core import SynthConfig as RSynth
from repro.core import oasst_style_trace as r_oasst
from repro.core import simulator as rsim
from repro.core import synthetic_trace as r_synth
from repro.core.rac import RAC_VARIANTS as R_VARIANTS
from repro.core.rac import make_rac as r_make_rac
from repro_torch.core import OASSTConfig, SynthConfig, oasst_style_trace
from repro_torch.core import simulator as tsim
from repro_torch.core import synthetic_trace
from repro_torch.core.rac import RAC_VARIANTS, make_rac

DIM, CAP, LEN = 64, 128, 1_500


def _traces(name):
    if name == "synthetic":
        kw = dict(trace_len=LEN, n_topics=16, dim=DIM, capacity_ref=CAP,
                  seed=1)
        return r_synth(RSynth(**kw)), synthetic_trace(SynthConfig(**kw))
    kw = dict(trace_len=LEN, dim=DIM, seed=2)
    return r_oasst(ROASST(**kw)), oasst_style_trace(OASSTConfig(**kw))


@pytest.fixture(scope="module", params=["synthetic", "oasst"])
def traces(request):
    ref, port = _traces(request.param)
    # the port's own trace generator yields the reference's trace
    assert [r.cid for r in ref.requests] == [r.cid for r in port.requests]
    np.testing.assert_array_equal(
        np.stack([r.emb for r in ref.requests]),
        np.stack([r.emb for r in port.requests]))
    return ref, port


def recording(factory, log):
    """Wrap a policy factory so the policy logs its hit, admit and
    eviction decisions in order."""
    def make(capacity, store):
        pol = factory(capacity, store)
        on_hit, on_admit, victim = pol.on_hit, pol.on_admit, pol.victim

        def hit(cid, req, t):
            log.append(("hit", int(cid), int(t)))
            return on_hit(cid, req, t)

        def admit(cid, req, t):
            log.append(("admit", int(cid), int(t)))
            return on_admit(cid, req, t)

        def evict(t):
            v = victim(t)
            log.append(("evict", int(v), int(t)))
            return v

        pol.on_hit, pol.on_admit, pol.victim = hit, admit, evict
        return pol
    make.__name__ = getattr(factory, "__name__", "policy")
    return make


def _stats(s):
    return (s.policy, s.capacity, s.requests, s.hits, s.misses, s.evictions,
            s.hr_full)


_REF_CACHE: dict = {}


def _reference(trace, key, runner, **kw):
    if key not in _REF_CACHE:
        log: list = []
        st = runner(trace, CAP, recording(r_make_rac(), log),
                    backend="numpy", **kw)
        _REF_CACHE[key] = (st, log)
    return _REF_CACHE[key]


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_batched_replay_matches_reference(traces, chunk, backend):
    ref_tr, port_tr = traces
    key = (id(ref_tr), "batched", chunk)
    ref_st, ref_log = _reference(ref_tr, key, rsim.run_policy_batched,
                                 hit_mode="semantic", chunk=chunk)
    log: list = []
    st = tsim.run_policy_batched(port_tr, CAP, recording(make_rac(), log),
                                 hit_mode="semantic", backend=backend,
                                 chunk=chunk, device="cpu")
    assert _stats(st) == _stats(ref_st)
    assert ref_st.evictions > 0 and ref_st.hits > 0
    assert log == ref_log


@pytest.mark.parametrize("hit_mode", ["content", "semantic"])
def test_per_request_replay_matches_reference(traces, hit_mode):
    ref_tr, port_tr = traces
    ref_st, ref_log = _reference(ref_tr, (id(ref_tr), "loop", hit_mode),
                                 rsim.run_policy, hit_mode=hit_mode)
    log: list = []
    st = tsim.run_policy(port_tr, CAP, recording(make_rac(), log),
                         hit_mode=hit_mode, backend="kernel", device="cpu")
    assert _stats(st) == _stats(ref_st)
    assert log == ref_log


@pytest.mark.parametrize("variant", ["RAC w/o TP", "RAC (Eq.1 literal)",
                                     "RAC (pagerank)", "RAC (probation)"])
def test_rac_variants_match_reference(variant):
    ref_tr, port_tr = _traces("synthetic")
    kw = dict(RAC_VARIANTS[variant])
    if kw.get("structural_mode") == "pagerank":
        kw["structural_device"] = "cpu"       # the torch power iteration
    ref_log, log = [], []
    ref_st = rsim.run_policy_batched(
        ref_tr, CAP, recording(r_make_rac(**R_VARIANTS[variant]), ref_log),
        hit_mode="semantic", backend="numpy", chunk=64)
    st = tsim.run_policy_batched(port_tr, CAP, recording(make_rac(**kw), log),
                                 hit_mode="semantic", backend="kernel",
                                 chunk=64, device="cpu")
    assert _stats(st) == _stats(ref_st)
    assert log == ref_log


def test_cuda_is_the_default_device():
    """The entry points run on the card unless the caller asks for the
    CPU: their defaults say so."""
    import inspect
    for fn in (tsim.run_policy, tsim.run_policy_batched):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["backend"].default == "kernel"
