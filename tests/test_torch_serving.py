"""The port's serving engine and facade against the JAX package's, on the
CPU.

- ``repro_torch.serving.ServingEngine(device="cpu")`` on the ``"numpy"`` and
  ``"kernel"`` backends against ``repro.serving.ServingEngine`` with the
  same carried-over fp32 parameters and requests: per-request
  ``out_tokens`` and ``cached`` and the ``stats`` counters must be equal
  (greedy tokens from logits that agree to ~1e-6); also for the MoE/MLA
  (deepseek), hybrid (hymba), encoder-decoder (whisper, its decoder
  alone, as the reference's engine serves it), xLSTM and VLM (internvl2)
  smoke variants, and ``launch/serve.py`` for each of the last three.
- The port's facade built with ``policy=`` each of the 16 baselines makes
  the reference facade's event stream on one trace.
- The synchronous, single-tier surface (``flush``/``drain``, ``close``,
  ``in_host``, ``pending_admits``, ``admit_stall_s``, ``tier_stats``), and
  asynchronous admission and RadixRAC serving like the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.cache import CacheConfig as RCacheConfig
from repro.cache import SemanticCache as RSemanticCache
from repro.configs import get_config as r_get_config
from repro.core import SynthConfig as RSynthConfig
from repro.core import synthetic_trace as r_synthetic_trace
from repro.core.policies import BASELINES as R_BASELINES
from repro.models import smoke_variant as r_smoke
from repro.serving import EngineConfig as REngineConfig
from repro.serving import ServingEngine as RServingEngine
from repro_torch.cache import CacheConfig, SemanticCache
from repro_torch.configs import get_config
from repro_torch.core import BASELINES, SynthConfig, synthetic_trace
from repro_torch.kernels import ops
from repro_torch.models import params_from_reference, smoke_variant
from repro_torch.serving import EngineConfig, ServingEngine

ENGINE = dict(cache_capacity=16, max_new_tokens=4, max_batch=4, max_seq=64)
STATS = ("hits", "misses", "evictions", "generated_tokens", "batches")


def _requests(vocab):
    trace = r_synthetic_trace(RSynthConfig(trace_len=70, n_topics=8,
                                           seed=4))
    rng = np.random.default_rng(4)
    return [(r.cid, r.emb, [int(t) for t in rng.integers(
        2, vocab, size=int(rng.integers(2, 10)))]) for r in trace.requests]


def _outcome(engine, requests):
    done = engine.run(requests)
    s = engine.stats
    return ([(r.rid, r.cid, r.cached, tuple(int(t) for t in r.out_tokens))
             for r in done], {k: s[k] for k in STATS})


@pytest.fixture(scope="module")
def reference_run():
    cfg = r_smoke(r_get_config("paper"))
    eng = RServingEngine(cfg, REngineConfig(**ENGINE),
                         rng=jax.random.PRNGKey(7))
    reqs = _requests(cfg.vocab_size)
    out = _outcome(eng, reqs)
    return jax.tree.map(np.asarray, eng.params), reqs, out


@pytest.mark.parametrize("backend", ["numpy", "kernel", "sharded"])
def test_engine_matches_the_reference_engine(reference_run, backend):
    tree, reqs, (want, want_stats) = reference_run
    cfg = smoke_variant(get_config("paper"))
    eng = ServingEngine(cfg, EngineConfig(**ENGINE, cache_backend=backend,
                                          device="cpu"),
                        params=params_from_reference(tree, cfg, "cpu"))
    d0 = ops.dispatch_stats["launches"]
    got, stats = _outcome(eng, reqs)
    assert stats == want_stats
    assert got == want
    assert want_stats["hits"] > 0 and want_stats["evictions"] > 0
    # every decode step dispatches decode attention once per layer
    assert ops.dispatch_stats["launches"] - d0 >= \
        stats["batches"] * cfg.n_layers
    eng.close()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hymba-1.5b",
                                  "whisper-medium", "xlstm-125m",
                                  "internvl2-26b"])
def test_engine_serves_the_other_families_like_the_reference(arch):
    """The MoE/MLA, hybrid, encoder-decoder, xLSTM and VLM smoke variants
    behind the engine, with no family branch of its own: the reference
    engine's tokens, cached flags and counters from the same carried-over
    parameters (every slot steps, idle ones too; a reused slot keeps its
    Mamba or xLSTM state; whisper decodes without the encoder's output:
    all as in the reference)."""
    rcfg = r_smoke(r_get_config(arch))
    ref = RServingEngine(rcfg, REngineConfig(**ENGINE),
                         rng=jax.random.PRNGKey(3))
    reqs = _requests(rcfg.vocab_size)
    want, want_stats = _outcome(ref, reqs)
    cfg = smoke_variant(get_config(arch))
    eng = ServingEngine(cfg, EngineConfig(**ENGINE, device="cpu"),
                        params=params_from_reference(
                            jax.tree.map(np.asarray, ref.params), cfg,
                            "cpu"))
    got, stats = _outcome(eng, reqs)
    assert stats == want_stats
    assert got == want
    assert want_stats["hits"] > 0 and want_stats["evictions"] > 0
    eng.close()


@pytest.mark.parametrize("arch", ["whisper-medium", "xlstm-125m",
                                  "internvl2-26b"])
def test_launch_serve_runs_the_new_archs_like_the_reference(arch):
    """``launch/serve.py --arch <arch> --device cpu`` makes the reference
    CLI's hit, miss and eviction counts (whisper serves its decoder alone,
    as the reference's engine does)."""
    from repro.launch import serve as rserve
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--requests", "30", "--capacity", "10",
            "--max-new", "2"]
    want = rserve.main(argv)
    got = serve.main(argv + ["--device", "cpu"])
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}
    assert want["evictions"] > 0


def test_launch_serve_matches_the_reference_cli():
    from repro.launch import serve as rserve
    from repro_torch.launch import serve
    argv = ["--requests", "40", "--capacity", "12", "--max-new", "3"]
    want = rserve.main(argv)
    got = serve.main(argv + ["--device", "cpu"])
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}


def test_engine_defaults_to_the_kernel_backend_on_the_card(monkeypatch):
    """EngineConfig() places the model and the RAC cache (B1-B3) on the
    card; device="cpu" keeps the kernel backend on its plain versions, and
    the host oracle runs only when asked for."""
    from repro_torch.cache import KernelBackend, NumpyBackend
    from repro_torch.launch import serve
    ecfg = EngineConfig()
    assert (ecfg.cache_backend, ecfg.device) == ("kernel", "cuda")
    cfg = smoke_variant(get_config("paper"))
    gen = torch.Generator().manual_seed(0)
    eng = ServingEngine(cfg, EngineConfig(**ENGINE, device="cpu"),
                        generator=gen)
    assert isinstance(eng.cache.backend, KernelBackend)
    assert eng.cache.backend.device == torch.device("cpu")
    eng = ServingEngine(cfg, EngineConfig(**ENGINE, cache_backend="numpy",
                                          device="cpu"), generator=gen)
    assert isinstance(eng.cache.backend, NumpyBackend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, EngineConfig(**ENGINE), generator=gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "4"])


def test_engine_checks_what_it_cannot_run():
    """Asynchronous admission and the tiers, which raised before, build
    (the engine's outputs under them are held to the reference's in
    ``tests/test_torch_tiers.py``); a prompt that does not fit raises."""
    cfg = smoke_variant(get_config("paper"))
    eng = ServingEngine(cfg, EngineConfig(async_admit=True, device="cpu"))
    assert eng.cache.admitter is not None and eng.cache.admitter.background
    eng.close()
    assert eng.cache.admitter is None
    eng = ServingEngine(cfg, EngineConfig(host_capacity=8, device="cpu"))
    assert eng.cache.tiers.host.capacity == 8
    eng = ServingEngine(cfg, EngineConfig(**ENGINE, device="cpu"),
                        generator=torch.Generator().manual_seed(0))
    emb = np.ones(64, np.float32) / 8.0
    with pytest.raises(ValueError, match="max_seq"):
        eng.run([(0, emb, list(range(2, 66)))])
    with pytest.raises(ValueError, match="max_seq"):
        eng.run([(0, emb, [])])


def _events(cache):
    log = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, _l=log: _l.append(
            (ev.kind, int(ev.cid), int(ev.t))))
    return log


def _replay(cache, requests):
    for req in requests:
        if not cache.lookup(req.emb, cid=req.cid, t=req.t, req=req).hit:
            cache.admit(req.cid, req.emb, t=req.t, req=req)


@pytest.fixture(scope="module")
def traces():
    cfg = dict(trace_len=600, n_topics=12, dim=32, seed=9)
    ref = r_synthetic_trace(RSynthConfig(**cfg)).with_next_use()
    port = synthetic_trace(SynthConfig(**cfg)).with_next_use()
    assert [r.cid for r in ref.requests] == [r.cid for r in port.requests]
    return ref, port


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("policy", sorted(R_BASELINES))
def test_facade_builds_every_baseline_like_the_reference(traces, policy,
                                                         backend):
    """The repair of the port's facade: ``policy=<baseline>`` builds
    :data:`BASELINES[policy]` (it used to raise), with the reference's
    hit/miss/admit/evict events."""
    assert set(BASELINES) == set(R_BASELINES)
    rtrace, ptrace = traces
    ref = RSemanticCache(RCacheConfig(capacity=40, dim=32, policy=policy,
                                      backend="numpy"))
    want = _events(ref)
    _replay(ref, rtrace.requests)
    kw = {"device": "cpu"} if backend == "kernel" else {}
    port = SemanticCache(CacheConfig(capacity=40, dim=32, policy=policy,
                                     backend=backend, **kw))
    assert type(port.policy).__name__ == type(ref.policy).__name__
    got = _events(port)
    _replay(port, ptrace.requests)
    assert got == want
    assert any(e[0] == "evict" for e in want)


def test_synchronous_single_tier_surface():
    cache = SemanticCache(CacheConfig(capacity=2, dim=4, policy="LRU",
                                      backend="numpy"))
    ref = RSemanticCache(RCacheConfig(capacity=2, dim=4, policy="LRU",
                                      backend="numpy"))
    for c in (cache, ref):
        for cid in range(3):
            e = np.eye(4, dtype=np.float32)[cid]
            c.admit(cid, e, payload=[cid])
    assert cache.flush() == ref.flush() == []
    assert cache.drain() == []
    assert cache.pending_admits == ref.pending_admits == 0
    assert cache.tier_stats == ref.tier_stats == {}
    assert not cache.in_host(0) and not ref.in_host(0)
    assert cache.admit_stall_s == cache.metrics.admit_s > 0
    cache.close()
    cache.admit(3, np.eye(4, dtype=np.float32)[3])      # still usable
    assert 3 in cache and len(cache) == 2
    assert cache.metrics_snapshot()["pending_admits"] == 0


def test_unported_cache_features_still_raise():
    """Nothing raises any more: asynchronous admission, RadixRAC and the
    sharded backend, which raised before, serve one admit and one lookup
    as the reference's facade does (the sharded one on the card by
    default, so without a card it asks for ``device="cpu"``)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SemanticCache(CacheConfig(capacity=4, dim=4, backend="sharded"))
    emb = np.eye(4, dtype=np.float32)[1]
    for kw in ({"async_admit": True},
               {"policy": "RadixRAC", "hit_mode": "content"},
               {"backend": "sharded", "backend_kwargs": {"n_shards": 2}}):
        kw = {"backend": "numpy", **kw}
        port = SemanticCache(CacheConfig(capacity=4, dim=4, device="cpu",
                                         **kw))
        ref = RSemanticCache(RCacheConfig(capacity=4, dim=4,
                                          use_pallas=False, **kw))
        logs = [_events(c) for c in (port, ref)]
        for cache in (port, ref):
            if "policy" in kw:
                pol = cache.policy
                pol.stage(topic=pol.touch_topic(None, 1), parent=-1)
            cache.admit(2, emb, payload=[2], t=1)
            cache.flush()
            res = cache.lookup(emb, cid=2, t=2)
            assert res.hit and res.payload == [2]
            cache.close()
        assert logs[0] == logs[1]
