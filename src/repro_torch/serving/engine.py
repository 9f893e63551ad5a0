"""Serving engine: continuous batching + RAC semantic cache front-end, after
``repro/serving/engine.py`` (the same scheduling, line for line).

Request path (the paper's semantic-cache setting, §2):
  1. embed the query (synthetic embedding space offline; a real deployment
     plugs a sentence encoder into ``embed_fn``);
  2. semantic lookup against resident entries through the
     :class:`repro_torch.cache.SemanticCache` facade — the whole waiting
     queue is scored in ONE ``decide_batch`` dispatch (B1 over the slab
     and the topic table, B2 over the RAC policy table on the ``"kernel"``
     backend), and subsequent rescans only rescore waiting requests
     against rows admitted since (``peek_rows``); Top-1 cosine >= tau_hit
     hits return their cached response with zero model compute;
  3. miss -> schedule for generation under continuous batching (prompt
     tokens fed one per decode step; every step is one ``decode_step`` of
     the model, B9 once per layer); on completion, admit (query-embedding,
     response) into the cache.  The facade owns eviction (RAC Eq. 1 values
     through B3) and drops the evicted response payloads itself — the
     engine only observes via the ``"evict"`` event hook.

Event-driven admission: with ``EngineConfig.async_admit`` the cache runs
in ``async_admit`` mode — a completed slot only *enqueues* its admission
(generation never blocks on eviction scoring) and the engine settles the
queue with one ``flush()`` at batch boundaries, just before the waiting
queue is rescored.  Request outputs (tokens, hit flags) are identical to
the synchronous path.  ``host_capacity``/``ghost_capacity`` put the
host-DRAM and ghost tiers behind the cache: the first peek also scores
the host tier (``decide_batch``'s ``host_cid`` columns) and a host hit is
served and promoted like a device hit.

``EngineConfig.device`` places the model, its KV cache and the
``"kernel"`` cache backend (the default) or the ``"sharded"`` one: the
card by default, ``"cpu"`` for the host (the kernels' plain versions).
``cache_backend="numpy"`` asks for the host oracle instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.cache import CacheConfig, SemanticCache, TierConfig
from repro_torch.models import build_model, make_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry.tracker import make_tracker


@dataclasses.dataclass
class EngineConfig:
    cache_capacity: int = 512
    tau_hit: float = 0.85
    max_new_tokens: int = 16
    max_batch: int = 8            # continuous-batching slot count
    max_seq: int = 256
    emb_dim: int = 64
    cache_backend: str = "kernel"  # "kernel" (placed by ``device``) |
                                   # "sharded" (the row-sharded slab, one
                                   # shard a card, placed by ``device``) |
                                   # "numpy" (the host oracle)
    async_admit: bool = False     # queue admissions, flush at batch bounds
    host_capacity: int = 0        # host-DRAM tier rows (0 = single-tier);
                                  # device evictions demote here and host
                                  # hits promote back via the admit path
    ghost_capacity: int = 0       # metadata-only ghost tier entries (0 =
                                  # policy-internal ghosts only)
    tracker: object = None        # telemetry sink: a Tracker instance or
                                  # spec string ("memory", "jsonl:<path>",
                                  # "a+b"), shared with the cache; None
                                  # (default) disables emission
    device: str = "cuda"          # the model, its KV cache and the
                                  # "kernel"/"sharded" cache backend


@dataclasses.dataclass
class RequestState:
    rid: int
    cid: int
    emb: np.ndarray
    tokens: list
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    cached: bool = False
    t_submit: float = 0.0
    t_sched: float = 0.0          # scheduled into a generation slot
    t_first: float = 0.0          # first output token (TTFT proxy anchor)
    t_done: float = 0.0


class ServingEngine:
    """``params`` takes the port's parameters (e.g. the output of
    :func:`repro_torch.models.params_from_reference`); ``generator`` seeds
    fresh ones when there are none."""

    def __init__(self, model_cfg: ModelConfig, ecfg: EngineConfig,
                 params=None, generator: Optional[torch.Generator] = None,
                 policy_kwargs: Optional[dict] = None):
        self.cfg = ecfg
        self.model = build_model(model_cfg, ecfg.device)
        self.params = (params if params is not None
                       else self.model.init(generator))
        self.decode = make_decode_step(self.model)
        # one tracker instance shared with the cache: engine request-path
        # spans and cache.* latencies land in the same registry/trace
        self._trk = make_tracker(ecfg.tracker)
        # semantic cache (RAC-managed) behind the unified facade
        self.cache = SemanticCache(CacheConfig(
            capacity=ecfg.cache_capacity, dim=ecfg.emb_dim,
            tau_hit=ecfg.tau_hit, hit_mode="semantic",
            backend=ecfg.cache_backend, policy="RAC",
            policy_kwargs=policy_kwargs or {}, device=ecfg.device,
            async_admit=ecfg.async_admit,
            tiers=(TierConfig(host_capacity=ecfg.host_capacity,
                              ghost_capacity=ecfg.ghost_capacity)
                   if ecfg.host_capacity > 0 or ecfg.ghost_capacity > 0
                   else None),
            tracker=self._trk))
        self._gen = {"generated_tokens": 0, "batches": 0,
                     "evicted_responses": 0}
        self.cache.subscribe("evict", self._on_evict)
        self._recent_admits: list[int] = []          # admits since last scan
        self.cache.subscribe("admit",
                             lambda ev: self._recent_admits.append(ev.cid))

    def _on_evict(self, ev):
        # the facade already dropped the payload with the entry; the engine
        # only observes (metrics / future writeback)
        if ev.payload is not None:
            self._gen["evicted_responses"] += 1

    def close(self):
        """Release engine-owned resources (stops the async admission
        worker after flushing it; a no-op in blocking mode)."""
        self.cache.close()

    # legacy attribute surface (tests, examples, notebooks) --------------
    @property
    def store(self):
        return self.cache.store

    @property
    def policy(self):
        return self.cache.policy

    @property
    def responses(self):
        return self.cache.payloads

    @property
    def tracker(self):
        """The engine's telemetry sink (None when telemetry is off)."""
        return self._trk

    @property
    def stats(self) -> dict:
        """Serving counters on top of the cache's consolidated metrics
        surface (:meth:`SemanticCache.metrics_snapshot`).  With a tracker
        attached, the admission-stall distribution's p50/p99 ride along."""
        snap = self.cache.metrics_snapshot()
        out = {**self._gen, "hits": snap["hits"], "misses": snap["misses"],
               "evictions": snap["evictions"],
               "hit_ratio": snap["hit_ratio"],
               "admit_stall_s": snap["admit_stall_s"]}
        if self._trk is not None:
            pct = self._trk.percentiles("cache.admit_stall_s")
            if pct is not None:
                out["admit_stall_p50_s"] = pct["p50"]
                out["admit_stall_p99_s"] = pct["p99"]
        return out

    def _finish(self, req: RequestState, outcome: str) -> None:
        """Emit the request's lifecycle spans + TTFT proxy (no-op without
        a tracker): hits resolve in one span; generated requests split
        into queue (submit->slot) and generate (slot->done) child spans on
        the request's own track."""
        trk = self._trk
        if trk is None:
            return
        tags = {"rid": req.rid, "cid": req.cid, "outcome": outcome}
        trk.add_span("serve.request", req.t_submit, req.t_done,
                     track=req.rid, tags=tags)
        if outcome == "hit":
            trk.observe("serve.ttft_s", req.t_done - req.t_submit)
            return
        trk.add_span("serve.queue", req.t_submit, req.t_sched,
                     track=req.rid, tags={"rid": req.rid})
        trk.add_span("serve.generate", req.t_sched, req.t_done,
                     track=req.rid, tags={"rid": req.rid})
        if req.t_first:
            trk.observe("serve.ttft_s", req.t_first - req.t_submit)
        trk.observe("serve.queue_s", req.t_sched - req.t_submit)

    # -- continuous batching -------------------------------------------
    def run(self, requests: list[tuple[int, np.ndarray, list]]) -> list[RequestState]:
        """Process requests: (cid, embedding, prompt_tokens).  Returns the
        completed RequestState list (cache hits answer immediately).  A
        prompt holds 1 to ``max_seq - 1`` tokens, so every position a slot
        writes, idle slots' included, lies inside the KV cache."""
        ecfg = self.cfg
        for _, _, tk in requests:
            if not 1 <= len(tk) < ecfg.max_seq:
                raise ValueError(f"a prompt of {len(tk)} tokens does not "
                                 f"fit max_seq={ecfg.max_seq}")
        pending = [RequestState(rid=i, cid=c, emb=e, tokens=list(tk),
                                t_submit=time.perf_counter())
                   for i, (c, e, tk) in enumerate(requests)]
        done: list[RequestState] = []
        slots: list[Optional[RequestState]] = [None] * ecfg.max_batch

        cache = self.model.init_cache(ecfg.max_batch, ecfg.max_seq)
        pos = np.zeros(ecfg.max_batch, np.int32)
        cur = np.zeros(ecfg.max_batch, np.int32)
        budget = np.zeros(ecfg.max_batch, np.int32)
        queue = list(pending)

        peeked: dict[int, tuple[int, float]] = {}   # rid -> best-known top-1
        peeked_once = [False]
        recent = self._recent_admits

        def serve_hit(req: RequestState, res):
            req.out_tokens = list(res.payload or [])
            req.done = True
            req.cached = True
            req.t_done = time.perf_counter()
            self._finish(req, "hit")
            done.append(req)

        def drain_hits():
            # resolve every waiting request whose best-known similarity
            # clears tau_hit; the definitive miss is only charged when a
            # request is scheduled, so each request is counted exactly once
            waiting = []
            for req in queue:
                c, s = peeked[req.rid]
                if s >= ecfg.tau_hit and (c in self.cache
                                          or self.cache.in_host(c)):
                    res = self.cache.lookup(req.emb, cid=req.cid,
                                            top1=(c, s))
                    serve_hit(req, res)
                else:
                    waiting.append(req)
            queue[:] = waiting

        def try_fill():
            # batch boundary: settle queued admissions before any hit
            # determination (a no-op with synchronous admission)
            if queue:
                self.cache.flush()
            # batched hit determination: the full queue is scored in ONE
            # decide_batch dispatch at first entry; afterwards each waiting
            # request only scores against entries admitted since the last
            # pass, keeping its running best-known top-1 in `peeked`.  A
            # stale best whose entry was evicted is caught by residency
            # checks here and by lookup()'s revalidation at scheduling time.
            if queue and not peeked_once[0]:
                peeked_once[0] = True
                dec = self.cache.decide_batch(
                    np.stack([r.emb for r in queue]))
                for req, c, s in zip(queue, dec.hit_cid, dec.hit_sim):
                    peeked[req.rid] = (int(c), float(s))
                if dec.host_cid is not None:
                    for req, c, s in zip(queue, dec.host_cid, dec.host_sim):
                        if float(s) > peeked[req.rid][1]:
                            peeked[req.rid] = (int(c), float(s))
                recent.clear()
                drain_hits()
            elif queue and recent:
                # row-restricted peek THROUGH the backend: the rescan uses
                # the same cosine scoring as the full peek, so peeked sims
                # and backend sims cannot disagree near tau_hit
                fresh = list(dict.fromkeys(recent))
                recent.clear()
                cids, sims = self.cache.peek_rows(
                    np.stack([r.emb for r in queue]), fresh)
                for i, req in enumerate(queue):
                    if sims[i] > peeked[req.rid][1]:
                        peeked[req.rid] = (int(cids[i]), float(sims[i]))
                drain_hits()
            while queue:
                free = [i for i, s in enumerate(slots) if s is None]
                if not free:
                    return
                i = free[0]
                req = queue.pop(0)
                res = self.cache.lookup(req.emb, cid=req.cid,
                                        top1=peeked.get(req.rid))
                if res.hit:          # store unchanged since peek: rare race
                    serve_hit(req, res)
                    continue
                slots[i] = req
                req.t_sched = time.perf_counter()
                # (prefill folded into decode slots: prompt tokens are fed
                # one per step, as the reference engine does)
                req._feed = list(req.tokens)
                pos[i] = 0
                cur[i] = req._feed.pop(0)
                budget[i] = ecfg.max_new_tokens

        dev = self.model.device
        try_fill()
        while any(s is not None for s in slots):
            batch = {"tokens": torch.from_numpy(cur[:, None]).to(dev),
                     "pos": torch.from_numpy(pos).to(dev)}
            nxt, _, cache = self.decode(self.params, cache, batch)
            nxt = nxt.cpu().numpy()
            self._gen["batches"] += 1
            for i, s in enumerate(slots):
                if s is None:
                    continue
                pos[i] += 1
                if s._feed:                      # still consuming the prompt
                    cur[i] = s._feed.pop(0)
                    continue
                tok = int(nxt[i])
                if not s.out_tokens:
                    s.t_first = time.perf_counter()
                s.out_tokens.append(tok)
                self._gen["generated_tokens"] += 1
                budget[i] -= 1
                if budget[i] <= 0 or pos[i] >= ecfg.max_seq - 1:
                    s.done = True
                    s.t_done = time.perf_counter()
                    self.cache.admit(s.cid, s.emb,
                                     payload=list(s.out_tokens))
                    self._finish(s, "generated")
                    done.append(s)
                    slots[i] = None
                else:
                    cur[i] = tok
            try_fill()
        self.cache.flush()           # settle admissions queued in the tail
        return sorted(done, key=lambda r: r.rid)
