"""Workload generators (paper §4.2).

Two families:

1. ``synthetic_trace`` — topic-level semi-Markov generator.  A trace
   concatenates variable-length topic *episodes*; each episode is one
   complete multi-turn session (never split / interleaved).  Topics are
   drawn Zipf(γ).  Sessions carry an intra-episode dependency DAG (root
   context query + dependent follow-ups).  Two controlled stress axes:

     - *long-reuse ratio*: fraction of reuse events whose reuse distance
       exceeds the reference cache capacity C (repeats of prior sessions
       placed at randomized long/short distances);
     - *Zipf exponent γ*: topic-popularity skew.

   Session repeats come in two modes mirroring the paper's Example 1:
   *full repeat* (all queries recur, paraphrased — the {b0*..b5*} pattern)
   and *anchor variant* (context anchors recur, leaves are new queries that
   depend on them — the {a0, a1*..a5*} pattern).

2. ``oasst_style_trace`` — timestamp-continuous dialogue traces shaped like
   OASST1 (the corpus itself is unavailable offline): Poisson arrivals of
   conversation threads, tree-structured turns, Zipf topic popularity,
   cross-user repeats of popular prompts.  10 sub-traces = 10 seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .embeddings import EmbeddingSpace
from .types import Request, Trace


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SynthConfig:
    n_topics: int = 120
    sessions_per_topic: int = 40      # session pool bound per topic
    trace_len: int = 10_000
    capacity_ref: int = 1000          # C used to classify long vs short reuse
    zipf_gamma: float = 0.7
    long_reuse_ratio: float = 0.5     # target fraction of long reuse events
    repeat_prob: float = 0.35         # fraction of session slots that are
                                      # full repeats of a pooled session
    core_lo: int = 2                  # per-topic core-DAG size (anchors)
    core_hi: int = 4
    session_len_lo: int = 6
    session_len_hi: int = 14
    core_ask_prob: float = 0.85       # prob a session re-asks each core
    dim: int = 64
    seed: int = 0


class _Session:
    """A generated session: ordered queries with dependency parents."""

    __slots__ = ("topic", "cids", "parents")

    def __init__(self, topic: int, cids: list[int], parents: list[int]):
        self.topic = topic
        self.cids = cids
        self.parents = parents          # parent cid per query (-1 = root)


class _TopicDAG:
    """Per-topic persistent core DAG (paper §4.2: sessions within a topic
    share context-ordered dependencies; variants extend branches while
    re-using the topic's core/anchor queries — Example 1's a0 / b2)."""

    __slots__ = ("topic", "core_cids", "core_parents", "sessions")

    def __init__(self, topic: int, rng: np.random.Generator,
                 cfg: SynthConfig, next_cid: list[int]):
        self.topic = topic
        n_core = int(rng.integers(cfg.core_lo, cfg.core_hi + 1))
        self.core_cids: list[int] = []
        self.core_parents: list[int] = []
        for i in range(n_core):
            cid = next_cid[0]
            next_cid[0] += 1
            # core 0 is the root context; later cores depend on the root
            self.core_parents.append(-1 if i == 0 else self.core_cids[0])
            self.core_cids.append(cid)
        self.sessions: list[_Session] = []

    def new_session(self, rng: np.random.Generator, cfg: SynthConfig,
                    next_cid: list[int]) -> _Session:
        """A fresh variant: re-ask (most of) the cores, extend new leaves."""
        cids, parents = [], []
        for cid, par in zip(self.core_cids, self.core_parents):
            if not cids or rng.random() < cfg.core_ask_prob:
                cids.append(cid)
                parents.append(par if (par < 0 or par in cids) else cids[0])
        n_leaf = int(rng.integers(cfg.session_len_lo - 2,
                                  cfg.session_len_hi - 2)) + 1
        for _ in range(max(1, n_leaf)):
            cid = next_cid[0]
            next_cid[0] += 1
            # leaves depend on the root core (60%) or a uniform earlier query
            j = 0 if rng.random() < 0.6 else int(rng.integers(0, len(cids)))
            parents.append(cids[j])
            cids.append(cid)
        sess = _Session(self.topic, cids, parents)
        if len(self.sessions) < cfg.sessions_per_topic:
            self.sessions.append(sess)
        return sess


def _zipf_probs(n: int, gamma: float) -> np.ndarray:
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-gamma)
    return w / w.sum()


def synthetic_trace(cfg: SynthConfig) -> Trace:
    rng = np.random.default_rng(cfg.seed)
    space = EmbeddingSpace(dim=cfg.dim, seed=cfg.seed ^ 0x5EED)
    topic_p = _zipf_probs(cfg.n_topics, cfg.zipf_gamma)
    # shuffle topic identities so popularity rank is not the topic id
    topic_ids = rng.permutation(cfg.n_topics)

    next_cid = [0]
    dags: dict[int, _TopicDAG] = {}
    history: list[tuple[_Session, int]] = []    # (session, last emit end pos)
    cid_topic: dict[int, int] = {}
    cid_parent: dict[int, int] = {}
    occur: dict[int, int] = {}

    requests: list[Request] = []
    session_id = 0
    last_topic = -1

    def emit(sess: _Session, sid: int):
        for cid, par in zip(sess.cids, sess.parents):
            t = len(requests)
            if t >= cfg.trace_len:
                return
            cid_topic[cid] = sess.topic
            cid_parent.setdefault(cid, par)
            k = occur.get(cid, 0)
            occur[cid] = k + 1
            base = space.content_embedding(sess.topic, cid,
                                           parent_content=cid_parent[cid])
            emb = space.paraphrase(base, sess.topic, cid, k)
            requests.append(Request(t=t, cid=cid, emb=emb.astype(np.float32),
                                    topic=sess.topic, session=sid,
                                    parent_cid=cid_parent[cid]))

    while len(requests) < cfg.trace_len:
        sess = None
        if history and rng.random() < cfg.repeat_prob:
            # full repeat of a pooled session, placed long or short
            want_long = rng.random() < cfg.long_reuse_ratio
            pos = len(requests)
            longs = [i for i, (_, end) in enumerate(history)
                     if pos - end > cfg.capacity_ref]
            shorts = [i for i, (_, end) in enumerate(history)
                      if 0 < pos - end <= cfg.capacity_ref]
            pool = longs if (want_long and longs) else (shorts or longs)
            if pool:
                sess, _ = history[int(rng.choice(pool))]
        if sess is None:
            # new session (variant) in a Zipf-drawn topic — re-asks the
            # topic's core anchors, extends fresh dependent leaves
            for _ in range(8):
                tix = int(rng.choice(cfg.n_topics, p=topic_p))
                topic = int(topic_ids[tix])
                if topic != last_topic or cfg.n_topics == 1:
                    break
            dag = dags.get(topic)
            if dag is None:
                dag = dags[topic] = _TopicDAG(topic, rng, cfg, next_cid)
            sess = dag.new_session(rng, cfg, next_cid)
        emit(sess, session_id)
        history.append((sess, len(requests)))
        last_topic = sess.topic
        session_id += 1

    tr = Trace(requests=requests[:cfg.trace_len], n_topics=cfg.n_topics,
               meta=dict(kind="synthetic", cfg=dataclasses.asdict(cfg),
                         unique=len({r.cid for r in requests[:cfg.trace_len]})))
    return tr.with_next_use()


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OASSTConfig:
    trace_len: int = 10_000
    n_topics: int = 300               # broad topic pool, heavy-tailed
    zipf_gamma: float = 0.95
    thread_rate: float = 0.35         # new threads per emitted message
    mean_thread_len: float = 6.0
    branch_prob: float = 0.18         # tree branching (alt continuations)
    popular_repeat_prob: float = 0.30 # new root repeats a popular prior root
    dim: int = 64
    seed: int = 0


def oasst_style_trace(cfg: OASSTConfig) -> Trace:
    """Timestamp-continuous interleaved dialogue threads (OASST1-shaped)."""
    rng = np.random.default_rng(cfg.seed)
    space = EmbeddingSpace(dim=cfg.dim, seed=cfg.seed ^ 0x0A55)
    topic_p = _zipf_probs(cfg.n_topics, cfg.zipf_gamma)
    topic_ids = rng.permutation(cfg.n_topics)

    next_cid = [0]
    # events: (timestamp, topic, cid, parent_cid, thread)
    events: list[tuple[float, int, int, int, int]] = []
    root_pool: dict[int, list[int]] = {}        # topic -> root cids
    root_uses: dict[int, int] = {}
    clock = 0.0
    thread_id = 0
    # generate threads until enough messages
    while len(events) < int(cfg.trace_len * 1.2):
        clock += rng.exponential(1.0 / cfg.thread_rate)
        tix = int(rng.choice(cfg.n_topics, p=topic_p))
        topic = int(topic_ids[tix])
        pool = root_pool.setdefault(topic, [])
        if pool and rng.random() < cfg.popular_repeat_prob:
            # popular prompts recur across users (weighted by prior use)
            w = np.array([1.0 + root_uses.get(c, 0) for c in pool])
            root = int(rng.choice(pool, p=w / w.sum()))
        else:
            root = next_cid[0]
            next_cid[0] += 1
            pool.append(root)
        root_uses[root] = root_uses.get(root, 0) + 1
        # thread tree: follow-up turns with exponential gaps, may branch
        n = max(1, int(rng.poisson(cfg.mean_thread_len)))
        nodes = [(root, -1, clock)]
        frontier = [root]
        tstamp = clock
        for _ in range(n - 1):
            tstamp += rng.exponential(2.0)
            parent = frontier[-1] if rng.random() > cfg.branch_prob else \
                frontier[int(rng.integers(0, len(frontier)))]
            cid = next_cid[0]
            next_cid[0] += 1
            nodes.append((cid, parent, tstamp))
            frontier.append(cid)
        for cid, par, ts in nodes:
            events.append((ts, topic, cid, par, thread_id))
        thread_id += 1

    events.sort(key=lambda e: e[0])
    events = events[:cfg.trace_len]

    occur: dict[int, int] = {}
    cid_parent: dict[int, int] = {}
    requests: list[Request] = []
    for t, (ts, topic, cid, par, thr) in enumerate(events):
        cid_parent.setdefault(cid, par)
        k = occur.get(cid, 0)
        occur[cid] = k + 1
        base = space.content_embedding(topic, cid, parent_content=cid_parent[cid])
        emb = space.paraphrase(base, topic, cid, k)
        requests.append(Request(t=t, cid=cid, emb=emb.astype(np.float32),
                                topic=topic, session=thr,
                                parent_cid=cid_parent[cid], timestamp=ts))

    tr = Trace(requests=requests, n_topics=cfg.n_topics,
               meta=dict(kind="oasst_style", cfg=dataclasses.asdict(cfg),
                         unique=len({r.cid for r in requests})))
    return tr.with_next_use()


def measured_long_reuse_ratio(trace: Trace, capacity: int) -> float:
    """Fraction of reuse events with positional reuse distance > capacity."""
    last: dict[int, int] = {}
    long_n = total = 0
    for r in trace.requests:
        if r.cid in last:
            total += 1
            if r.t - last[r.cid] > capacity:
                long_n += 1
        last[r.cid] = r.t
    return long_n / max(1, total)
