"""The port's frozen host-loop baselines (``repro_torch.core.legacy_policies``)
against the reference package's and against the port's array-state
policies: for every baseline, identical hit counts and eviction SEQUENCES
on random traces at several capacities, with hits delivered one at a time
and in batches (the array policies' ``on_hit_batch``)."""
import numpy as np
import pytest

from repro.core import LEGACY_BASELINES as R_LEGACY
from repro.core.store import ResidentStore as RStore
from repro.core.types import Request as RRequest
from repro.core.types import Trace as RTrace
from repro_torch.core import BASELINES, LEGACY_BASELINES
from repro_torch.core.store import ResidentStore
from repro_torch.core.types import Request, Trace

NAMES = sorted(LEGACY_BASELINES)
CAPS = [3, 5, 10, 17, 2, 29]


def _trace(cids, req_cls, trace_cls, dim=8):
    reqs = []
    for t, c in enumerate(cids):
        e = np.zeros(dim, np.float32)
        e[c % dim] = 1.0
        reqs.append(req_cls(t=t, cid=int(c), emb=e))
    return trace_cls(requests=reqs).with_next_use()


def _drive(cls, store_cls, tr, capacity, batch_hits=False):
    """Alg. 1 by hand -> (hits, eviction sequence); ``batch_hits`` routes
    runs of consecutive hits through ``on_hit_batch``."""
    store = store_cls(capacity, 8)
    pol = cls(capacity, store)
    ev, hits = [], 0
    pc, pr, pt = [], [], []
    for req in tr.requests:
        if req.cid in store:
            hits += 1
            if batch_hits:
                pc.append(req.cid)
                pr.append(req)
                pt.append(req.t)
                continue
            pol.on_hit(req.cid, req, req.t)
            continue
        if pc:
            pol.on_hit_batch(pc, pr, pt)
            pc, pr, pt = [], [], []
        store.insert(req.cid, req.emb)
        pol.on_admit(req.cid, req, req.t)
        while len(store) > capacity:
            v = pol.victim(req.t)
            store.remove(v)
            ev.append(v)
    if pc:
        pol.on_hit_batch(pc, pr, pt)
    return hits, ev


def test_the_legacy_table_names_the_baselines():
    assert list(LEGACY_BASELINES) == list(R_LEGACY)
    assert set(LEGACY_BASELINES) == set(BASELINES)


@pytest.mark.parametrize("name", NAMES)
def test_legacy_policy_matches_the_reference_and_the_array_policy(name):
    rng = np.random.default_rng(0)
    for trial, cap in enumerate(CAPS):
        cids = rng.integers(0, 20 + 8 * trial, size=400).tolist()
        want = _drive(R_LEGACY[name], RStore,
                      _trace(cids, RRequest, RTrace), cap)
        tr = _trace(cids, Request, Trace)
        assert _drive(LEGACY_BASELINES[name], ResidentStore, tr, cap) == want
        assert _drive(BASELINES[name], ResidentStore, tr, cap) == want
        assert _drive(BASELINES[name], ResidentStore, tr, cap,
                      batch_hits=True) == want
