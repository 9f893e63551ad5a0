"""Deterministic synthetic embedding space with paper-faithful geometry.

The real paper uses a sentence-embedding model and cosine similarity with a
semantic-equivalence threshold tau_hit = 0.85.  Offline we build a synthetic
unit-norm embedding space whose *similarity structure* matches what the
policy consumes:

  - paraphrases of the same content:            sim ≈ 0.93  (> tau_hit)
  - distinct contents within the same topic:    sim ≈ 0.72  (> tau_edge=0.6,
                                                             < tau_hit)
  - contents of different topics:               sim ≲ 0.30  (< tau_edge)

Construction: each topic ``s`` gets a random unit centroid ``c_s``; a content
item ``i`` in topic ``s`` is ``normalize(c_s·cosθ + u_i·sinθ)`` with a random
orthogonal-ish direction ``u_i`` (θ chosen so item–item in-topic similarity
is ≈ cos²θ ≈ 0.72).  Dependency-linked items share part of their ``u``
component so parent–child similarity is slightly higher than generic
in-topic similarity (≈ 0.78) — mirroring discourse continuity.  A paraphrase
mixes the item embedding with fresh noise at angle φ (cosφ ≈ 0.93).

Everything is keyed by integer ids and a seed → bit-for-bit reproducible
without storing any table (embeddings are *derived*, not sampled-and-kept,
via counter-based RNG).
"""
from __future__ import annotations

import numpy as np

# geometry defaults (see module docstring).  Calibrated so the *maximum*
# cross-content similarity (parent-child pairs) stays below tau_hit=0.85
# while paraphrases stay above it:  generic in-topic ≈ 0.70, parent-child
# ≈ 0.79, paraphrase ≈ 0.93  (tests/test_traces.py asserts the separation).
_COS_THETA = float(np.sqrt(0.70))    # in-topic radial component
_COS_PHI = 0.93                      # paraphrase fidelity
_DEP_SHARE = 0.25                    # fraction of tangent dir shared w/ parent


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-12)


def _rng(seed: int, *ids: int) -> np.random.Generator:
    """Counter-based RNG: independent stream per (seed, ids) tuple."""
    return np.random.default_rng(np.random.SeedSequence([seed, *[i & 0x7FFFFFFF for i in ids]]))


class EmbeddingSpace:
    """Derives embeddings for (topic, content, paraphrase) ids on demand."""

    def __init__(self, dim: int = 64, seed: int = 0,
                 cos_theta: float = _COS_THETA, cos_phi: float = _COS_PHI):
        self.dim = dim
        self.seed = seed
        self.cos_theta = cos_theta
        self.sin_theta = float(np.sqrt(1 - cos_theta ** 2))
        self.cos_phi = cos_phi
        self.sin_phi = float(np.sqrt(1 - cos_phi ** 2))
        self._centroids: dict[int, np.ndarray] = {}
        self._tangents: dict[int, np.ndarray] = {}

    # -- pieces ------------------------------------------------------------
    def topic_centroid(self, topic: int) -> np.ndarray:
        c = self._centroids.get(topic)
        if c is None:
            c = _unit(_rng(self.seed, 1, topic).standard_normal(self.dim))
            self._centroids[topic] = c
        return c

    def _tangent(self, topic: int, content: int, parent_content: int = -1) -> np.ndarray:
        key = (topic << 32) ^ (content & 0xFFFFFFFF)
        u = self._tangents.get(key)
        if u is not None:
            return u
        c = self.topic_centroid(topic)
        g = _rng(self.seed, 2, topic, content).standard_normal(self.dim)
        u = _unit(g - (g @ c) * c)               # orthogonal to centroid
        if parent_content >= 0:
            up = self._tangent(topic, parent_content)
            u = _unit(_DEP_SHARE * up + (1 - _DEP_SHARE) * u)
            u = _unit(u - (u @ c) * c)
        self._tangents[key] = u
        return u

    # -- public ------------------------------------------------------------
    def content_embedding(self, topic: int, content: int,
                          parent_content: int = -1) -> np.ndarray:
        """Canonical embedding of a unique content item."""
        c = self.topic_centroid(topic)
        u = self._tangent(topic, content, parent_content)
        return _unit(self.cos_theta * c + self.sin_theta * u)

    def paraphrase(self, base: np.ndarray, topic: int, content: int,
                   occurrence: int) -> np.ndarray:
        """A paraphrased re-ask of the same content (occurrence>0)."""
        if occurrence == 0:
            return base
        g = _rng(self.seed, 3, topic, content, occurrence).standard_normal(self.dim)
        noise = _unit(g - (g @ base) * base)
        return _unit(self.cos_phi * base + self.sin_phi * noise)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b))
