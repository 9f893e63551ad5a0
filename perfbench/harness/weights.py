"""The weights of a configuration, drawn by the benchmark on the device from
the seed and handed to the program and, drawn again, to the reference.

:func:`layout` gives every leaf's path, shape and dtype in the nested tree
the port's models take (dicts and lists: ``emb``, then ``blocks[i]``),
from the configuration's own keys: each block's leaves are its family's
(``families/<reference>.py``).  :func:`draw` fills the tree in a few
large calls: one flat buffer a dtype, normal(0, 0.02) in slices of at most
2^30 elements, then the norm scales set to one; each leaf is a view of
its buffer."""
from __future__ import annotations

import math

import torch

from . import spec

VOCAB_PAD = 2048      # the embedding table is padded to a multiple of this
_ALIGN = 64           # elements between leaf offsets (128 bytes in bf16)
_SLICE = 1 << 30


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def layout(cfg: dict) -> list[tuple[tuple, tuple, torch.dtype, str]]:
    """``(path, shape, dtype, init)`` for every leaf, ``init`` ``"normal"``
    or ``"ones"``."""
    pd, d = dtype_of(cfg), cfg["hidden_size"]
    vp = padded_vocab(cfg)
    out = [(("emb", "tok"), (vp, d), pd, "normal"),
           (("emb", "norm_f", "scale"), (d,), pd, "ones")]
    if not cfg["tie_word_embeddings"]:
        out.append((("emb", "unembed"), (d, vp), pd, "normal"))
    fam = spec.family(cfg)
    for i in range(cfg["num_hidden_layers"]):
        out += [(("blocks", i) + path, shape, dt, init)
                for path, shape, dt, init in fam.block_layout(cfg, i, pd)]
    return out


def n_params(cfg: dict) -> int:
    """Parameters of the model, the padded vocabulary rows included."""
    return sum(math.prod(shape) for _, shape, _, _ in layout(cfg))


def _put(tree, path, leaf):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def draw(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    leaves = layout(cfg)
    offsets, total = [], {}
    for _, shape, dt, _ in leaves:
        at = total.get(dt, 0)
        offsets.append(at)
        total[dt] = at + -(-math.prod(shape) // _ALIGN) * _ALIGN
    flat = {}
    for dt in sorted(total, key=str):
        buf = torch.empty(total[dt], dtype=dt, device=device)
        for lo in range(0, total[dt], _SLICE):
            buf[lo:lo + _SLICE].normal_(0.0, 0.02, generator=gen)
        flat[dt] = buf
    tree: dict = {}
    for (path, shape, dt, init), at in zip(leaves, offsets):
        leaf = flat[dt][at:at + math.prod(shape)].view(shape)
        if init == "ones":
            leaf.fill_(1.0)
        _put(tree, path, leaf)
    return tree


def paths(cfg: dict) -> list[tuple]:
    return [p for p, _, _, _ in layout(cfg)]
