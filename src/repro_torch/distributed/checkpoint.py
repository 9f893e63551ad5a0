"""Checkpointing with atomic commit and restore, after
``repro/distributed/checkpoint.py``, in its layout:

    ckpt_dir/step_00000123/
        manifest.json          # step, host count, keys, shapes, dtypes, extra
        shard_h000.npz         # this host's leaves
    ckpt_dir/step_00000123.COMMIT   # empty marker written last

A step is written into a temporary directory, published with one
``os.replace`` and then marked committed, so a crashed write leaves no
half checkpoint: restore picks the newest committed step.  The data
cursor rides in the manifest's ``extra``, so a restart replays the same
batches.  Keys are the reference's: the ``/``-joined dict keys and list
indices of each leaf, in its order.

numpy has no bfloat16: a bf16 leaf is stored as its raw 16 bits (int16)
and named ``"bfloat16"`` in the manifest's ``dtypes``, and viewed back on
restore, so every dtype round-trips bit for bit.  An fp32 checkpoint is
the reference's byte for byte, and each package restores the other's.
One process writes host 0's shard (``torch.distributed``'s rank and world
size where it is initialised).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]

_BF16 = "bfloat16"


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _host() -> tuple[int, int]:
    """(this process's index, the process count)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """{key: host array} and {key: dtype name}; bf16 leaves as int16."""
    flat, dtypes = {}, {}
    for path, leaf in tree_paths(tree):
        key = _key(path)
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key], dtypes[key] = t.view(torch.int16).numpy(), _BF16
        else:
            flat[key] = t.numpy()
            dtypes[key] = str(flat[key].dtype)
    return flat, dtypes


def save_checkpoint(ckpt_dir: str, step: int, state: dict,
                    extra: dict | None = None) -> str:
    """state: tree of tensors (params, optimizer state).  extra: JSON
    metadata (data cursor, ...).  Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".{name}.tmp")
    try:
        flat, dtypes = _flatten(state)
        host, n_hosts = _host()
        np.savez(os.path.join(tmp, f"shard_h{host:03d}.npz"), **flat)
        manifest = {
            "step": step,
            "n_hosts": n_hosts,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        open(final + ".COMMIT", "w").close()        # commit marker
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for n in os.listdir(ckpt_dir):
        if n.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, n) + ".COMMIT"):
            steps.append(int(n.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, state_like, step: int | None = None):
    """Restore into the structure of ``state_like``: each leaf takes its
    like's shape, dtype and device.  Returns (state, extra) or (None,
    None) when nothing is committed."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat: dict[str, np.ndarray] = {}
    for n in sorted(os.listdir(d)):
        if n.startswith("shard_") and n.endswith(".npz"):
            with np.load(os.path.join(d, n)) as z:
                for k in z.files:
                    flat[k] = z[k]
    leaves = []
    for path, like in tree_paths(state_like):
        key = _key(path)
        t = torch.from_numpy(np.ascontiguousarray(flat[key]))
        if manifest["dtypes"].get(key) == _BF16:
            t = t.view(torch.bfloat16)
        leaves.append(t.to(device=like.device, dtype=like.dtype)
                      .reshape(like.shape))
    return tree_unflatten(state_like, leaves), manifest["extra"]
