"""The port's distribution substrate against the JAX package's, on the CPU:
checkpoints (round trip, commit marker, bf16 bit for bit, the manifest
and the files each package restores from the other), the fault-tolerance
primitives, int8 gradient compression with error feedback, and the
training launcher's restart.

Checkpoints and the codec are compared bit for bit; the compression's
residuals within 1e-7 (one fp32 rounding of values of ~1e-2); the
restarted losses within rtol 1e-6, as the reference's own test.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.checkpoint import \
    restore_checkpoint as r_restore_checkpoint
from repro.distributed.checkpoint import save_checkpoint as r_save_checkpoint
from repro.distributed.compression import compress_grads as r_compress_grads
from repro.distributed.compression import init_residuals as r_init_residuals
from repro_torch.distributed import (HeartbeatMonitor, HostState,
                                     StragglerDetector, compress_grads,
                                     decompress_grads, init_residuals,
                                     latest_step, plan_elastic_mesh,
                                     restore_checkpoint, save_checkpoint)
from repro_torch.tree import tree_leaves, tree_paths

RESIDUAL_TOL = 1e-7


def _state(rng, dtype=torch.float32):
    """A params + optimizer-state tree like the launcher's."""
    def x(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return {"params": {"emb": {"tok": x(8, 4)},
                       "blocks": [{"w": x(4, 4), "b": x(4)},
                                  {"w": x(4, 4), "b": x(4)}]},
            "opt": {"m": {"w": torch.zeros(3, 2)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _equal_trees(a, b):
    pa, pb = list(tree_paths(a)), list(tree_paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


# ----------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip(tmp_path, rng):
    """tests/test_distributed.py's round trip, on the port's tensors."""
    state = _state(rng)
    save_checkpoint(str(tmp_path), 7, state, extra={"cursor": 7})
    save_checkpoint(str(tmp_path), 9, state, extra={"cursor": 9})
    assert latest_step(str(tmp_path)) == 9
    like = {"params": {"emb": {"tok": torch.zeros(8, 4)},
                       "blocks": [{"w": torch.zeros(4, 4),
                                   "b": torch.zeros(4)}] * 2},
            "opt": {"m": {"w": torch.ones(3, 2)},
                    "step": torch.tensor(0, dtype=torch.int32)}}
    restored, extra = restore_checkpoint(str(tmp_path), like)
    assert extra["cursor"] == 9
    _equal_trees(restored, state)
    assert os.path.exists(os.path.join(str(tmp_path), "step_00000009",
                                       "shard_h000.npz"))
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_checkpoint_uncommitted_ignored(tmp_path):
    state = {"x": torch.ones(3)}
    d = save_checkpoint(str(tmp_path), 5, state, extra={})
    os.remove(d + ".COMMIT")                   # simulate crash pre-commit
    assert latest_step(str(tmp_path)) is None
    r, extra = restore_checkpoint(str(tmp_path), state)
    assert r is None and extra is None
    assert latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_bf16_round_trip_is_bit_exact(tmp_path, rng):
    """bf16 leaves stored as their raw 16 bits, named "bfloat16" in the
    manifest, viewed back on restore; fp32 and int32 leaves beside them."""
    state = _state(rng, torch.bfloat16)
    state["params"]["blocks"][0]["w"][0, 0] = float("-inf")
    state["params"]["blocks"][0]["w"][0, 1] = -0.0
    d = save_checkpoint(str(tmp_path), 3, state, extra={"cursor": 3})
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["params/emb/tok"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"
    assert manifest["dtypes"]["opt/m/w"] == "float32"
    like = _state(np.random.default_rng(1), torch.bfloat16)
    restored, _ = restore_checkpoint(str(tmp_path), like)
    _equal_trees(restored, state)


def test_checkpoint_manifest_is_the_references(tmp_path, rng):
    """The same fp32 tree through both packages: the same keys, shapes,
    dtypes, step, host count and extra, and the same arrays."""
    state = _state(rng)
    ref_state = {"params": {"emb": {"tok": state["params"]["emb"]["tok"]
                                    .numpy()},
                            "blocks": [{k: v.numpy() for k, v in b.items()}
                                       for b in state["params"]["blocks"]]},
                 "opt": {"m": {"w": state["opt"]["m"]["w"].numpy()},
                         "step": np.int32(7)}}
    mine = save_checkpoint(str(tmp_path / "port"), 4, state,
                           extra={"cursor": 4})
    theirs = r_save_checkpoint(str(tmp_path / "ref"), 4, ref_state,
                               extra={"cursor": 4})
    manifests = []
    for d in (mine, theirs):
        with open(os.path.join(d, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert manifests[0]["keys"] == sorted(
        "/".join(str(k) for k in p) for p, _ in tree_paths(state))
    with np.load(os.path.join(mine, "shard_h000.npz")) as a, \
            np.load(os.path.join(theirs, "shard_h000.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_each_package_restores_the_others_fp32_checkpoint(tmp_path, rng):
    state = _state(rng)
    ref_like = {"params": {"emb": {"tok": np.zeros((8, 4), np.float32)},
                           "blocks": [{"w": np.zeros((4, 4), np.float32),
                                       "b": np.zeros(4, np.float32)}] * 2},
                "opt": {"m": {"w": np.zeros((3, 2), np.float32)},
                        "step": np.int32(0)}}
    save_checkpoint(str(tmp_path / "port"), 2, state, extra={"cursor": 2})
    got, extra = r_restore_checkpoint(str(tmp_path / "port"), ref_like)
    assert extra == {"cursor": 2}
    for (_, a), (_, b) in zip(tree_paths(got), tree_paths(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    r_save_checkpoint(str(tmp_path / "ref"), 5, got, extra={"cursor": 5})
    like = _state(np.random.default_rng(2))
    back, extra = restore_checkpoint(str(tmp_path / "ref"), like)
    assert extra == {"cursor": 5}
    _equal_trees(back, state)


# -------------------------------------------------------- fault tolerance
def test_heartbeat_detects_dead_host():
    clock = [0.0]
    hb = HeartbeatMonitor(n_hosts=3, timeout_s=10, clock=lambda: clock[0])
    for h in range(3):
        hb.beat(h, 1)
    clock[0] = 5.0
    hb.beat(0, 2)
    hb.beat(1, 2)
    clock[0] = 12.0
    assert hb.dead_hosts() == [2]
    assert not hb.all_alive()
    assert hb.hosts[0] == HostState(last_beat=5.0, step=2, alive=True)
    assert hb.hosts[2].alive is False


def test_straggler_detector_flags_persistent_outlier():
    det = StragglerDetector(n_hosts=4, k=3.0, patience=2)
    times = [1.0, 1.01, 0.99, 1.0]
    assert det.observe(times) == []
    slow = [1.0, 1.02, 0.98, 3.0]
    assert det.observe(slow) == []
    assert det.observe(slow) == [3]
    assert det.observe(times) == []              # the strikes reset


def test_elastic_mesh_preserves_tp():
    plan = plan_elastic_mesh(n_hosts_alive=120, chips_per_host=4,
                             model_parallel=16)
    assert plan["model"] == 16
    assert plan["pod"] * plan["data"] * plan["model"] == plan["chips_used"]
    assert plan["chips_used"] <= 480
    with pytest.raises(ValueError, match="model axis"):
        plan_elastic_mesh(n_hosts_alive=1, chips_per_host=4,
                          model_parallel=8)


# ------------------------------------------------------------ compression
def test_gradient_compression_error_feedback():
    """int8 EF compression: accumulated updates converge to the true sum
    (tests/test_distributed.py's test, on the port)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(
        (rng.standard_normal((64, 64)) * 0.01).astype(np.float32))
    res = init_residuals({"w": g_true})
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        q, s, res = compress_grads({"w": g_true}, res)
        assert q["w"].dtype == torch.int8
        acc = acc + decompress_grads(q, s)["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(),
                               atol=2e-4)


def test_compression_residuals_are_the_references(rng):
    """Five error-feedback steps on a tree of bf16 and fp32 gradients:
    the int8 codes and scales bit for bit, the residuals within 1e-7."""
    grads = [{"a": rng.standard_normal((16, 8)).astype(np.float32) * 0.01,
              "b": [rng.standard_normal(5).astype(np.float32)]}
             for _ in range(5)]
    tgrads = [{"a": torch.from_numpy(g["a"]).to(torch.bfloat16),
               "b": [torch.from_numpy(g["b"][0])]} for g in grads]
    jgrads = [{"a": jnp.asarray(t["a"].float().numpy()).astype(jnp.bfloat16),
               "b": [jnp.asarray(g["b"][0])]} for t, g in zip(tgrads, grads)]
    res, rres = init_residuals(tgrads[0]), r_init_residuals(jgrads[0])
    for tg, jg in zip(tgrads, jgrads):
        q, s, res = compress_grads(tg, res)
        rq, rs, rres = r_compress_grads(jg, rres)
        for a, b in zip(tree_leaves(q), tree_leaves(rq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(s), tree_leaves(rs)):
            assert float(a) == float(b)
        for a, b in zip(tree_leaves(res), tree_leaves(rres)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=0, atol=RESIDUAL_TOL)


# ------------------------------------------------------------- the launcher
BASE = ["--arch", "smollm-360m", "--smoke", "--batch", "2", "--seq", "32",
        "--log-every", "100", "--device", "cpu"]


def test_train_restart_reproduces_the_uninterrupted_losses(tmp_path, capsys):
    """tests/test_distributed.py's restart test, on the port: 6 steps
    against 3, a checkpoint, and a restart from it (rtol 1e-6, as the
    reference's)."""
    from repro_torch.launch.train import main as train_main
    l_full = train_main(BASE + ["--steps", "6"])
    ck = str(tmp_path / "ck")
    train_main(BASE + ["--steps", "6", "--stop-at", "3", "--ckpt-dir", ck,
                       "--ckpt-every", "3"])
    l_resumed = train_main(BASE + ["--steps", "6", "--ckpt-dir", ck,
                                   "--ckpt-every", "100"])
    assert "[train] restored step 3" in capsys.readouterr().out
    assert len(l_resumed) == 3
    np.testing.assert_allclose(l_full[3:], l_resumed, rtol=1e-6)


def test_train_twenty_steps_improve(capsys):
    from repro_torch.launch.train import main as train_main
    losses = train_main(BASE + ["--steps", "20", "--log-every", "10"])
    out = capsys.readouterr().out
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert "[train] step 10 loss" in out and "[train] step 20 loss" in out
    assert "(improved)" in out


def test_train_with_accumulation_matches_the_whole_batch(tmp_path):
    """``--accum 2`` splits each batch in two: the same losses as the whole
    batch within fp32 summation noise."""
    from repro_torch.launch.train import main as train_main
    whole = train_main(BASE + ["--steps", "3"])
    split = train_main(BASE + ["--steps", "3", "--accum", "2"])
    np.testing.assert_allclose(whole, split, rtol=1e-5)
