"""The port's checkpoint store, manager and the Trainer's checkpoints against
the JAX package's on-disk format.

* ``store.save`` of the same tree (bf16, f32, int32 and empty leaves in
  nested dicts, leaves cut into several chunk files) writes
  **byte-identical** files in both packages, ``manifest.json`` included;
  each package restores the other's checkpoint bit for bit.
* The train state: the reference's initial state of the smoke
  qwen1.5-0.5b, saved by each package, gives byte-identical checkpoints,
  and the leaf names and order the port's ``Trainer`` restores by are the
  reference's (JAX's flatten order sorts dict keys).
* The port's ``CheckpointManager``: ``keep`` and the prune, the restore from
  the replica once the primary is gone (the reference's
  ``test_manager_restores_from_replica_after_primary_loss``), and the
  fallback to the primary's newest step.
* ZeRO: a ``Trainer`` on 2 pods x 2 data ranks (4 spawned gloo ranks, rank
  0 writing the shards its pod gathered) restored on 2 pods x 1 data rank
  and again on 2 x 2: every restored leaf is the saved full leaf or this
  rank's block of it, bit for bit.

Every file lives under ``tmp_path``; spawned ranks give gloo a 120 s
timeout and are joined with a deadline.
"""
from __future__ import annotations

import json
import os
import shutil
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import spawn

GLOO_TIMEOUT = timedelta(seconds=120)


def _np_tree():
    """The tree both packages save: numpy leaves (bf16 as ml_dtypes')."""
    import ml_dtypes
    rng = np.random.default_rng(5)
    return {"params": {"w": rng.standard_normal((7, 300)).astype(ml_dtypes.bfloat16),
                       "b": rng.standard_normal(900).astype(np.float32)},
            "opt": {"step": np.array(7, np.int32),
                    "m": {"w": rng.standard_normal((7, 300)).astype(np.float32)}},
            "empty": np.zeros((0, 3), np.float32),
            "list": [np.arange(5, dtype=np.int32), np.ones((2, 2), np.float32)]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _files(d: str) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_store_save_is_byte_identical_to_reference(tmp_path):
    from repro.checkpoint import store as ref
    from repro_torch.checkpoint import store
    ref.save(_np_tree(), str(tmp_path / "ref"), step=3, chunk_mb=0.001)
    store.save(_to_torch(_np_tree()), str(tmp_path / "port"), step=3, chunk_mb=0.001)
    want, got = _files(str(tmp_path / "ref")), _files(str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    assert "leaf00003_c0008.bin" in got          # a leaf in several chunk files
    for name in want:
        assert got[name] == want[name], name
    names = [e["name"] for e in json.loads(got["manifest.json"])["leaves"]]
    assert names == ["empty", "list/0", "list/1", "opt/m/w", "opt/step",
                     "params/b", "params/w"]


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_restores_the_others_checkpoint(tmp_path, writer):
    from repro.checkpoint import store as ref
    from repro_torch.checkpoint import store
    d = str(tmp_path / "ck")
    if writer == "repro":
        ref.save(_np_tree(), d, step=11, chunk_mb=0.001)
        like = _to_torch(_np_tree())
        got, manifest = store.restore(d, like)
        got = {n: _as_np(t) for n, t in store.leaf_paths(got)}
    else:
        store.save(_to_torch(_np_tree()), d, step=11, chunk_mb=0.001)
        got, manifest = ref.restore(d, _np_tree())
        got = {n: _ref_np(a) for n, a in store.leaf_paths(got)}
    assert manifest["step"] == 11
    want = {n: _ref_np(a) for n, a in store.leaf_paths(_np_tree())}
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_store_restore_places_each_leaf(tmp_path):
    from repro_torch.checkpoint import store
    d = str(tmp_path / "ck")
    store.save(_to_torch(_np_tree()), d, chunk_mb=0.001)
    seen = []

    def place(name, t):
        seen.append(name)
        return t.narrow(0, 0, 1) if name == "params/w" else t
    got, _ = store.restore(d, _to_torch(_np_tree()), place=place, streams=2)
    assert sorted(seen) == sorted(n for n, _ in store.leaf_paths(_np_tree()))
    assert tuple(got["params"]["w"].shape) == (1, 300)


_REF_STATE = r"""
import json, sys
import numpy as np
import jax
from repro.checkpoint import store
from repro.configs import get_config, smoke_config
from repro.models import build_model
from repro.models.param import tree_init
from repro.optim import init_opt_state
cfg = smoke_config(get_config("qwen1.5-0.5b"))
params = tree_init(build_model(cfg).param_defs(), 0)
state = {"params": params, "opt": init_opt_state(params)}
flat = {}
for kp, a in jax.tree_util.tree_leaves_with_path(state):
    a = np.asarray(a)
    key = jax.tree_util.keystr(kp)
    flat[("bf16" if a.dtype.name == "bfloat16" else "") + key] = (
        a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
np.savez(f"{OUT}/state0.npz", **flat)
store.save(state, f"{OUT}/ref_ckpt", step=0, chunk_mb=0.05)
print("RESULT:" + json.dumps({"n": len(flat)}))
"""


def test_train_state_checkpoint_matches_reference(multidev, tmp_path):
    """The reference's smoke train state saved by both packages: the same
    bytes, and the port's Trainer names the leaves as the reference does."""
    from test_torch_train_step import _load_state
    from repro_torch.checkpoint import store
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime import Trainer
    out = str(tmp_path)
    multidev(f"OUT = {out!r}\n" + _REF_STATE, ndev=1, timeout=300)
    state = state_from_jax(_load_state(f"{out}/state0.npz"), "cpu")
    store.save(state, f"{out}/port_ckpt", step=0, chunk_mb=0.05)
    want, got = _files(f"{out}/ref_ckpt"), _files(f"{out}/port_ckpt")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    rc = RunConfig(model=smoke_config(get_config("qwen1.5-0.5b")),
                   shape=ShapeConfig("t", 32, 2, "train"),
                   comm=CommConfig(mode="hierarchical", autotune=False),
                   train=TrainConfig())
    shutil.copytree(f"{out}/ref_ckpt", f"{out}/dir/step_00000000")
    tr = Trainer(rc, make_local_mesh(device="cpu"), ckpt_dir=f"{out}/dir")
    manifest = store.load_manifest(f"{out}/ref_ckpt")
    assert [n for n, _ in store.leaf_paths(tr._like())] == [
        e["name"] for e in manifest["leaves"]]
    assert tr.init_or_restore() == "restored" and tr.step == 0
    for (n, a), (m, b) in zip(store.leaf_paths(tr.state), store.leaf_paths(state)):
        assert n == m and torch.equal(a, b), n
    tr.close()


def test_manager_keep_prunes_the_oldest(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (2, 4, 6, 8):
        mgr.save(step, {"w": torch.full((3,), float(step))}, block=step % 4 == 0)
    mgr.wait()
    assert mgr.steps() == [6, 8] and mgr.latest_step() == 8
    got, manifest = mgr.restore({"w": None})
    assert manifest["step"] == 8 and torch.equal(got["w"], torch.full((3,), 8.0))
    got, _ = mgr.restore({"w": None}, step=6)
    assert torch.equal(got["w"], torch.full((3,), 6.0))
    assert [t["step"] for t in mgr.timings] == [2, 4, 6, 8]
    assert all(t["write_s"] >= 0 for t in mgr.timings)
    mgr.close()


def test_manager_restores_from_replica_after_primary_loss(tmp_path):
    """Whole-pod loss: the primary checkpoint dir is gone, the DataGather
    replica is what the restart restores from (the reference's test)."""
    from repro_torch.checkpoint import CheckpointManager, store
    from repro_torch.core.filetransfer import PART_SUFFIX, SIDECAR_SUFFIX
    primary, replica = str(tmp_path / "ckpt"), str(tmp_path / "replica")
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": torch.ones(3)}
    mgr = CheckpointManager(primary, replica_dir=replica)
    mgr.save(10, state)
    mgr.replicate_now()
    assert os.path.isdir(os.path.join(replica, "step_00000010"))
    mgr.close()
    shutil.rmtree(primary)
    mgr2 = CheckpointManager(primary, replica_dir=replica)
    assert mgr2.latest_step() is None
    assert mgr2.has_checkpoint()
    restored, manifest = mgr2.restore({"w": None, "b": None})
    assert manifest["step"] == 10
    assert torch.equal(restored["w"], state["w"])
    mgr2.close()
    step_dir = os.path.join(replica, "step_00000010")
    assert os.path.exists(os.path.join(step_dir, store.MANIFEST))
    assert not [f for f in os.listdir(step_dir)
                if f.endswith((PART_SUFFIX, SIDECAR_SUFFIX))]


def test_manager_without_checkpoints_raises(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"), replica_dir=str(tmp_path / "r"))
    assert not mgr.has_checkpoint()
    with pytest.raises(FileNotFoundError, match="no checkpoints under"):
        mgr.restore({"w": None})


# -- ZeRO: a 2 x 2 save restored at 2 x 1 and at 2 x 2 --------------------------

def _zero_rank(rank: int, world: int, data: int, init: str, out: str,
               phase: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.checkpoint.store import leaf_paths
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import Trainer
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=2, data=data, device="cpu", timeout=GLOO_TIMEOUT)
        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                       comm=CommConfig(mode="hierarchical", compress="int8",
                                       streams=2, chunk_mb=0.01, autotune=False),
                       train=TrainConfig(warmup_steps=1, total_steps=10, lr=1e-3))
        tr = Trainer(rc, mesh, ckpt_dir=f"{out}/ck")
        how = tr.init_or_restore(0)
        if phase == "save":
            data_it = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                               global_batch=4), prefetch=0)
            tr.run(data_it, 1, log_every=0)
        res = {"how": how, "step": tr.step, "zero": tr.bundle.zero,
               "dims": {n: d for n, d in leaf_paths(tr.bundle.dims)} if tr.bundle.zero
               else None}
        np.savez(f"{out}/{phase}_rank{rank}.npz",
                 **{n: _as_np(t) for n, t in leaf_paths(tr.state)})
        tr.close()
        with open(f"{out}/{phase}_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_zero_save_restores_on_another_mesh(tmp_path):
    from repro_torch.checkpoint import store
    out = str(tmp_path)
    spawn(_zero_rank, 4, (4, 2, f"file://{out}/rdv_s", out, "save"))
    spawn(_zero_rank, 2, (2, 1, f"file://{out}/rdv_1", out, "x1"))
    spawn(_zero_rank, 4, (4, 2, f"file://{out}/rdv_2", out, "x2"))
    saved = [json.load(open(f"{out}/save_rank{r}.json")) for r in range(4)]
    assert all(s["zero"] and s["step"] == 1 and s["how"] == "initialized" for s in saved)
    d = os.path.join(out, "ck", "step_00000001")
    full, manifest = store.restore(d, {e["name"]: None for e in store.load_manifest(d)["leaves"]})
    full = {n: _as_np(t) for n, t in full.items()}
    dims = saved[0]["dims"]

    def block(name, a, index):
        # "params/<leaf>", "opt/m/<leaf>", "opt/v/<leaf>" scatter as <leaf>
        leaf = name.split("/", 1 if name.startswith("params/") else 2)[-1]
        dim = None if name == "opt/step" else dims.get(leaf)
        if dim is None:
            return a
        n = a.shape[dim] // 2
        return np.take(a, range(index * n, (index + 1) * n), axis=dim)

    # the 2 x 2 ranks held blocks of what rank 0 wrote; both pods the same
    for r in range(4):
        shards = np.load(f"{out}/save_rank{r}.npz")
        for name in full:
            np.testing.assert_array_equal(shards[name], block(name, full[name], r % 2),
                                          err_msg=f"{name} rank {r}")
    for phase, world in (("x1", 2), ("x2", 4)):
        for r in range(world):
            res = json.load(open(f"{out}/{phase}_rank{r}.json"))
            assert res["how"] == "restored" and res["step"] == 1, (phase, res)
            got = np.load(f"{out}/{phase}_rank{r}.npz")
            for name in full:
                want = full[name] if phase == "x1" else block(name, full[name], r % 2)
                np.testing.assert_array_equal(got[name], want, err_msg=f"{phase} {name}")
