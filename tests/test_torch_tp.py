"""Tensor parallelism's layout, its carried-across state, its vocab-parallel
embedding and cross-entropy, and what stays queued on a model axis.

* The port's TP dims (``models/param.py`` ``tree_tp_dims``) against the JAX
  package's ``tree_specs`` for every registered arch at tp 2 and 16, with
  and without ZeRO's "data" dim composed on them (``fsdp_dim``), in
  process.
* The shards that ``state_from_jax`` carries across: smoke qwen1.5-0.5b and
  phi3.5-moe-42b-a6.6b's train state placed by the reference's
  ``state_specs`` on a ("data" 2, "model" 2) mesh of 4 fake CPU devices
  (ZeRO on), each device's shard bit for bit against the port's rank at the
  same (data, model) coordinate.
* The vocab-parallel embedding lookup and chunked cross-entropy on 2
  spawned gloo ranks (each its half of a 64-row table) against the
  reference's ``jnp.take`` and ``chunked_ce_loss`` on the whole table, in
  f32: forward within 1e-6 relative, the gradients of the activations and
  of each rank's block of the table within 1e-5.
* What item 7 of ROADMAP.md's A 6 keeps queued raises ``NotImplementedError``
  naming 'tensor parallelism and the production meshes', in process.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import GLOO_TIMEOUT, spawn
from test_torch_train_step import _load_state

TP_ITEM = "tensor parallelism and the production meshes"
V, D, BT, ST, CHUNK = 64, 8, 2, 12, 5


def _archs() -> list:
    from repro_torch.configs.base import list_archs
    return list_archs()


@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("arch", _archs())
def test_tp_dims_match_reference_specs(arch, tp):
    import repro  # noqa: F401  (installs the JAX shim)
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_model
    from repro.models.param import tree_specs
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_fsdp_dims, tree_tp_dims
    import jax
    ref_defs = ref_model(ref_config(arch)).param_defs()
    defs = build_model(get_config(arch)).param_defs()
    for data in (1, 2):
        specs = jax.tree.leaves(tree_specs(
            ref_defs, fsdp_axes=("data",) if data > 1 else (), fsdp_size=data,
            tp_size=tp), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tdims = flatten(tree_tp_dims(defs, tp))[0]
        fdims = flatten(tree_fsdp_dims(defs, data, tp))[0]
        assert len(specs) == len(tdims)
        for spec, t, f in zip(specs, tdims, fdims):
            want = [None] * len(spec)
            if t is not None:
                want[t] = "model"
            if data > 1 and f is not None:
                want[f] = ("data" if want[f] is None else ("model", "data"))
            assert list(spec) == want, (arch, tp, data, spec, t, f)


_REFERENCE_SHARDS = r"""
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, smoke_config, RunConfig, ShapeConfig, CommConfig, TrainConfig
from repro.launch.mesh import make_local_mesh
from repro.runtime.step import build_train_step

mesh = make_local_mesh(data=2, model=2)
for arch, kv in ARCHS.items():
    cfg = smoke_config(get_config(arch))
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                   comm=CommConfig(autotune=False), train=TrainConfig())
    with jax.set_mesh(mesh):
        b = build_train_step(rc, mesh)
        state0 = b.init_state(0)
        placed = jax.device_put(state0, jax.tree.map(
            lambda s: jax.sharding.NamedSharding(mesh, s), b.state_specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    key = lambda p: jax.tree_util.keystr(p)
    bits = lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    np.savez(f"{OUT}/state0_{arch}.npz", **{
        ("bf16" if np.asarray(a).dtype.name == "bfloat16" else "") + key(p): bits(np.asarray(a))
        for p, a in jax.tree_util.tree_leaves_with_path(state0)})
    for d in range(2):
        for m in range(2):
            dev = mesh.devices[d, m]
            out = {}
            for p, a in jax.tree_util.tree_leaves_with_path(placed):
                shard = [s for s in a.addressable_shards if s.device == dev][0]
                out[key(p)] = bits(np.asarray(shard.data))
            np.savez(f"{OUT}/shards_{arch}_{d}{m}.npz", **out)
print("RESULT:" + json.dumps({"zero": bool(b.zero)}))
"""
SHARD_ARCHS = {"qwen1.5-0.5b": None, "phi3.5-moe-42b-a6.6b": 2}


def test_state_from_jax_carries_the_reference_shards(multidev, tmp_path):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.tree import flatten
    from repro_torch.launch.mesh import PodMesh
    from repro_torch.models import build_model
    from repro_torch.models.param import state_from_jax, tree_fsdp_dims, tree_tp_dims
    head = f"OUT = {str(tmp_path)!r}\nARCHS = {SHARD_ARCHS!r}\n"
    assert multidev(head + _REFERENCE_SHARDS, ndev=4, timeout=300) == {"zero": True}
    for arch, kv in SHARD_ARCHS.items():
        cfg = smoke_config(get_config(arch))
        if kv:
            cfg = dataclasses.replace(cfg, num_kv_heads=kv)
        defs = build_model(cfg).param_defs()
        full = _load_state(str(tmp_path / f"state0_{arch}.npz"))
        for d in range(2):
            for m in range(2):
                mesh = PodMesh(pod=1, data=2, model=2, rank=2 * d + m,
                               device=torch.device("cpu"))
                got = state_from_jax(full, "cpu", mesh=mesh,
                                     dims=tree_fsdp_dims(defs, 2, 2),
                                     tp_dims=tree_tp_dims(defs, 2))
                want = np.load(tmp_path / f"shards_{arch}_{d}{m}.npz")
                names = sorted(want.files)
                leaves = flatten(got)[0]
                assert len(leaves) == len(names)
                for name, x in zip(names, leaves):
                    x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
                    np.testing.assert_array_equal(
                        x.numpy().view(want[name].dtype), want[name],
                        err_msg=f"{arch} ({d}, {m}) {name}")


def _vocab_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(model=2, device="cpu", timeout=GLOO_TIMEOUT)
        tp = L.TensorParallel.of(mesh)
        a = np.load(f"{out}/vocab_inputs.npz")
        half = V // 2
        table = torch.tensor(a["table"][rank * half:(rank + 1) * half], requires_grad=True)
        emb = L.embed_lookup(table, torch.as_tensor(a["tokens"]).long(), tp)
        torch.sum(emb * torch.tensor(a["w"])).backward()
        x = torch.tensor(a["x"], requires_grad=True)
        head = torch.tensor(a["head"][:, rank * half:(rank + 1) * half], requires_grad=True)
        sl, cnt = L.chunked_ce_loss(x, head, torch.as_tensor(a["labels"]).long(),
                                    chunk=CHUNK, tp=tp)
        (sl / cnt).backward()
        np.savez(f"{out}/vocab_rank{rank}.npz", emb=emb.detach().numpy(),
                 g_table=table.grad.numpy(), loss=(sl / cnt).detach().numpy(),
                 g_x=x.grad.numpy(), g_head=head.grad.numpy())
    finally:
        dist.destroy_process_group()


def test_vocab_parallel_embedding_and_cross_entropy_match_reference(tmp_path):
    import jax
    import jax.numpy as jnp

    import repro  # noqa: F401
    from repro.models import layers as RL
    rng = np.random.default_rng(0)
    a = {"table": rng.standard_normal((V, D)).astype(np.float32),
         "tokens": rng.integers(0, V, size=(BT, ST)).astype(np.int32),
         "w": rng.standard_normal((BT, ST, D)).astype(np.float32),
         "x": rng.standard_normal((BT, ST, D)).astype(np.float32),
         "head": rng.standard_normal((D, V)).astype(np.float32),
         "labels": rng.integers(0, V, size=(BT, ST)).astype(np.int32)}
    np.savez(tmp_path / "vocab_inputs.npz", **a)
    spawn(_vocab_rank, 2, (f"file://{tmp_path}/rdv", str(tmp_path)))

    emb, g_table = jax.value_and_grad(
        lambda t: jnp.sum(jnp.take(t, a["tokens"], axis=0) * a["w"]))(a["table"])
    emb = jnp.take(a["table"], a["tokens"], axis=0)

    def ce(x, head):
        sl, cnt = RL.chunked_ce_loss(x, head, jnp.asarray(a["labels"]), chunk=CHUNK)
        return sl / cnt
    loss, (g_x, g_head) = jax.value_and_grad(ce, argnums=(0, 1))(a["x"], a["head"])
    half = V // 2
    for r in range(2):
        got = np.load(tmp_path / f"vocab_rank{r}.npz")
        np.testing.assert_allclose(got["emb"], emb, rtol=1e-6)
        np.testing.assert_allclose(got["g_table"], g_table[r * half:(r + 1) * half],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(got["g_x"], g_x, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["g_head"], g_head[:, r * half:(r + 1) * half],
                                   rtol=1e-5, atol=1e-7)


# -- what stays queued -------------------------------------------------------

def _mesh(pod=1, data=1, model=2):
    """A mesh's shape without its process groups: every refusal below raises
    before a collective."""
    from repro_torch.launch.mesh import PodMesh
    return PodMesh(pod=pod, data=data, model=model, rank=0, device=torch.device("cpu"))


def _rc(arch: str, kv=None, **comm):
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    cfg = smoke_config(get_config(arch))
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    return RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                     comm=CommConfig(autotune=False, **comm), train=TrainConfig())


def _queued_cases() -> dict:
    from repro_torch.core.topology import cosmogrid_topology
    from repro_torch.runtime import ServingEngine, Trainer, build_serve_step
    from repro_torch.runtime.step import build_train_step
    topo = cosmogrid_topology()
    q = "qwen1.5-0.5b"
    return {
        "ssm family": lambda: build_train_step(_rc("mamba2-780m"), _mesh()),
        "hybrid family": lambda: build_train_step(_rc("zamba2-1.2b"), _mesh()),
        "audio family": lambda: build_train_step(_rc("whisper-medium"), _mesh()),
        "vlm family": lambda: build_train_step(_rc("pixtral-12b"), _mesh()),
        "bucket_mb": lambda: build_train_step(_rc(q, bucket_mb=64.0), _mesh(pod=2)),
        "ring": lambda: build_train_step(_rc(q, algo="ring"), _mesh(pod=2)),
        "ring2": lambda: build_train_step(_rc(q, algo="ring2"), _mesh(pod=2)),
        "site groups": lambda: build_train_step(_rc(q), _mesh(pod=4),
                                                site_groups=[[0, 1], [2, 3]]),
        "route": lambda: build_train_step(_rc(q), _mesh(pod=4),
                                          route=topo.route("tokyo", "espoo")),
        "local SGD": lambda: build_train_step(_rc(q, local_steps=4), _mesh(pod=2),
                                              local_only=True),
        "batch/seq attention": lambda: build_train_step(_rc("llama3.2-3b"), _mesh()),
        "checkpoints": lambda: Trainer(_rc(q), _mesh(), ckpt_dir="/nonexistent"),
        "chaos": lambda: Trainer(_rc(q), _mesh(), chaos=object()),
        "membership": lambda: Trainer(_rc(q), _mesh(), membership=object()),
        "online autotuning": lambda: Trainer(_rc(q), _mesh(), autotune_every=2),
        "serving engine": lambda: ServingEngine(_rc(q), mesh=_mesh(), device="cpu"),
        "seq-sharded cache": lambda: build_serve_step(_rc("llama3.2-3b"), "decode",
                                                      mesh=_mesh()),
        "serving over data ranks": lambda: build_serve_step(_rc(q), "decode",
                                                            mesh=_mesh(data=2)),
    }


@pytest.mark.parametrize("case", list(_queued_cases()))
def test_what_stays_queued_on_a_model_axis_raises_naming_its_item(case):
    with pytest.raises(NotImplementedError, match=TP_ITEM):
        _queued_cases()[case]()
