"""The in-pod stages on 4 gloo ranks (2 pods x 2 data ranks) against the JAX
package's on a (pod 2, data 2) mesh of 4 fake CPU devices, bit for bit; the
ZeRO-3 gather at use against the reference's ``_ag_use`` on 2 data ranks;
and the gather hook inside the per-block checkpoint.

The reference's shard_maps run outside ``jax.jit``, op by op, as in
``test_torch_train_comm.py``.  With two ranks a group every sum is one IEEE
addition per element, which commutes, so the port's in-pod stages (rank-order
sums through host copies) and the cross-pod psum give the reference's bits:
``hierarchical_allreduce`` with and without ``keep_scattered`` (a leaf that
does not split over the data ranks, and one with no dim, psummed over data
instead) and ``gateway_allreduce``, with no codec and with int8 on the wire.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

# leaf -> (shape, scatter dim, scale): "e" (7 columns) does not split over 2
# data ranks, "c" has no dim
LEAVES = {"a": ((96, 300), 0, 3.0), "b": ((4, 130, 64), 1, 1.0),
          "c": ((2000,), None, 1e3), "e": ((5, 7), 1, 0.5)}
COMM = dict(streams=3, chunk_mb=0.0625, pacing=0.5, autotune=False)
# case -> (function, codec, keep_scattered)
CASES = {"hier-none": ("hierarchical", "none", False),
         "hier-int8": ("hierarchical", "int8", False),
         "hier-kept": ("hierarchical", "none", True),
         "hier-kept-int8": ("hierarchical", "int8", True),
         "gateway-none": ("gateway", "none", False),
         "gateway-int8": ("gateway", "int8", False)}
AG_SHAPE, AG_DIM = (6, 10, 4), 1


def _rank_leaves(rank: int) -> dict:
    rng = np.random.default_rng(200 + rank)
    return {k: (rng.standard_normal(shape) * scale).astype(np.float32)
            for k, (shape, _, scale) in LEAVES.items()}


def _dims() -> dict:
    return {k: d for k, (_, d, _) in LEAVES.items()}


def _ag_inputs(rank: int):
    """Data rank `rank`'s bf16 shard (as f32 values) and a full-shape f32
    cotangent."""
    import ml_dtypes
    rng = np.random.default_rng(300 + rank)
    shard = list(AG_SHAPE)
    shard[AG_DIM] //= 2
    x = rng.standard_normal(shard).astype(ml_dtypes.bfloat16).astype(np.float32)
    ct = rng.standard_normal(AG_SHAPE).astype(np.float32)
    return x, ct


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
from repro.core.collectives import gateway_allreduce, hierarchical_allreduce
from repro.core.path import WidePath
from repro.runtime.step import _ag_use
sys.path.insert(0, TESTS)
from test_torch_train_inpod import AG_DIM, CASES, COMM, _ag_inputs, _dims, _rank_leaves

mesh = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
ranks = [_rank_leaves(r) for r in range(4)]
glob = {k: jnp.asarray(np.concatenate([ranks[r][k] for r in range(4)], 0)) for k in ranks[0]}
for name, (fn, c, keep) in CASES.items():
    path = WidePath(axis="pod", comm=CommConfig(compress=c, **COMM), name="tinpod")
    if fn == "hierarchical":
        body = lambda t: hierarchical_allreduce(t, path, ("data",), _dims(),
                                                keep_scattered=keep)
    else:
        body = lambda t: gateway_allreduce(t, path, ("data",))
    f = jax.shard_map(body, mesh=mesh, in_specs=(P(("pod", "data")),),
                      out_specs=P(("pod", "data")), axis_names={"pod", "data"},
                      check_vma=False)
    with jax.set_mesh(mesh):
        out = f(glob)      # outside jit: op by op
    np.savez(f"{OUT}/ref_{name}.npz", **{k: np.asarray(v) for k, v in out.items()})

dmesh = jax.make_mesh((2,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
xs, cts = zip(*[_ag_inputs(r) for r in range(2)])
gx = jnp.asarray(np.concatenate(xs, 0)).astype(jnp.bfloat16)
gct = jnp.asarray(np.concatenate(cts, 0))

def ag_body(x, ct):
    y, vjp = jax.vjp(lambda v: _ag_use(v, AG_DIM), x)
    (dx,) = vjp(ct.astype(y.dtype))
    return y, dx

f = jax.shard_map(ag_body, mesh=dmesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"), P("data")), axis_names={"data"},
                  check_vma=False)
with jax.set_mesh(dmesh):
    y, dx = f(gx, gct)
np.savez(f"{OUT}/ref_ag.npz", y=np.asarray(y.astype(jnp.float32)),
         dx=np.asarray(dx.astype(jnp.float32)))
print("RESULT:" + json.dumps({"ok": True}))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core.collectives import (gateway_allreduce,
                                              hierarchical_allreduce)
    from repro_torch.core.path import WidePath
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.step import AllGatherAtUse
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    try:
        mesh = make_local_mesh(pod=2, data=2, device="cpu")
        assert (mesh.pod_index, mesh.data_index) == divmod(rank, 2)
        mine = {k: torch.from_numpy(v) for k, v in _rank_leaves(rank).items()}
        for name, (fn, c, keep) in CASES.items():
            path = WidePath(axis="pod", comm=CommConfig(compress=c, **COMM),
                            name="tinpod")
            if fn == "hierarchical":
                got = hierarchical_allreduce(mine, path, mesh, _dims(),
                                             keep_scattered=keep)
            else:
                got = gateway_allreduce(mine, path, mesh)
            np.savez(f"{out}/port_{name}_rank{rank}.npz",
                     **{k: v.numpy() for k, v in got.items()})
        # the gather at use over this pod's data group
        x_np, ct_np = _ag_inputs(mesh.data_index)
        x = torch.from_numpy(x_np).to(torch.bfloat16).requires_grad_(True)
        y = AllGatherAtUse.apply(x, AG_DIM, mesh.data_group, None)
        (dx,) = torch.autograd.grad(y, x, torch.from_numpy(ct_np).to(y.dtype))
        assert dx.dtype == torch.bfloat16
        np.savez(f"{out}/port_ag_rank{rank}.npz", y=y.detach().float().numpy(),
                 dx=dx.float().numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tinpod")
    tests = os.path.dirname(os.path.abspath(__file__))
    multidev(f"TESTS = {tests!r}\nOUT = {str(out)!r}\n" + _REFERENCE, ndev=4,
             timeout=600)
    torch.multiprocessing.start_processes(
        _port_rank, args=(f"file://{out}/rdv", str(out)), nprocs=4, join=True,
        start_method="spawn")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_inpod_stages_bit_identical_to_reference(runs, case):
    out = runs
    ref = np.load(f"{out}/ref_{case}.npz")
    keep = CASES[case][2]
    for name, (shape, d, _) in LEAVES.items():
        blocks = np.split(ref[name], 4, axis=0)   # rank r's output, r = pod*2 + data
        scattered = keep and d is not None and shape[d] % 2 == 0
        for r in range(4):
            got = np.load(f"{out}/port_{case}_rank{r}.npz")[name]
            want = blocks[r]
            assert got.dtype == np.float32 and got.shape == want.shape, (case, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{case} {name} rank {r}")
            if scattered:
                assert got.shape[d] == shape[d] // 2
            else:
                assert got.shape == shape
        # the two pods end with the same bits; without a kept shard the two
        # data ranks do too
        np.testing.assert_array_equal(blocks[0], blocks[2])
        np.testing.assert_array_equal(blocks[1], blocks[3])
        if not scattered:
            np.testing.assert_array_equal(blocks[0], blocks[1])
    if case == "hier-none":   # the plain sum over the 4 ranks, in f32
        leaves = [_rank_leaves(r)["c"] for r in range(4)]
        got = np.load(f"{out}/port_{case}_rank0.npz")["c"]
        np.testing.assert_allclose(got, sum(leaves), rtol=1e-6, atol=1e-3)


def test_all_gather_at_use_matches_reference_ag_use(runs):
    """Forward: the data ranks' shards tiled along the dim.  Backward: the
    cotangent reduce-scattered in f32 and rounded to the shard's bf16."""
    out = runs
    ref = np.load(f"{out}/ref_ag.npz")
    ys = np.split(ref["y"], 2, axis=0)
    dxs = np.split(ref["dx"], 2, axis=0)
    xs = [_ag_inputs(d)[0] for d in range(2)]
    for r in range(4):
        d = r % 2
        got = np.load(f"{out}/port_ag_rank{r}.npz")
        np.testing.assert_array_equal(got["y"], ys[d])
        np.testing.assert_array_equal(got["y"], np.concatenate(xs, AG_DIM))
        np.testing.assert_array_equal(got["dx"], dxs[d])


def _remat_rank(rank: int, init: str, out: str) -> None:
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.tree import flatten, unflatten
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.models.param import shard_tree, tree_init
    from repro_torch.runtime import step as step_mod
    from repro_torch.sharding import tree_fsdp_dims
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        mesh = make_local_mesh(data=2, device="cpu")
        base = smoke_config(get_config("qwen1.5-0.5b"))
        full = tree_init(build_model(base).param_defs(), 3, device="cpu")
        dims = tree_fsdp_dims(build_model(base).param_defs(), 2, 1)
        shards = shard_tree(full, dims, mesh)
        toks = torch.as_tensor(np.random.default_rng(4 + rank).integers(
            0, base.vocab_size, size=(2, 33)))
        res = {}
        for remat in (False, True):
            model = build_model(dataclasses.replace(base, remat=remat))
            stats = step_mod.inpod_stats()
            layer, top = step_mod._make_gather(model.param_defs(), dims, True,
                                               mesh.data_group, stats)
            leaves, td = flatten(shards)
            ps = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = model.loss(top(unflatten(td, ps)), {"tokens": toks},
                                 gather=layer)
            fwd = stats["gather_n"]
            grads = torch.autograd.grad(loss, ps)
            res[remat] = ([fwd, stats["gather_n"] - fwd, stats["reduce_scatter_n"]],
                          [g.float() for g in grads])
        # the same loss and gradients through the whole leaves, no gather
        leaves, td = flatten(full)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = build_model(base).loss(unflatten(td, ps), {"tokens": toks})
        whole = [g.float() for g in torch.autograd.grad(loss, ps)]
        with open(f"{out}/remat_rank{rank}.json", "w") as f:
            json.dump({"n_layer_leaves": len(flatten(full["blocks"])[0]),
                       "n_top_leaves": len(leaves) - len(flatten(full["blocks"])[0]),
                       "layers": base.num_layers,
                       "calls": {str(k): v[0] for k, v in res.items()},
                       "remat_equal": all(torch.equal(a, b) for a, b in
                                          zip(res[False][1], res[True][1]))}, f)
        torch.save({"zero": res[True][1], "whole": whole,
                    "dims": flatten(dims)[0]}, f"{out}/remat_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_gather_hook_regathers_in_the_checkpoint_recompute(tmp_path):
    """Under ``remat`` the per-block checkpoint's recompute gathers each layer
    again (the forward's gathers, then as many in the backward), with the
    same gradients as without remat; and the ZeRO gradients are the whole
    leaves' gradients summed over the two data ranks, rounded to bf16."""
    torch.multiprocessing.start_processes(
        _remat_rank, args=(f"file://{tmp_path}/rdv", str(tmp_path)), nprocs=2,
        join=True, start_method="spawn")
    reps = [json.load(open(tmp_path / f"remat_rank{r}.json")) for r in range(2)]
    rep0 = reps[0]
    per_fwd = rep0["layers"] * rep0["n_layer_leaves"] + rep0["n_top_leaves"]
    for rep in reps:
        # forward gathers, gathers in the backward, reduce-scatters
        assert rep["calls"]["False"] == [per_fwd, 0, per_fwd]
        assert rep["calls"]["True"] == [per_fwd, per_fwd - rep["n_top_leaves"], per_fwd]
        assert rep["remat_equal"]
    res = [torch.load(tmp_path / f"remat_rank{r}.pt") for r in range(2)]
    for i, d in enumerate(res[0]["dims"]):
        assert d is not None, f"leaf {i}: every leaf of the smoke model scatters"
        # the reference's arithmetic: each rank's bf16 gradient, summed in
        # f32, rounded to bf16; rank r keeps block r
        total = (res[0]["whole"][i].to(torch.bfloat16).float()
                 + res[1]["whole"][i].to(torch.bfloat16).float())
        for r in range(2):
            want = total.chunk(2, dim=d)[r].to(torch.bfloat16).float()
            assert torch.equal(res[r]["zero"][i], want), (i, r)


@pytest.mark.parametrize("data", [2, 4])
def test_zero_init_keeps_the_full_leaves_bits(data):
    """``tree_init`` under ZeRO draws each full leaf from the seed and keeps
    this data index's block: the shards of every data index, gathered, are
    the unsharded init's bits, whatever the data size."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.tree import flatten
    from repro_torch.models import build_model
    from repro_torch.models.param import gather_leaf, shard_leaf, tree_init
    from repro_torch.sharding import tree_fsdp_dims
    defs = build_model(smoke_config(get_config("llama3.2-3b"))).param_defs()
    dims = flatten(tree_fsdp_dims(defs, data, 1))[0]
    full = flatten(tree_init(defs, 5, device="cpu"))[0]
    parts = [flatten(tree_init(defs, 5, device="cpu", dims=tree_fsdp_dims(defs, data, 1),
                               mesh=SimpleNamespace(data=data, data_index=i)))[0]
             for i in range(data)]
    for j, (x, d) in enumerate(zip(full, dims)):
        shards = [p[j] for p in parts]
        assert torch.equal(gather_leaf(shards, d), x)
        for i, sh in enumerate(shards):
            assert torch.equal(sh, shard_leaf(x, d, i, data))
            if d is not None:
                assert sh.shape[d] == x.shape[d] // data
