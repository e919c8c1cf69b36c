"""The port's training step on 2 pods x 1 data rank x 2 model ranks against
the JAX package's, on the CPU: tensor and expert parallelism on the model
axis.

The reference runs ``build_train_step`` on a (pod 2, data 1, model 2) mesh
of 4 fake CPU devices (one subprocess), where GSPMD lays the parameters out
by ``tree_specs`` and inserts the model axis's collectives; the port runs
its ``build_train_step`` on 4 spawned gloo ranks of
``make_local_mesh(pod=2, data=1, model=2)``, rank ``2 * pod + model``, each
from its TP shards of the reference's own initial state
(``state_from_jax(tp_dims=)``), pod p taking rows [2p, 2p + 2) of each
global batch of 4 as ``P(("pod", "data"))`` gives them to the reference.
Cases: smoke qwen1.5-0.5b (MHA, QKV bias, tied embedding) with no codec and
with int8, and smoke phi3.5-moe-42b-a6.6b (experts over the model axis,
``moe_ep`` in the step) with its K/V heads at 2 so that they divide over the
2 model ranks, as at published width (the smoke config's 1 would need the
reference's ``batch``/``seq`` attention modes, which the port queues).  Both
sides run the reference's initial state cast to f32 (parameters and
moments), 3 steps, knobs fixed (``CommConfig(autotune=False)``).

Held: every step's loss within 1e-5 relative and grad norm within 1e-4
relative (the global norm: the sharded leaves' squares summed over the
model ranks).  Every step's gradient of every leaf, each rank's block
against the same block of the reference's, both recovered from AdamW's
first moments (``(m_i - b1 m_{i-1}) / (1 - b1)``: the clipped gradient):
with no codec every element within 1e-4 of the leaf's largest (measured
at most 7.2e-6); with int8 every element within INT8_STEP of it (one int8
step is 1/127 of its block's largest: where a rounding difference
upstream flips an element's rounding, the gradients differ by a step;
measured 8.1e-3) and a share of the elements within 1e-4 per leaf
(GRAD_SHARE, just under what was measured).  After the 3 steps each
rank's block of every parameter against the same block of the
reference's whole leaf: every element within half the reference's largest
update of the leaf (measured at most 0.32, phi's embedding) and a share
of the elements within 1e-4 of the leaf's largest magnitude (PARAM_SHARE
per leaf, just under what was measured; 1 elsewhere).  Not all: AdamW
divides each gradient by its own running magnitude, so where a gradient
is at the level of f32 rounding the update is the rounding's sign.  The
key bias ``bk`` is such a leaf in both packages: its gradient is near
zero in RoPE's slowly rotating dimensions (a shift shared by nearly every
key, which the softmax does not see; 54 % of its elements under 1e-3 of
its largest), so 27 % of its elements end past 1e-4 with no codec while
its gradients agree within 2.8e-6.  The plan noted in telemetry equals
the reference's (of the whole leaves here: the reference's sync on a mesh
without ZeRO is not inside its manual {"model"} shard_map); every step's
chunk count is the plan's, and the model ranks' bytes are the plan's plus
(tp - 1) times the replicated leaves' (each rank moves its part of a
sharded leaf's chunk and all of a replicated one's, as GSPMD's devices
do); the two pods bit-identical after every step; every model rank's loss
equal.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import GLOO_TIMEOUT, spawn
from test_torch_train_step import _load_state

CASES = {"qwen-none": ("qwen1.5-0.5b", "none"),
         "qwen-int8": ("qwen1.5-0.5b", "int8"),
         "phi-none": ("phi3.5-moe-42b-a6.6b", "none")}
# the smoke configs' K/V heads where their 1 would not divide over 2 ranks
KV_HEADS = {"phi3.5-moe-42b-a6.6b": 2}
STEPS = 3
GB, S = 4, 32
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
LEAF_RTOL = 1e-4
INT8_STEP = 1e-2
UPDATE_BOUND = 0.5
# the shares of a leaf's elements within LEAF_RTOL (1 where not listed),
# each just under the worst of the four ranks' and, for the gradients,
# the three steps'
GRAD_SHARE = {"qwen-int8": {"bk": 0.996, "bq": 0.988, "wk": 0.994, "wo": 0.997,
                            "wq": 0.994, "wv": 0.996, "down": 0.996, "gate": 0.996,
                            "up": 0.996, "ln1": 0.998, "ln2": 0.998, "embed": 0.998}}
PARAM_SHARE = {"qwen-none": {"bk": 0.726},
               "qwen-int8": {"bk": 0.996, "bq": 0.988, "wk": 0.9999, "wo": 0.9997,
                             "wq": 0.9999, "down": 0.9997, "gate": 0.9999,
                             "embed": 0.9999},
               "phi-none": {"embed": 0.9998}}
COMM = dict(mode="hierarchical", streams=4, chunk_mb=0.001, autotune=False)
TRAIN = dict(warmup_steps=1, total_steps=10, lr=1e-3)

_REFERENCE = r"""
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from dataclasses import asdict
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke_config, RunConfig, ShapeConfig, CommConfig, TrainConfig
from repro.core import telemetry as tel
from repro.runtime.step import build_train_step

mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {}
toks = np.load(f"{OUT}/tokens.npy")
for name, (arch, codec) in CASES.items():
    cfg = smoke_config(get_config(arch))
    if arch in KV_HEADS:
        cfg = dataclasses.replace(cfg, num_kv_heads=KV_HEADS[arch])
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", S, GB, "train"),
                   comm=CommConfig(compress=codec, **COMM), train=TrainConfig(**TRAIN))
    with jax.set_mesh(mesh):
        b = build_train_step(rc, mesh)
        sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda x: isinstance(x, P))
        state0 = jax.tree.map(lambda a: a.astype(jnp.float32)
                              if jnp.issubdtype(a.dtype, jnp.floating) else a,
                              b.init_state(0))
        def save(state, tag):
            flat = {jax.tree_util.keystr(p): np.asarray(a)
                    for p, a in jax.tree_util.tree_leaves_with_path(state)}
            np.savez(f"{OUT}/{tag}.npz", **flat)
        save(state0, f"state0_{name}")
        state = jax.device_put(state0, sh(b.state_specs))
        rows = []
        for i in range(STEPS):
            batch = {"tokens": jnp.asarray(toks[i], jnp.int32)}
            state, m = b.fn(state, jax.device_put(batch, sh(b.batch_specs)))
            rows.append([float(m[k]) for k in ("loss", "grad_norm", "aux_loss")])
            save(state["opt"]["m"], f"m{i}_{name}")
        save(state["params"], f"params_{name}")
    out[name] = {"rows": rows, "plan": asdict(tel.get_telemetry().path(b.path.key).plan)}
print("RESULT:" + json.dumps(out))
"""


def _config(arch: str):
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config(arch))
    if arch in KV_HEADS:
        cfg = dataclasses.replace(cfg, num_kv_heads=KV_HEADS[arch])
    return cfg


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.tree import flatten
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime.step import build_train_step
    from repro_torch.runtime.train_loop import replica_checksum
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=2, data=1, model=2, device="cpu",
                               timeout=GLOO_TIMEOUT)
        toks = np.load(f"{out}/tokens.npy")
        lb = GB // 2
        res = {"coords": [mesh.pod_index, mesh.data_index, mesh.model_index],
               "model_ranks": mesh.model_ranks()}
        for name, (arch, codec) in CASES.items():
            rc = RunConfig(model=_config(arch), shape=ShapeConfig("t", S, GB, "train"),
                           comm=CommConfig(compress=codec, **COMM),
                           train=TrainConfig(**TRAIN))
            b = build_train_step(rc, mesh)
            state = state_from_jax(_load_state(f"{out}/state0_{name}.npz"), "cpu",
                                   mesh=mesh, tp_dims=b.tp_dims)
            rows, sums, logs, moments = [], [], [], []
            for i in range(STEPS):
                p = mesh.pod_index
                batch = {"tokens": torch.as_tensor(toks[i][p * lb:(p + 1) * lb]).long()}
                state, m = b.fn(state, batch)
                moments += [x.detach().numpy().copy() for x in flatten(state["opt"]["m"])[0]]
                rows.append([float(m[k]) for k in ("loss", "grad_norm", "aux_loss")])
                sums.append(replica_checksum(state["params"]))
                logs.append([len(m["chunks"]), m["wire_bytes"],
                             sum(c["payload_bytes"] for c in m["chunks"])])
            leaves, _ = flatten(state["params"])
            np.savez(f"{out}/port_{name}_rank{rank}.npz",
                     *[x.detach().numpy() for x in leaves])
            np.savez(f"{out}/port_m_{name}_rank{rank}.npz", *moments)
            res[name] = {"rows": rows, "checksums": sums, "logs": logs,
                         "tp_dims": flatten(b.tp_dims)[0],
                         "replicated_bytes": sum(
                             4 * x.numel() for x, t in zip(leaves, flatten(b.tp_dims)[0])
                             if t is None),
                         "plan": tel.get_telemetry().path(b.path.key).plan.__dict__}
        res["seconds"] = time.perf_counter() - t0
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tptrain")
    rng = np.random.default_rng(0)
    np.save(out / "tokens.npy", rng.integers(0, 256, size=(STEPS, GB, S + 1)).astype(np.int32))
    head = (f"OUT = {str(out)!r}\nCASES = {CASES!r}\nKV_HEADS = {KV_HEADS!r}\n"
            f"STEPS = {STEPS}\nGB, S = {GB}, {S}\nCOMM = {COMM!r}\nTRAIN = {TRAIN!r}\n")
    ref = multidev(head + _REFERENCE, ndev=4, timeout=600)
    spawn(_port_rank, 4, (f"file://{out}/rdv", str(out)))
    port = [json.load(open(out / f"port_rank{r}.json")) for r in range(4)]
    return out, ref, port


def test_mesh_rank_order_is_the_reference_mesh(runs):
    """Rank (p * data + d) * model + m, the order of jax.make_mesh's
    devices over ("pod", "data", "model")."""
    _, _, port = runs
    assert [p["coords"] for p in port] == [[0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1]]
    assert [p["model_ranks"] for p in port] == [[0, 1], [0, 1], [2, 3], [2, 3]]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_tracks_reference(runs, case):
    _, ref, port = runs
    want = np.array(ref[case]["rows"])
    for r in range(4):
        got = np.array(port[r][case]["rows"])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL, err_msg=case)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=NORM_RTOL, err_msg=case)
        if case.startswith("phi") and r < 2:
            # the reference's replicated out-spec returns its first
            # device's aux loss (pod 0's), as pod 0's model ranks report
            np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=LOSS_RTOL, err_msg=case)
        # every model rank reports the same loss
        assert got[:, 0].tolist() == [x[0] for x in port[r ^ 1][case]["rows"]]
    sums = [port[r][case]["checksums"] for r in range(4)]
    assert sums[0] == sums[2] and sums[1] == sums[3], sums     # pods bit-identical


def _leaf(name: str) -> str:
    """``['blocks']['attn']['bk']`` -> ``bk``."""
    return name.rsplit("'", 2)[-2]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_updates_every_leaf_as_reference(runs, case):
    from repro_torch.configs import TrainConfig
    from repro_torch.core.tree import flatten
    from repro_torch.launch.mesh import PodMesh
    from repro_torch.models.param import rank_shard
    out, _, port = runs
    b1 = TrainConfig(**TRAIN).beta1
    names = sorted(np.load(out / f"params_{case}.npz").files)
    full = flatten(_load_state(str(out / f"params_{case}.npz")))[0]
    start = flatten(_load_state(str(out / f"state0_{case}.npz"))["params"])[0]
    moments = [flatten(_load_state(str(out / f"m{i}_{case}.npz")))[0] for i in range(STEPS)]
    n = len(names)
    for r in range(4):
        mesh = PodMesh(pod=2, data=1, model=2, rank=r, device=torch.device("cpu"))
        tdims = port[r][case]["tp_dims"]
        got = np.load(out / f"port_{case}_rank{r}.npz")
        got_m = np.load(out / f"port_m_{case}_rank{r}.npz")
        assert len(got.files) == len(full) == len(tdims) == n
        assert len(got_m.files) == STEPS * n
        for i, (w, w0, t) in enumerate(zip(full, start, tdims)):
            tag = f"{case} rank {r} {names[i]}"
            share = GRAD_SHARE.get(case, {}).get(_leaf(names[i]), 1.0)
            prev_ref = prev_got = 0.0
            for step in range(STEPS):
                m_ref = rank_shard(np.asarray(moments[step][i]), None, t, mesh)
                m_got = got_m[f"arr_{step * n + i}"]
                g_ref = (m_ref - b1 * prev_ref) / (1 - b1)
                g_got = (m_got - b1 * prev_got) / (1 - b1)
                prev_ref, prev_got = m_ref, m_got
                scale = np.abs(g_ref).max()
                diff = np.abs(g_got - g_ref)
                bound = INT8_STEP if CASES[case][1] == "int8" else LEAF_RTOL
                assert diff.max() <= bound * scale, (tag, step, diff.max() / scale)
                close = diff <= LEAF_RTOL * scale
                assert close.mean() >= share, (tag, step, close.mean())
            want = rank_shard(np.asarray(w), None, t, mesh)
            moved = np.abs(want - rank_shard(np.asarray(w0), None, t, mesh)).max()
            diff = np.abs(got[f"arr_{i}"] - want)
            assert diff.max() <= UPDATE_BOUND * moved, (tag, diff.max(), moved)
            close = diff <= LEAF_RTOL * np.abs(want).max()
            assert close.mean() >= PARAM_SHARE.get(case, {}).get(_leaf(names[i]), 1.0), \
                (tag, close.mean())


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_plan_matches_reference(runs, case):
    _, ref, port = runs
    plan = ref[case]["plan"]
    for r in range(4):
        assert port[r][case]["plan"] == plan, (case, r)
    for i in range(STEPS):
        for m in (0, 1):
            logs = [port[2 * p + m][case]["logs"][i] for p in (0, 1)]
            assert logs[0] == logs[1]          # both pods of a model index alike
        a, b = port[0][case]["logs"][i], port[1][case]["logs"][i]
        # each model rank moves its part of every chunk of a sharded leaf
        # and the whole of a replicated leaf's
        rep = port[0][case]["replicated_bytes"]
        assert a[0] == b[0] == plan["n_chunks"]
        assert a[2] + b[2] - rep == plan["payload_bytes"]
        ratio = plan["wire_bytes"] / plan["payload_bytes"]
        assert round(a[1] + b[1] - rep * ratio) == plan["wire_bytes"]


def test_tp_train_ranks_within_deadline(runs):
    _, _, port = runs
    assert all(p["seconds"] < 200 for p in port), [p["seconds"] for p in port]
