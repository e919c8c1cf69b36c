"""The port's layer-bucketed gradient sync against the JAX package's, on the
CPU: the bucket plans, the bucketed AdamW, ``bucketed_sync``, and the train
step's flush and tail modes.

In process: ``bucketable_flags``, ``plan_buckets`` (degenerate plans
included), ``aligned_chunks`` and ``note_bucket_plans`` equal the
reference's on the same shapes; the bucketed AdamW is bit-identical to the
fused one.

On 2 spawned gloo ranks: ``bucketed_sync`` is bit-identical to
``streamed_psum`` for psum / ring / ring2 x none / bf16 / int8, replicated
and ZeRO-sized leaves, as the reference's own test holds its version.

On 4 spawned gloo ranks (2 pods x 2 data ranks, ZeRO-3) against the
reference's (2, 2, 1) mesh on 4 fake devices: the smoke qwen1.5-0.5b train
step, 3 steps from the reference's initial state and batches, in four cases
(flush mode with 1 and 2 microbatches, tail mode with the int8 wire, and
``bucket_mb = 0`` with the int8 wire).  Tolerances are those of
``test_torch_train_zero.py``: step 1's loss within 5e-3, every step's within
0.01, ``grad_norm`` within 2e-3 relative.  Within the port: tail int8 is
bit-identical to the unbucketed int8 step (the reference's own test finds
``tail_int8_diff == 0``); the flush mode's step-1 loss is the unbucketed
one's (the forward does not change), while its parameters may differ in the
last bf16 bit (the hook rounds each synced block gradient to bf16 once more,
as the reference's does).  The ``train:interpod/bkt{i}`` plans noted in
telemetry equal the reference's key for key, and every step's buckets carry
their plans' chunks and wire bytes.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_train_step import _load_state

# ---------------------------------------------------------------------------
# plans, in process
# ---------------------------------------------------------------------------

# name -> (leaf shapes, stacked flags, scatter dims, bucket bytes)
PLANS = {
    "remainder": ([(7, 8, 384), (7, 8), (64, 8)], [True, True, False], [2, None, 0],
                  2 * 8 * 384 * 4),
    "one-layer": ([(5, 16, 32), (5, 32, 16), (100, 16)], [True, True, False],
                  [2, -1, 1], 1),
    "one-bucket": ([(4, 8, 8), (9, 8)], [True, False], [1, 1], 1 << 30),
    "all-stacked": ([(6, 4, 8), (6, 8, 4)], [True, True], [2, 1], 3 * 4 * 8 * 4),
    "no-stacked": ([(7, 8, 384), (64, 8)], [False, False], [2, 0], 1 << 16),
    "off": ([(7, 8, 384), (64, 8)], [True, False], [2, 0], 0),
    "dim0-only": ([(7, 8, 384), (7, 3)], [True, True], [0, -2], 1 << 12),
}


def _ref_leaves(shapes):
    import jax
    import jax.numpy as jnp
    return [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]


def _port_leaves(shapes):
    return [torch.empty(s, dtype=torch.float32, device="meta") for s in shapes]


def _plan_tuple(plan):
    return (plan.n_layers, plan.layers_per_bucket, plan.stacked_bytes,
            plan.rest_bytes, [(b.index, b.lo, b.hi, b.nbytes) for b in plan.buckets],
            plan.layer_bounds)


@pytest.mark.parametrize("case", list(PLANS))
def test_bucket_plans_match_reference(case):
    from repro.core import buckets as rbk
    from repro_torch.core import buckets as pbk
    shapes, stacked, dims, bb = PLANS[case]
    rl, pl = _ref_leaves(shapes), _port_leaves(shapes)
    flags = pbk.bucketable_flags(pl, stacked, dims)
    assert flags == rbk.bucketable_flags(rl, stacked, dims)
    plan = pbk.plan_buckets(pl, flags, bb)
    rplan = rbk.plan_buckets(rl, flags, bb)
    assert _plan_tuple(plan) == _plan_tuple(rplan)
    for b in rplan.buckets:
        ridx = rbk.bucket_indices(flags, b)
        assert pbk.bucket_indices(flags, b) == ridx
        rpay, _ = rbk.bucket_payload(rl, flags, b)
        ppay, _ = pbk.bucket_payload(pl, flags, b)
        assert [tuple(x.shape) for x in ppay] == [tuple(x.shape) for x in rpay]
        from repro.core import streams as rst
        from repro_torch.core import streams as pst
        ch = pbk.aligned_chunks(pl, ppay, ridx, pst.normalize_dims(pl, dims), 1 << 16)
        rch = rbk.aligned_chunks(rl, rpay, ridx, rst.normalize_dims(rl, dims), 1 << 16)
        assert [tuple(c.__dict__.values()) for c in ch] == \
            [tuple(c.__dict__.values()) for c in rch]


def test_note_bucket_plans_match_reference():
    from repro.configs import CommConfig as RComm
    from repro.core import buckets as rbk
    from repro.core import telemetry as rtel
    from repro.core.path import WidePath as RPath
    from repro_torch.configs import CommConfig
    from repro_torch.core import buckets as pbk
    from repro_torch.core import telemetry as ptel
    from repro_torch.core.path import WidePath
    shapes, stacked, dims, _ = PLANS["remainder"]
    for algo, c in (("psum", "int8"), ("ring2", "bf16")):
        kw = dict(streams=3, chunk_mb=0.0625, compress=c, algo=algo, bucket_mb=0.05)
        rplan = rbk.note_bucket_plans(RPath(axis="pod", comm=RComm(**kw), name="tbkt"),
                                      _ref_leaves(shapes), dims, stacked, world=3)
        plan = pbk.note_bucket_plans(WidePath(axis="pod", comm=CommConfig(**kw), name="tbkt"),
                                     _port_leaves(shapes), dims, stacked, world=3)
        assert _plan_tuple(plan) == _plan_tuple(rplan)
        for b in rplan.buckets:
            key = f"tbkt:interpod/bkt{b.index}"
            assert (ptel.get_telemetry().path(key).plan.__dict__
                    == rtel.get_telemetry().path(key).plan.__dict__), key


@pytest.mark.parametrize("pdtype", ["bfloat16", "float32"])
def test_bucketed_adamw_bit_identical_to_fused(pdtype):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import buckets as pbk
    from repro_torch.core.tree import flatten, tree_map
    from repro_torch.optim import adamw_update, init_opt_state
    g = torch.Generator().manual_seed(1)
    dt = getattr(torch, pdtype)
    rnd = lambda *s: torch.randn(s, generator=g)
    params = {"blocks": {"w": rnd(6, 4, 8).to(dt), "ln": torch.ones(6, 4, dtype=dt)},
              "embed": rnd(16, 4).to(dt)}
    grads = {"blocks": {"w": rnd(6, 4, 8), "ln": rnd(6, 4)}, "embed": rnd(16, 4)}
    dims = {"blocks": {"w": 2, "ln": None}, "embed": 1}
    leaves = flatten(params)[0]
    for stacked in ([True, True, False],
                    pbk.bucketable_flags(leaves, [True, True, False], flatten(dims)[0])):
        plan = pbk.plan_buckets(leaves, stacked, bucket_bytes=2 * 4 * 8 * 2)
        assert len(plan.layer_buckets) >= 3
        tc = TrainConfig()
        lr = torch.tensor(1e-3)
        opt = init_opt_state(params)
        for _ in range(2):   # the second step from moments that are not zero
            # each update consumes the moments it is given: a copy each
            p1, o1, s1 = adamw_update(grads, tree_map(torch.clone, opt), params, tc,
                                      lr, dims=dims)
            p2, o2, s2 = adamw_update(grads, tree_map(torch.clone, opt), params, tc,
                                      lr, dims=dims, buckets=plan, stacked=stacked)
            for a, b in zip(flatten((p1, o1["m"], o1["v"]))[0],
                            flatten((p2, o2["m"], o2["v"]))[0]):
                assert a.dtype == b.dtype and torch.equal(a, b)
            assert torch.equal(s1["grad_norm"], s2["grad_norm"])
            params, opt = p1, o1
    with pytest.raises(ValueError, match="stacked"):
        adamw_update(grads, opt, params, tc, lr, buckets=plan)


# ---------------------------------------------------------------------------
# bucketed_sync on 2 ranks
# ---------------------------------------------------------------------------

SYNC_ALGOS = ("psum", "ring", "ring2")
SYNC_CODECS = ("none", "bf16", "int8")
STACKED = {"blocks": {"b": True, "ln": True, "w": True}, "embed": False}
SYNC_DIMS = {"blocks": {"b": None, "ln": None, "w": 2}, "embed": 1}


def _sync_tree(rank: int, zero: bool) -> dict:
    rng = np.random.default_rng(600 + rank + 10 * zero)
    L, d, f, V = 7, 8, 384, 64
    ff = f // 2 if zero else f
    a = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"blocks": {"w": a(L, d, ff), "b": a(L, d), "ln": a(L)}, "embed": a(V, d)}


def _sync_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.buckets import bucketed_sync
    from repro_torch.core.collectives import streamed_psum
    from repro_torch.core.path import WidePath
    from repro_torch.core.tree import flatten
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        mesh = make_local_mesh(pod=2, device="cpu")
        res = {}
        for zero in (False, True):
            tree = _sync_tree(rank, zero)
            for algo in SYNC_ALGOS:
                for c in SYNC_CODECS:
                    name = f"eq-{algo}-{c}-{zero}"
                    path = WidePath(axis="pod", name=name, comm=CommConfig(
                        mode="hierarchical", streams=3, chunk_mb=0.0001, compress=c,
                        algo=algo, bucket_mb=0.01))
                    whole = streamed_psum(tree, path, mesh, dims=SYNC_DIMS)
                    log: list = []
                    bkt = bucketed_sync(tree, path, mesh, stacked=STACKED,
                                        dims=SYNC_DIMS, log=log)
                    same = all(torch.equal(a, b) for a, b in zip(
                        flatten(whole)[0], flatten(bkt)[0]))
                    rep = tel.get_telemetry().report(prefix=f"{name}:interpod")
                    plans = {int(k.rsplit("bkt", 1)[1]): v["plan"]
                             for k, v in rep.items() if "/bkt" in k}
                    res[name] = {
                        "same": same, "n_bkt": len(plans),
                        "payload": [sum(p["payload_bytes"] for p in plans.values()),
                                    rep[f"{name}:interpod"]["plan"]["payload_bytes"]],
                        "log_chunks": [sum(1 for x in log if x["bucket"] == i)
                                       for i in sorted(plans)],
                        "plan_chunks": [plans[i]["n_chunks"] for i in sorted(plans)]}
        with open(f"{out}/sync_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tbsync")
    torch.multiprocessing.start_processes(
        _sync_rank, args=(f"file://{out}/rdv", str(out)), nprocs=2, join=True,
        start_method="spawn")
    return [json.load(open(f"{out}/sync_rank{r}.json")) for r in range(2)]


@pytest.mark.parametrize("algo", SYNC_ALGOS)
@pytest.mark.parametrize("codec", SYNC_CODECS)
def test_bucketed_sync_bit_identical_to_streamed_psum(sync_runs, algo, codec):
    for r in range(2):
        for zero in (False, True):
            got = sync_runs[r][f"eq-{algo}-{codec}-{zero}"]
            assert got["same"], (r, zero)
            assert got["n_bkt"] >= 3
            # the buckets carry the whole payload, each its plan's chunks
            assert got["payload"][0] == got["payload"][1]
            assert got["log_chunks"] == got["plan_chunks"]


# ---------------------------------------------------------------------------
# the train step on 2 pods x 2 data ranks
# ---------------------------------------------------------------------------

STEPS = 3
FIRST_STEP_TOL = 5e-3
LOSS_TOL = 0.01
NORM_RTOL = 2e-3
BUCKET_MB = 0.05
# case -> (bucket_mb, compress, microbatches)
CASES = {
    "flush-m1": (BUCKET_MB, "none", 1),
    "flush-m2": (BUCKET_MB, "none", 2),
    "tail-int8": (BUCKET_MB, "int8", 1),
    "off-int8": (0.0, "int8", 1),
}
COMM = dict(mode="hierarchical", streams=4, chunk_mb=0.01, autotune=False)
TRAIN = dict(zero1=True, warmup_steps=1, total_steps=10, lr=1e-3)

_REFERENCE = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from dataclasses import asdict
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke_config, RunConfig, ShapeConfig, CommConfig, TrainConfig
from repro.core import telemetry as tel
from repro.runtime.step import build_train_step
from repro.models.registry import batch_concrete

cfg = smoke_config(get_config("qwen1.5-0.5b"))
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {"losses": {}, "norms": {}, "plans": {}, "n_buckets": {}}
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=i)["tokens"]) for i in range(STEPS)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
for name, (bucket_mb, c, micro) in CASES.items():
    tel.get_telemetry().reset()
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                   comm=CommConfig(compress=c, bucket_mb=bucket_mb, **COMM),
                   train=TrainConfig(microbatches=micro, **TRAIN))
    with jax.set_mesh(mesh):
        b = build_train_step(rc, mesh)
        sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda x: isinstance(x, P))
        state0 = b.init_state(0)
        if not out["losses"]:
            flat = {}
            for path, a in jax.tree_util.tree_leaves_with_path(state0):
                a = np.asarray(a)
                key = jax.tree_util.keystr(path)
                flat[("bf16" if a.dtype.name == "bfloat16" else "") + key] = (
                    a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
            np.savez(f"{OUT}/state0.npz", **flat)
        state = jax.device_put(state0, sh(b.state_specs))
        losses, norms = [], []
        for i in range(STEPS):
            batch = jax.device_put({"tokens": jnp.asarray(toks[i])}, sh(b.batch_specs))
            state, m = b.fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out["losses"][name] = losses
    out["norms"][name] = norms
    out["n_buckets"][name] = len(b.bucket_plan.buckets) if b.bucket_plan else 0
    rep = tel.get_telemetry().report(prefix=b.path.key)
    out["plans"][name] = {k: v["plan"] for k, v in rep.items()}
print("RESULT:" + json.dumps(out))
"""


def _step_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import telemetry as tel
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime.step import build_train_step
    from repro_torch.runtime.train_loop import replica_checksum
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    try:
        mesh = make_local_mesh(pod=2, data=2, device="cpu")
        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        toks = np.load(f"{out}/tokens.npy")
        full = _load_state(f"{out}/state0.npz")
        res = {k: {} for k in ("losses", "norms", "plans", "checksums", "buckets",
                               "mode", "n_buckets")}
        for name, (bucket_mb, c, micro) in CASES.items():
            tel.get_telemetry().reset()
            rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                           comm=CommConfig(compress=c, bucket_mb=bucket_mb, **COMM),
                           train=TrainConfig(microbatches=micro, **TRAIN))
            b = build_train_step(rc, mesh)
            state = state_from_jax(full, "cpu", mesh=mesh, dims=b.dims)
            losses, norms, sums, bkts, modes = [], [], [], [], []
            for i in range(STEPS):
                rows = torch.as_tensor(toks[i][2 * rank:2 * rank + 2], dtype=torch.int64)
                state, m = b.fn(state, {"tokens": rows})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                sums.append(replica_checksum(state["params"]))
                bkts.append([[x["index"], x["n_chunks"], x["wire_bytes"], x["sync_s"] > 0]
                             for x in m["buckets"]])
                modes.append(m["bucket_mode"])
            res["losses"][name] = losses
            res["norms"][name] = norms
            res["checksums"][name] = sums
            res["buckets"][name] = bkts
            res["mode"][name] = modes
            res["n_buckets"][name] = 0 if b.bucket_plan is None else len(b.bucket_plan.buckets)
            rep = tel.get_telemetry().report(prefix=b.path.key)
            res["plans"][name] = {k: v["plan"] for k, v in rep.items()}
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def step_runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tbstep")
    head = (f"OUT = {str(out)!r}\nCASES = {CASES!r}\nSTEPS = {STEPS}\n"
            f"COMM = {COMM!r}\nTRAIN = {TRAIN!r}\n")
    ref = multidev(head + _REFERENCE, ndev=4, timeout=900)
    torch.multiprocessing.start_processes(
        _step_rank, args=(f"file://{out}/rdv", str(out)), nprocs=4, join=True,
        start_method="spawn")
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(4)]
    return ref, port


@pytest.mark.parametrize("case", list(CASES))
def test_bucketed_train_step_tracks_reference(step_runs, case):
    ref, port = step_runs
    want, want_norm = ref["losses"][case], ref["norms"][case]
    bucket_mb, codec, _ = CASES[case]
    mode = None if not bucket_mb else ("flush" if codec == "none" else "tail")
    for r in range(4):
        assert port[r]["n_buckets"][case] == ref["n_buckets"][case]
        assert port[r]["mode"][case] == [mode] * STEPS
        got = port[r]["losses"][case]
        assert all(np.isfinite(got)), got
        assert abs(got[0] - want[0]) <= FIRST_STEP_TOL, (case, got, want)
        for a, b in zip(got, want):
            assert abs(a - b) <= LOSS_TOL, (case, got, want)
        np.testing.assert_allclose(port[r]["norms"][case], want_norm,
                                   rtol=NORM_RTOL, err_msg=case)
    sums = [port[r]["checksums"][case] for r in range(4)]
    # each data index's shards bit-identical across the pods
    assert sums[0] == sums[2] and sums[1] == sums[3] and sums[0] != sums[1], sums


def test_tail_int8_bit_identical_to_unbucketed_and_flush_forward_unchanged(step_runs):
    _, port = step_runs
    for r in range(4):
        assert port[r]["n_buckets"]["tail-int8"] >= 3
        assert port[r]["checksums"]["tail-int8"] == port[r]["checksums"]["off-int8"]
        assert port[r]["losses"]["tail-int8"] == port[r]["losses"]["off-int8"]
        assert port[r]["norms"]["tail-int8"] == port[r]["norms"]["off-int8"]
        # step 1 takes its loss before any update: the forward is the same
        assert port[r]["losses"]["flush-m1"][0] == port[r]["losses"]["off-int8"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_bucket_plans_noted_as_reference_under_zero(step_runs, case):
    """With bucket_mb > 0 under ZeRO the port notes the reference's
    ``train:interpod/bkt{i}`` plans, key for key, beside the whole-path
    plan; with bucket_mb = 0, none.  Every step's buckets carry their
    plans' chunks and wire bytes (once per microbatch)."""
    ref, port = step_runs
    want = ref["plans"][case]
    keys = sorted((k for k in want if "/bkt" in k),
                  key=lambda k: int(k.rsplit("bkt", 1)[1]))
    assert bool(keys) == bool(CASES[case][0])
    assert len(keys) == ref["n_buckets"][case]
    micro = CASES[case][2]
    for r in range(4):
        got = port[r]["plans"][case]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == want[k], (case, k)
        for step in port[r]["buckets"][case]:
            assert [b[0] for b in step] == list(range(len(keys)))
            for (i, n, wire, timed), k in zip(step, keys):
                assert k.endswith(f"/bkt{i}") and timed
                assert n == micro * want[k]["n_chunks"]
                assert round(wire) == micro * want[k]["wire_bytes"]
