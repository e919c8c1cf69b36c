"""The port's site-hierarchical gradient sync on 4 gloo ranks against the JAX
package's on 4 fake CPU devices: 2 sites of 2 pods, ``site_groups =
[[0, 1], [2, 3]]``, the gateways pods 0 and 2.

The same per-rank numpy leaves go through ``repro`` (a shard_map over a
("pod",) mesh of 4 devices, in a subprocess) and through ``repro_torch``
(4 spawned ranks of a gloo group, ``file://`` rendezvous in a tmp dir):

* ``streamed_psum(site_groups=...)`` for ``psum`` / ``ring`` / ``ring2`` x
  none / bf16 / int8, with the ``/intra`` and ``/wan`` plans noted in
  telemetry, as the reference's ``tests/test_ring_collectives.py`` checks
  its own; the non-gateways hand gloo no WAN-stage byte on a ring;
* ``ring_allreduce(subgroup=[0, 2])`` for ``ring`` / ``ring2`` x the codecs;
* ``local_site_allreduce`` with the site groups and without;
* within the port, ``bucketed_sync(site_groups=...)`` bit-identical to
  ``streamed_psum(site_groups=...)`` (the reference's own test at
  ``tests/test_overlap_buckets.py`` holds its version so);
* ``build_train_step(site_groups=...)``: 2 steps of the smoke
  qwen1.5-0.5b on a (pod 4, data 1) mesh from the reference's initial
  state and batches, ``psum`` with no codec and ``ring`` with int8;
* the reference's ``ValueError`` for sites of unequal size, word for word,
  and the tiling check of ``build_train_step``.

Tolerances.  The collectives are compared **bit for bit**: every sum is
two-way (a site's two pods, or the two gateways) or adds zeros (the masked
psum), so both packages' summation orders give the same bits.  The
reference must compute what its source says (its int8 codec under a plain
``jax.jit`` does not, ROADMAP.md §C 5), and op by op it takes ~16 s a case:
so its collectives run jitted under the XLA flags of ``test_torch_ring.py``
(every case there equals its op-by-op run), and the test holds one case,
the gateway ring with int8, to its op-by-op run.
``local_site_allreduce`` without site groups sums four pods, where the
orders differ: 1e-6 relative there.  The train step is jitted in the
reference, so its int8 codec is XLA's arithmetic: the losses within the
tolerances of ``test_torch_train_zero.py`` (step 1 within 5e-3, every step
within 0.01, ``grad_norm`` within 2e-3 relative), every rank's parameters
bit-identical, the plans equal field for field.

Every spawned run gives gloo a 120 s timeout and is joined with a deadline,
so that ranks which disagree fail the test instead of hanging the suite.
"""
from __future__ import annotations

import json
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_train_step import _load_state

GLOO_TIMEOUT = timedelta(seconds=120)
DEADLINE_S = 300
SITES = [[0, 1], [2, 3]]
GATEWAYS = [0, 2]
ALGOS = ("psum", "ring", "ring2")
CODECS = ("none", "bf16", "int8")
# leaf -> (shape, scatter dim, scale); "a" and "b" cross in several chunks
LEAVES = {"a": ((48, 40), 0, 3.0), "b": ((4, 130), 1, 1.0), "s": ((), None, 2.0)}
COMM = dict(streams=2, chunk_mb=0.002, autotune=False)
# bucketed_sync: a stacked tree of 6 layers, ~4 KB buckets
STACKED = {"blocks": {"b": True, "w": True}, "embed": False}
STACKED_DIMS = {"blocks": {"b": None, "w": 2}, "embed": 1}
BUCKET_MB = 0.004
STEPS = 2
FIRST_STEP_TOL = 5e-3
LOSS_TOL = 0.01
NORM_RTOL = 2e-3
STEP_CASES = {"psum-none": ("psum", "none"), "ring-int8": ("ring", "int8")}
STEP_COMM = dict(mode="hierarchical", streams=2, chunk_mb=0.01, autotune=False)
TRAIN = dict(warmup_steps=1, total_steps=10, lr=1e-3)


def spawn(fn, nprocs: int, args: tuple, deadline: float = DEADLINE_S) -> None:
    """Run fn(rank, *args) in `nprocs` spawned processes; fail the test if a
    rank raises or they are not all done within `deadline` seconds (a
    collective posted by some ranks only would wait for gloo's timeout).
    The failure names the rank, how it ended (its traceback, or its exit
    code or signal) and the seconds since the start; at the deadline, the
    ranks still running and the exit codes of the others."""
    name = getattr(fn, "__name__", str(fn))
    t0 = time.monotonic()
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    while True:
        try:
            if ctx.join(timeout=5):
                return
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            pytest.fail(f"{name}: rank {e.error_index} of {nprocs} (pid "
                        f"{getattr(e, 'error_pid', None)}) failed after "
                        f"{time.monotonic() - t0:.1f} s: {e}")
        if time.monotonic() - t0 > deadline:
            alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
            codes = {r: p.exitcode for r, p in enumerate(ctx.processes)
                     if not p.is_alive()}
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"{name}: {nprocs} ranks not done within {deadline} s: "
                        f"ranks {alive} still running, exit codes {codes}")


def rank_leaves(rank: int) -> dict:
    rng = np.random.default_rng(700 + rank)
    out = {}
    for name, (shape, _, scale) in LEAVES.items():
        x = np.asarray(rng.standard_normal(shape) * scale, dtype=np.float32)
        if name == "a":
            x[:2] = 0.0            # all-zero int8 blocks
        out[name] = x
    return out


def stacked_tree(rank: int) -> dict:
    rng = np.random.default_rng(800 + rank)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"blocks": {"w": a(6, 8, 64), "b": a(6, 8)}, "embed": a(32, 8)}


def _dims() -> dict:
    return {k: d for k, (_, d, _) in LEAVES.items()}


# XLA flags under which the jitted reference computes its source's arithmetic
# (``test_torch_ring.py``); the train step does not build under them
STRICT_XLA = ("--xla_backend_optimization_level=0 "
              "--xla_disable_hlo_passes=algsimp,simplify-fp-conversions")

_REF_COLLECTIVES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] += " " + STRICT
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
from repro.core import ring as rg
from repro.core import telemetry as tel
from repro.core.collectives import local_site_allreduce, streamed_psum
from repro.core.path import WidePath
sys.path.insert(0, TESTS)
from test_torch_sites import ALGOS, CODECS, COMM, LEAVES, SITES, _dims, rank_leaves

mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
per = [rank_leaves(r) for r in range(4)]
glob = {k: jnp.asarray(np.concatenate([np.reshape(p[k], (-1,) + np.shape(p[k])[1:])
                                       if np.ndim(p[k]) else np.reshape(p[k], (1,))
                                       for p in per], 0)) for k in per[0]}

def unscalar(t):
    return {k: (t[k].reshape(()) if LEAVES[k][0] == () else t[k]) for k in t}

def rescalar(t):
    return {k: (t[k].reshape((1,)) if LEAVES[k][0] == () else t[k]) for k in t}

def run(body, tree, eager=False):
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod"),
                      axis_names={"pod"}, check_vma=False)
    with jax.set_mesh(mesh):
        return f(tree) if eager else jax.jit(f)(tree)

def save(name, out):
    np.savez(f"{OUT}/{name}.npz", **{k: np.asarray(v) for k, v in out.items()})

plans = {}
for algo in ALGOS:
    for c in CODECS:
        path = WidePath(axis="pod", comm=CommConfig(compress=c, algo=algo, **COMM),
                        name=f"tsite-{algo}-{c}")
        save(f"ref_site_{algo}_{c}", run(lambda t: rescalar(streamed_psum(
            unscalar(t), path, dims=_dims(), site_groups=SITES)), glob))
        plans[f"{algo}_{c}"] = {k: v["plan"] for k, v in
                                tel.get_telemetry().report(prefix=path.key).items()}
        if algo != "psum":
            save(f"ref_subring_{algo}_{c}", run(lambda t: rescalar({k: rg.ring_allreduce(
                x, LEAVES[k][1] or 0, "pod", compress=c, bidirectional=algo == "ring2",
                subgroup=[0, 2]) for k, x in unscalar(t).items()}), glob))
# the anchor: op by op, the gateway ring with int8 on leaf "a"
path = WidePath(axis="pod", comm=CommConfig(compress="int8", algo="ring", **COMM),
                name="tanchor")
save("ref_eager_site_ring_int8", run(lambda t: streamed_psum(
    t, path, dims={"a": 0}, site_groups=SITES), {"a": glob["a"]}, eager=True))
path = WidePath(axis="pod", comm=CommConfig(**COMM), name="tlocal")
for name, groups in (("sites", SITES), ("whole", None)):
    save(f"ref_local_{name}", run(lambda t: rescalar(local_site_allreduce(
        unscalar(t), path, ("data",), _dims(), site_groups=groups)), glob))
print("RESULT:" + json.dumps(plans))
"""

_REF_STEP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import (get_config, smoke_config, RunConfig, ShapeConfig,
                           CommConfig, TrainConfig)
from repro.core import telemetry as tel
from repro.models.registry import batch_concrete
from repro.runtime.step import build_train_step
sys.path.insert(0, TESTS)
from test_torch_sites import SITES, STEPS, STEP_CASES, STEP_COMM, TRAIN

cfg = smoke_config(get_config("qwen1.5-0.5b"))
mesh = jax.make_mesh((4, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=40 + i)["tokens"])
        for i in range(STEPS)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
res = {}
for name, (algo, c) in STEP_CASES.items():
    tel.get_telemetry().reset()
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                   comm=CommConfig(compress=c, algo=algo, **STEP_COMM),
                   train=TrainConfig(**TRAIN))
    with jax.set_mesh(mesh):
        b = build_train_step(rc, mesh, site_groups=SITES)
        sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda x: isinstance(x, P))
        state0 = b.init_state(0)
        if not res:
            flat = {}
            for kp, a in jax.tree_util.tree_leaves_with_path(state0):
                a = np.asarray(a)
                key = jax.tree_util.keystr(kp)
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
    rep = tel.get_telemetry().report(prefix=b.path.key)
    res[name] = {"losses": losses, "norms": norms,
                 "plans": {k: v["plan"] for k, v in rep.items()}}
print("RESULT:" + json.dumps(res))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import ring as rg
    from repro_torch.core import telemetry as tel
    from repro_torch.core.buckets import bucketed_sync
    from repro_torch.core.collectives import local_site_allreduce, streamed_psum
    from repro_torch.core.path import WidePath
    from repro_torch.core.tree import flatten
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime.step import build_train_step
    from repro_torch.runtime.train_loop import replica_checksum
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=4, device="cpu", timeout=GLOO_TIMEOUT)
        mine = {k: torch.from_numpy(v) for k, v in rank_leaves(rank).items()}
        res = {"plans": {}, "sent": {}, "log": {}, "bucketed": {}, "steps": {}}
        for algo in ALGOS:
            for c in CODECS:
                name = f"tsite-{algo}-{c}"
                path = WidePath(axis="pod", name=name,
                                comm=CommConfig(compress=c, algo=algo, **COMM))
                log: list = []
                got = streamed_psum(mine, path, mesh, dims=_dims(),
                                    site_groups=SITES, log=log)
                np.savez(f"{out}/port_site_{algo}_{c}_rank{rank}.npz",
                         **{k: v.numpy() for k, v in got.items()})
                key = f"{algo}_{c}"
                res["plans"][key] = {k: v["plan"] for k, v in
                                     tel.get_telemetry().report(prefix=path.key).items()}
                res["sent"][key] = sum(x["sent_bytes"] for x in log)
                res["log"][key] = [len(log), sum(x["wire_bytes"] for x in log),
                                   sum(x["payload_bytes"] for x in log)]
                if algo != "psum":
                    sub = {k: rg.ring_allreduce(x, LEAVES[k][1] or 0, mesh.pod_group,
                                                compress=c, subgroup=GATEWAYS,
                                                bidirectional=algo == "ring2")
                           for k, x in mine.items()}
                    np.savez(f"{out}/port_subring_{algo}_{c}_rank{rank}.npz",
                             **{k: v.numpy() for k, v in sub.items()})
                st_np = stacked_tree(rank)
                tree = {"embed": torch.from_numpy(st_np["embed"]),
                        "blocks": {k: torch.from_numpy(v)
                                   for k, v in st_np["blocks"].items()}}
                bpath = WidePath(axis="pod", name=f"tsitebkt-{algo}-{c}", comm=CommConfig(
                    compress=c, algo=algo, bucket_mb=BUCKET_MB, **COMM))
                whole = streamed_psum(tree, bpath, mesh, dims=STACKED_DIMS,
                                      site_groups=SITES)
                blog: list = []
                bkt = bucketed_sync(tree, bpath, mesh, stacked=STACKED,
                                    dims=STACKED_DIMS, site_groups=SITES, log=blog)
                res["bucketed"][key] = {
                    "same": all(torch.equal(a, b) for a, b in
                                zip(flatten(whole)[0], flatten(bkt)[0])),
                    "n_buckets": len({x["bucket"] for x in blog})}
        path = WidePath(axis="pod", comm=CommConfig(**COMM), name="tlocal")
        for name, groups in (("sites", SITES), ("whole", None)):
            got = local_site_allreduce(mine, path, mesh, _dims(), site_groups=groups)
            np.savez(f"{out}/port_local_{name}_rank{rank}.npz",
                     **{k: v.numpy() for k, v in got.items()})

        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        toks = np.load(f"{out}/tokens.npy")
        full = _load_state(f"{out}/state0.npz")
        for name, (algo, c) in STEP_CASES.items():
            tel.get_telemetry().reset()
            rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                           comm=CommConfig(compress=c, algo=algo, **STEP_COMM),
                           train=TrainConfig(**TRAIN))
            b = build_train_step(rc, mesh, site_groups=SITES)
            state = state_from_jax(full, "cpu", mesh=mesh, dims=b.dims)
            rec = {"losses": [], "norms": [], "sums": [], "wire": [], "sent": []}
            for i in range(STEPS):
                rows = torch.as_tensor(toks[i][2 * rank:2 * rank + 2], dtype=torch.int64)
                state, m = b.fn(state, {"tokens": rows})
                rec["losses"].append(float(m["loss"]))
                rec["norms"].append(float(m["grad_norm"]))
                rec["sums"].append(replica_checksum(state["params"]))
                rec["wire"].append([len(m["chunks"]), m["wire_bytes"],
                                    sum(x["payload_bytes"] for x in m["chunks"])])
                rec["sent"].append(m["sent_bytes"])
            rep = tel.get_telemetry().report(prefix=b.path.key)
            rec["plans"] = {k: v["plan"] for k, v in rep.items()}
            res["steps"][name] = rec
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tsites")
    tests = os.path.dirname(os.path.abspath(__file__))
    head = f"TESTS = {tests!r}\nOUT = {str(out)!r}\nSTRICT = {STRICT_XLA!r}\n"
    ref = {"plans": multidev(head + _REF_COLLECTIVES, ndev=4, timeout=600),
           "steps": multidev(head + _REF_STEP, ndev=4, timeout=600)}
    spawn(_port_rank, 4, (f"file://{out}/rdv", str(out)))
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(4)]
    return out, ref, port


def _ref_block(a: np.ndarray, shape: tuple, r: int) -> np.ndarray:
    """Rank r's block of the reference's output (the shard_map concatenates
    the ranks' outputs along dim 0; a scalar is one element a rank)."""
    if shape == ():
        return a[r:r + 1].reshape(())
    return a[r * shape[0]:(r + 1) * shape[0]]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("codec", CODECS)
def test_site_streamed_psum_bit_identical_to_reference(runs, algo, codec):
    out, ref, port = runs
    key = f"{algo}_{codec}"
    want = np.load(f"{out}/ref_site_{key}.npz")
    plans = ref["plans"][key]
    prefix = f"tsite-{algo}-{codec}:interpod"
    assert sorted(plans) == [f"{prefix}/intra", f"{prefix}/wan"]
    wan = plans[f"{prefix}/wan"]
    for r in range(4):
        got = np.load(f"{out}/port_site_{key}_rank{r}.npz")
        for name, (shape, _, _) in LEAVES.items():
            np.testing.assert_array_equal(got[name], _ref_block(want[name], shape, r),
                                          err_msg=f"{key} {name} rank {r}")
        assert port[r]["plans"][key] == plans, (key, r)
        # every rank logs the WAN stage's chunks at the plan's modeled bytes
        n, wire, payload = port[r]["log"][key]
        assert n == wan["n_chunks"] and payload == wan["payload_bytes"]
        assert round(wire) == wan["wire_bytes"]
    sent = [port[r]["sent"][key] for r in range(4)]
    assert sent[0] > 0 and sent[2] > 0
    if algo == "psum":     # the masked psum runs over the whole pod axis
        assert sent[1] > 0 and sent[3] > 0
    else:                  # the ring runs among the gateways alone
        assert sent[1] == sent[3] == 0, sent


def test_reference_jitted_strictly_equals_its_op_by_op_run(runs):
    out, _, _ = runs
    eager = np.load(f"{out}/ref_eager_site_ring_int8.npz")["a"]
    np.testing.assert_array_equal(eager, np.load(f"{out}/ref_site_ring_int8.npz")["a"])


@pytest.mark.parametrize("algo", ALGOS)
def test_site_wan_plan_counts_the_gateways_bytes(runs, algo):
    """S = 2 of P = 4 pods carry the WAN bytes: 2 (S - 1) / S of the
    payload averaged over the 4 pods is half of it (the reference's
    ``test_site_gateway_exchange_and_wan_accounting``)."""
    _, ref, _ = runs
    wan = ref["plans"][f"{algo}_none"][f"tsite-{algo}-none:interpod/wan"]
    assert wan["algo"] == algo
    assert wan["wire_bytes"] == wan["payload_bytes"] // 2


@pytest.mark.parametrize("algo", ("ring", "ring2"))
@pytest.mark.parametrize("codec", CODECS)
def test_subgroup_ring_bit_identical_to_reference_on_the_members(runs, algo, codec):
    out, _, _ = runs
    want = np.load(f"{out}/ref_subring_{algo}_{codec}.npz")
    for r in GATEWAYS:
        got = np.load(f"{out}/port_subring_{algo}_{codec}_rank{r}.npz")
        for name, (shape, _, _) in LEAVES.items():
            np.testing.assert_array_equal(got[name], _ref_block(want[name], shape, r),
                                          err_msg=f"{algo} {codec} {name} rank {r}")
    for r in (1, 3):        # a non-member posts nothing and keeps its values
        got = np.load(f"{out}/port_subring_{algo}_{codec}_rank{r}.npz")
        for name, x in rank_leaves(r).items():
            np.testing.assert_array_equal(got[name], x)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("codec", CODECS)
def test_site_bucketed_sync_bit_identical_to_whole(runs, algo, codec):
    _, _, port = runs
    for r in range(4):
        got = port[r]["bucketed"][f"{algo}_{codec}"]
        assert got["same"], (r, got)
        assert got["n_buckets"] >= 3


@pytest.mark.parametrize("groups", ("sites", "whole"))
def test_local_site_allreduce_matches_reference(runs, groups):
    out, _, _ = runs
    want = np.load(f"{out}/ref_local_{groups}.npz")
    for r in range(4):
        got = np.load(f"{out}/port_local_{groups}_rank{r}.npz")
        for name, (shape, _, _) in LEAVES.items():
            w = _ref_block(want[name], shape, r)
            if groups == "sites":        # two-way sums: bit for bit
                np.testing.assert_array_equal(got[name], w, err_msg=f"{name} rank {r}")
            else:                        # four-way sums in other orders
                np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-6)
    # the sites diverge: each holds its own pods' sum
    a = [np.load(f"{out}/port_local_sites_rank{r}.npz")["a"] for r in range(4)]
    if groups == "sites":
        np.testing.assert_array_equal(a[0], a[1])
        np.testing.assert_array_equal(a[2], a[3])
        np.testing.assert_array_equal(a[0], rank_leaves(0)["a"] + rank_leaves(1)["a"])


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_site_train_step_tracks_reference(runs, case):
    _, ref, port = runs
    want = ref["steps"][case]
    for r in range(4):
        got = port[r]["steps"][case]
        assert all(np.isfinite(got["losses"])), got["losses"]
        assert abs(got["losses"][0] - want["losses"][0]) <= FIRST_STEP_TOL
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= LOSS_TOL, (case, got["losses"], want["losses"])
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL)
    # no ZeRO at one data rank: every rank holds the same parameters
    sums = [port[r]["steps"][case]["sums"] for r in range(4)]
    assert sums[0] == sums[1] == sums[2] == sums[3], sums


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_site_train_step_plans_match_reference(runs, case):
    _, ref, port = runs
    plans = ref["steps"][case]["plans"]
    assert sorted(plans) == ["train:interpod", "train:interpod/intra",
                             "train:interpod/wan"]
    wan = plans["train:interpod/wan"]
    for r in range(4):
        got = port[r]["steps"][case]
        assert got["plans"] == plans, (case, r)
        for n, wire, payload in got["wire"]:
            assert n == wan["n_chunks"] and payload == wan["payload_bytes"]
            assert round(wire) == wan["wire_bytes"]
    sent = [port[r]["steps"][case]["sent"] for r in range(4)]
    if STEP_CASES[case][0] == "ring":
        assert sent[1] == sent[3] == [0] * STEPS and min(sent[0] + sent[2]) > 0


def test_unequal_sites_raise_the_reference_error():
    from repro.configs import CommConfig as RefComm
    from repro.core.collectives import site_allreduce as ref_site
    from repro.core.path import WidePath as RefPath
    from repro_torch.configs import CommConfig
    from repro_torch.core.collectives import site_allreduce, streamed_psum
    from repro_torch.core.path import WidePath
    groups = [[0, 1], [2]]
    with pytest.raises(ValueError) as want:
        ref_site({"a": np.zeros(2, np.float32)}, RefPath(axis="pod", comm=RefComm()),
                 groups)
    with pytest.raises(ValueError) as got:
        site_allreduce({"a": torch.zeros(2)}, WidePath(axis="pod", comm=CommConfig()),
                       None, groups)
    assert str(got.value) == str(want.value)
    assert "needs equal pods per site, got sizes [2, 1]" in str(got.value)
    # streamed_psum on one pod has nothing to cross, as the reference's
    tree = {"a": torch.ones(2)}
    assert streamed_psum(tree, WidePath(axis="pod", comm=CommConfig()), None,
                         site_groups=groups) is tree


def test_site_groups_must_tile_the_pod_axis():
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.launch.mesh import PodMesh, make_local_mesh
    from repro_torch.runtime.step import build_train_step
    rc = RunConfig(model=smoke_config(get_config("qwen1.5-0.5b")),
                   shape=ShapeConfig("t", 32, 4, "train"),
                   comm=CommConfig(mode="hierarchical", autotune=False),
                   train=TrainConfig())
    four = PodMesh(pod=4, data=1, model=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match=r"must tile the pod axis of size 4"):
        build_train_step(rc, four, site_groups=[[0, 1], [2, 4]])
    # a single pod has nothing to group: the site groups are dropped
    b = build_train_step(rc, make_local_mesh(device="cpu"), site_groups=[[0]])
    assert b.fn is not None
