"""The port's elastic membership and local SGD against the JAX package's.

* ``SiteMembership``: one script of probes, suspicions, evictions, joins and
  leaves over the CosmoGrid topology's fault schedules, driven in both
  packages: the same states, epochs, members, quorum and incidents.
* ``delta_sync`` and ``catchup`` (``core/localsgd.py``) on 4 spawned gloo
  ranks against the reference's inside a shard_map over a ("pod",) mesh of
  4 fake devices, **bit for bit**: one-pod sites with pod 1 evicted (psum
  and the gateway ring) and two sites of two pods (the in-site sum), the
  ``{key}/delta`` plans equal; a ``-0.0`` in the catch-up's source arrives
  as ``+0.0``, as the reference's masked sum makes it.  One delta sync on 2
  pods x 2 data ranks (each rank a shard of every leaf, two one-pod sites)
  against the reference's (pod 2, data 2) mesh.  The reference's
  collectives run jitted under the XLA flags of ``test_torch_ring.py``,
  under which it computes its source's arithmetic (``s / n`` a division).
* The evict/rejoin scenario of ``tests/test_elastic.py`` (local SGD every 4
  steps, tokyo's only link down for steps 6-14, ``lease_steps=2``,
  ``rejoin_after=2``, 20 steps of the smoke qwen1.5-0.5b) on 4 ranks of a
  (pod 4, data 1) mesh: the reference's golden ten rows on every rank and
  in the reference run on a (4, 1, 1) mesh, the member pods bit-identical
  after every delta sync, tokyo's parameters amsterdam's after the
  catch-up, the final loss within 0.25 of the 3-site baseline's (the
  reference's own bound), the losses within the tolerances of
  ``test_torch_train_zero.py`` of the reference's.
* ``elastic_restart`` of a 2 x 2 ZeRO Trainer onto 1 pod x 4 data ranks:
  the same checkpoint step and checksum, then finite losses.
* The facade's ``Membership`` and ``setLocalSteps``; the launcher's
  ``--local-steps``, ``--coordinator``, ``--chaos-drop`` and
  ``--backup-links`` end to end on the CPU.

Every spawned run gives gloo a 120 s timeout and is joined with a deadline.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import FIRST_STEP_TOL, LOSS_TOL, STRICT_XLA, spawn
from test_torch_train_step import _load_state

GLOO_TIMEOUT = timedelta(seconds=120)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# leaf -> (rows a rank, cols, dtype, scatter dim)
LEAVES = {"w": (6, 40, "bfloat16", 1), "b": (4, 130, "float32", None)}
COMM = dict(streams=2, chunk_mb=0.002, autotune=False)
# name -> (algo, site groups, member site indices)
CASES = {"one_pod_sites_psum": ("psum", [[0], [1], [2], [3]], [0, 2, 3]),
         "one_pod_sites_ring": ("ring", [[0], [1], [2], [3]], [0, 2, 3]),
         "two_pod_sites_psum": ("psum", [[0, 1], [2, 3]], [0, 1])}
CATCHUP = dict(source_pod=0, target_pods=[1])
STEPS, FAULT, HEAL = 20, 6, 14
TRAIN_COMM = dict(mode="hierarchical", streams=4, chunk_mb=0.01, autotune=False)
TRAIN = dict(zero1=True, warmup_steps=2, total_steps=50)
GOLDEN = [
    ["detect", "tokyo", 6], ["evict", "tokyo", 8],
    ["resize", "amsterdam,espoo,edinburgh", 8], ["retune", "train:ams-espoo", 8],
    ["recover", "amsterdam,espoo,edinburgh", 8], ["join", "tokyo", 15],
    ["resize", "amsterdam,tokyo,espoo,edinburgh", 15], ["catchup", "tokyo", 15],
    ["retune", "train:ams-espoo", 15], ["recover", "amsterdam,tokyo,espoo,edinburgh", 15],
]


def rank_leaves(rank: int, seed: int) -> dict:
    """This rank's parameters and anchor leaves as numpy (bf16 as ml_dtypes');
    pod 0's ``w[0, 0]`` and pod 2's ``w[1, 3]`` are ``-0.0``."""
    import ml_dtypes
    rng = np.random.default_rng(seed + rank)
    out = {}
    for pre in ("p", "a"):
        for name, (rows, cols, dt, _) in LEAVES.items():
            x = rng.standard_normal((rows, cols)).astype(np.float32)
            if pre == "a":
                x = out[f"p{name}"].astype(np.float32) + 0.01 * x
            if name == "w" and rank in (0, 2):
                x[(0, 0) if rank == 0 else (1, 3)] = -0.0
            out[f"{pre}{name}"] = x.astype(ml_dtypes.bfloat16 if dt == "bfloat16"
                                           else np.float32)
    return out


def _dims() -> dict:
    return {k: d for k, (_, _, _, d) in LEAVES.items()}


def _members(groups, sites):
    ms = [groups[i] for i in sites]
    return [p for g in ms for p in g], [g[0] for g in ms]


def _start_reference(script: str, out, ndev: int = 4) -> subprocess.Popen:
    """The reference's script in a subprocess on `ndev` fake CPU devices,
    running while the port's ranks run (``tests/conftest.py`` ``multidev``
    without the wait)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}")
    tests = os.path.dirname(os.path.abspath(__file__))
    head = f"TESTS = {tests!r}\nOUT = {str(out)!r}\nSTRICT = {STRICT_XLA!r}\n"
    return subprocess.Popen([sys.executable, "-c", head + script], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reference_result(proc: subprocess.Popen, timeout: float = 600) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the reference run took over {timeout} s")
    for line in stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    pytest.fail(f"no RESULT line (rc={proc.returncode}):\n{stdout[-3000:]}\n{stderr[-3000:]}")


def _wait_for(path: str, proc: subprocess.Popen, timeout: float = 300) -> None:
    """Wait until the reference has written `path` (it renames the file into
    place when complete)."""
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            _reference_result(proc)
        if time.monotonic() > end:
            proc.kill()
            pytest.fail(f"the reference wrote no {path} within {timeout} s")
        time.sleep(0.2)


# ---------------------------------------------------------------------------
# SiteMembership, in process, both packages
# ---------------------------------------------------------------------------

def _membership_script(root: str) -> dict:
    topo = importlib.import_module(f"{root}.core.topology")
    chaos = importlib.import_module(f"{root}.core.chaos")
    mem_mod = importlib.import_module(f"{root}.core.membership")
    t = topo.cosmogrid_topology(backup_links=True)
    for a, b in (("amsterdam", "tokyo"), ("tokyo", "amsterdam"),
                 ("tokyo", "edinburgh"), ("edinburgh", "tokyo")):
        t.connect(a, b, t.link(a, b).drop(3, until=9))
    t.connect("amsterdam", "espoo", t.link("amsterdam", "espoo").degrade(
        0.01, (5, 7), error_rate=0.5, seed=11))
    log = chaos.IncidentLog()
    mem = mem_mod.SiteMembership(t, "amsterdam", lease_steps=2, rejoin_after=2,
                                 quorum=mem_mod.QuorumPolicy(min_sites=2, fraction=0.75),
                                 log=log)
    rows = []
    for step in range(14):
        mem.on_step(step)
        if step == 10:
            mem.suspect("espoo", step, reason="scripted")
        if step == 11:
            mem.leave("edinburgh", step)
        if step == 12:
            mem.evict("espoo", step, reason="scripted")
        if step == 13:
            mem.join("edinburgh", step)
        rows.append([step, mem.epoch, mem.members(), mem.evicted(),
                     [mem.state(s.name) for s in t.sites], mem.has_quorum(),
                     mem.member_pod_groups(), mem.member_gateways()])
    return {"rows": rows, "incidents": log.timeline(),
            "errors": [str(_raises(lambda: mem.evict("amsterdam", 20))),
                       str(_raises(lambda: mem.state("nowhere")))]}


def _raises(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def test_site_membership_identical_to_reference():
    want, got = _membership_script("repro"), _membership_script("repro_torch")
    assert got == want
    kinds = [r["event"] for r in got["incidents"]]
    assert {"detect", "evict", "join", "leave"} <= set(kinds)
    assert got["rows"][-1][1] == len([k for k in kinds if k in ("evict", "join", "leave")])


def test_localsgd_controller_and_reference_twins():
    from repro.core import localsgd as jl
    from repro_torch.core import localsgd as pl
    for k in (1, 2, 4):
        a, b = jl.LocalSGDController(k), pl.LocalSGDController(k)
        assert a.enabled == b.enabled
        assert [a.is_sync_step(s) for s in range(12)] == [b.is_sync_step(s) for s in range(12)]
    rng = np.random.default_rng(3)
    anchor = rng.standard_normal(9).astype(np.float32)
    params = {s: rng.standard_normal(9).astype(np.float32) for s in "abc"}
    want, got = jl.reference_delta_merge(anchor, params, ["a", "c"]), \
        pl.reference_delta_merge(anchor, params, ["a", "c"])
    assert all(want[s].tobytes() == got[s].tobytes() for s in "abc")
    assert jl.reference_wan_bytes(10 ** 6, 20, 4, 3) == pl.reference_wan_bytes(10 ** 6, 20, 4, 3)


# ---------------------------------------------------------------------------
# delta_sync and catchup, bit for bit on 4 ranks
# ---------------------------------------------------------------------------

_REF_SYNC = r"""
import json, os, sys
os.environ["XLA_FLAGS"] += " " + STRICT
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
from repro.core import telemetry as tel
from repro.core.localsgd import catchup, delta_sync
from repro.core.path import WidePath
sys.path.insert(0, TESTS)
from test_torch_elastic import CASES, CATCHUP, COMM, _dims, _members, rank_leaves

def glob(per, keys, axis=0):
    return {k: jnp.asarray(np.concatenate([p[k] for p in per], axis)) for k in keys}

def run(mesh, spec, names, body, *trees):
    f = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * len(trees), out_specs=spec,
                      axis_names=set(names), check_vma=False)
    with jax.set_mesh(mesh):
        return jax.jit(f)(*trees)

def save(name, out):
    np.savez(f"{OUT}/{name}.npz", **{k: np.asarray(v).astype(np.float32)
                                     for k, v in out.items()})

mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
per = [rank_leaves(r, 10) for r in range(4)]
params = {k[1:]: v for k, v in glob(per, ["pw", "pb"]).items()}
anchor = {k[1:]: v for k, v in glob(per, ["aw", "ab"]).items()}
plans = {}
for name, (algo, groups, sites) in CASES.items():
    pods, gws = _members(groups, sites)
    path = WidePath(axis="pod", comm=CommConfig(algo=algo, **COMM), name=f"tls-{name}")
    save(f"ref_{name}", run(mesh, P("pod"), ("pod",), lambda p, a: delta_sync(
        p, a, path, dims=_dims(), site_groups=groups, member_pods=pods,
        member_gateways=gws), params, anchor))
    plans[name] = {k: v["plan"] for k, v in
                   tel.get_telemetry().report(prefix=path.key).items()}
path = WidePath(axis="pod", comm=CommConfig(**COMM), name="tls-catchup")
save("ref_catchup", run(mesh, P("pod"), ("pod",),
                        lambda p: catchup(p, path, **CATCHUP), params))

# 2 pods x 2 data ranks: rank (p, d) holds block (p, d) of each leaf
mesh22 = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
per = [rank_leaves(r, 20) for r in range(4)]
def blocks(k):
    rows = [np.concatenate([per[2 * p + d][k] for d in range(2)], 1) for p in range(2)]
    return jnp.asarray(np.concatenate(rows, 0))
params = {k[1:]: blocks(k) for k in ("pw", "pb")}
anchor = {k[1:]: blocks(k) for k in ("aw", "ab")}
path = WidePath(axis="pod", comm=CommConfig(**COMM), name="tls-zero")
save("ref_zero", run(mesh22, P("pod", "data"), ("pod", "data"), lambda p, a: delta_sync(
    p, a, path, dims={"w": 1, "b": 1}, site_groups=[[0], [1]], member_pods=[0, 1],
    member_gateways=[0, 1]), params, anchor))
plans["zero"] = {k: v["plan"] for k, v in tel.get_telemetry().report(prefix=path.key).items()}
print("RESULT:" + json.dumps(plans))
"""


def _torch_tree(leaves: dict, pre: str) -> dict:
    import ml_dtypes
    out = {}
    for name in LEAVES:
        a = leaves[pre + name]
        if a.dtype == ml_dtypes.bfloat16:
            out[name] = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a)
    return out


def _sync_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.localsgd import catchup, delta_sync
    from repro_torch.core.path import WidePath
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        save = lambda name, t: np.savez(f"{out}/{name}_rank{rank}.npz",
                                        **{k: v.float().numpy() for k, v in t.items()})
        bits = {}
        mesh = make_local_mesh(pod=4, device="cpu", timeout=GLOO_TIMEOUT)
        mine = rank_leaves(rank, 10)
        params, anchor = _torch_tree(mine, "p"), _torch_tree(mine, "a")
        plans = {}
        for name, (algo, groups, sites) in CASES.items():
            pods, gws = _members(groups, sites)
            path = WidePath(axis="pod", comm=CommConfig(algo=algo, **COMM),
                            name=f"tls-{name}")
            got = delta_sync(params, anchor, path, mesh, dims=_dims(),
                             site_groups=groups, member_pods=pods, member_gateways=gws)
            assert all(got[k].dtype == params[k].dtype for k in got)
            save(f"port_{name}", got)
            plans[name] = {k: v["plan"] for k, v in
                           tel.get_telemetry().report(prefix=path.key).items()}
        got = catchup(params, mesh, **CATCHUP)
        save("port_catchup", got)
        bits["catchup_w00_sign"] = bool(torch.signbit(got["w"][0, 0].float()))
        bits["own_w00_sign"] = bool(torch.signbit(params["w"][0, 0].float()))
        mesh22 = make_local_mesh(pod=2, data=2, device="cpu", timeout=GLOO_TIMEOUT)
        mine = rank_leaves(rank, 20)
        path = WidePath(axis="pod", comm=CommConfig(**COMM), name="tls-zero")
        got = delta_sync(_torch_tree(mine, "p"), _torch_tree(mine, "a"), path, mesh22,
                         dims={"w": 1, "b": 1}, site_groups=[[0], [1]],
                         member_pods=[0, 1], member_gateways=[0, 1])
        save("port_zero", got)
        plans["zero"] = {k: v["plan"] for k, v in
                         tel.get_telemetry().report(prefix=path.key).items()}
        with open(f"{out}/sync_rank{rank}.json", "w") as f:
            json.dump({"plans": plans, "bits": bits}, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def syncs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tlocalsgd")
    proc = _start_reference(_REF_SYNC, out)
    spawn(_sync_rank, 4, (f"file://{out}/rdv", str(out)))
    ref = _reference_result(proc)
    port = [json.load(open(f"{out}/sync_rank{r}.json")) for r in range(4)]
    return out, ref, port


def _rank_block(ref: np.ndarray, r: int, zero: bool) -> np.ndarray:
    if not zero:
        n = ref.shape[0] // 4
        return ref[r * n:(r + 1) * n]
    p, d = divmod(r, 2)
    n, m = ref.shape[0] // 2, ref.shape[1] // 2
    return ref[p * n:(p + 1) * n, d * m:(d + 1) * m]


@pytest.mark.parametrize("case", list(CASES) + ["catchup", "zero"])
def test_localsgd_bit_identical_to_reference(syncs, case):
    out, ref, port = syncs
    want = np.load(f"{out}/ref_{case}.npz")
    for r in range(4):
        got = np.load(f"{out}/port_{case}_rank{r}.npz")
        for k in LEAVES:
            w = _rank_block(want[k], r, case == "zero")
            assert got[k].view(np.uint32).tobytes() == w.view(np.uint32).tobytes(), (case, r, k)
        if case != "catchup":
            assert port[r]["plans"][case] == ref[case], (case, r)


def test_catchup_turns_a_negative_zero_positive(syncs):
    _, _, port = syncs
    # pod 0 holds -0.0 at w[0, 0]; pod 1 (the target) receives +0.0, pod 0
    # keeps its own -0.0
    assert port[0]["bits"] == {"catchup_w00_sign": True, "own_w00_sign": True}
    assert port[1]["bits"]["catchup_w00_sign"] is False


# ---------------------------------------------------------------------------
# the evict/rejoin scenario and elastic_restart
# ---------------------------------------------------------------------------

_REF_SCENARIO = r"""
import json, os, sys
import numpy as np
import jax
from repro.configs import (get_config, smoke_config, RunConfig, ShapeConfig,
                           CommConfig, TrainConfig)
from repro.core import cosmogrid_topology, get_incident_log
from repro.core.membership import SiteMembership
from repro.models.registry import batch_concrete
from repro.runtime import Trainer
sys.path.insert(0, TESTS)
from test_torch_elastic import FAULT, HEAL, STEPS, TRAIN, TRAIN_COMM

cfg = smoke_config(get_config("qwen1.5-0.5b"))
rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
               comm=CommConfig(local_steps=4, **TRAIN_COMM), train=TrainConfig(**TRAIN))
mesh = jax.make_mesh((4, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=120 + i)["tokens"])
        for i in range(STEPS)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
batches = lambda: iter([{"tokens": t} for t in toks])
log = get_incident_log()
log.clear()
t = cosmogrid_topology()
for a, b in (("amsterdam", "tokyo"), ("tokyo", "amsterdam")):
    t.connect(a, b, t.link(a, b).drop(FAULT, until=HEAL))
mem = SiteMembership(t, "amsterdam", lease_steps=2, rejoin_after=2)
with jax.set_mesh(mesh):
    tr = Trainer(rc, mesh, route=t.route("amsterdam", "espoo"),
                 site_groups=t.pod_groups(), membership=mem)
    tr.init_or_restore()
    flat = {}
    for kp, a in jax.tree_util.tree_leaves_with_path(tr.state):
        a = np.asarray(a)
        key = jax.tree_util.keystr(kp)
        flat[("bf16" if a.dtype.name == "bfloat16" else "") + key] = (
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    np.savez(f"{OUT}/state0.tmp.npz", **flat)
    os.replace(f"{OUT}/state0.tmp.npz", f"{OUT}/state0.npz")
    hist = tr.run(batches(), STEPS, log_every=0, log=lambda _: None)
print("RESULT:" + json.dumps({
    "timeline": [[e.kind, e.subject, e.step] for e in log.events()],
    "details": [dict(e.detail) for e in log.events()],
    "epoch": mem.epoch, "losses": [h["loss"] for h in hist]}))
"""


def _full_checksum(tr) -> int:
    """The checksum of a ZeRO Trainer's whole state, its shards gathered
    over each pod's data group."""
    from repro_torch.core.collectives import all_gather_dim
    from repro_torch.core.tree import tree_map
    from repro_torch.runtime.train_loop import replica_checksum
    dims = tr.bundle.dims
    full = lambda t: tree_map(lambda x, d: x if d is None else
                              all_gather_dim(x, d, tr.mesh.data_group), t, dims)
    st = tr.state
    return replica_checksum({"params": full(st["params"]),
                             "opt": {"m": full(st["opt"]["m"]), "v": full(st["opt"]["v"]),
                                     "step": st["opt"]["step"]}})


def _scenario_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import cosmogrid_topology, get_incident_log
    from repro_torch.core.membership import SiteMembership
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime import Trainer, elastic_restart
    from repro_torch.runtime import step as step_mod
    from repro_torch.runtime import train_loop
    from repro_torch.core.tree import flatten
    from repro_torch.runtime.train_loop import replica_checksum
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=4, device="cpu", timeout=GLOO_TIMEOUT)
        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                       comm=CommConfig(local_steps=4, **TRAIN_COMM),
                       train=TrainConfig(**TRAIN))
        toks = np.load(f"{out}/tokens.npy")
        full = _load_state(f"{out}/state0.npz")
        batches = lambda: iter([{"tokens": t} for t in toks])
        log = get_incident_log()
        catchups = []

        def build_catchup(*a, **kw):
            fn = step_mod.build_catchup(*a, **kw)

            def wrapped(params):
                got = fn(params)
                catchups.append(replica_checksum(got))
                return got
            return wrapped
        train_loop.build_catchup = build_catchup
        res = {}
        for name, (fault, heal, pre_evict) in (("chaos", (FAULT, HEAL, False)),
                                               ("baseline", (0, None, True))):
            log.clear()
            t = cosmogrid_topology()
            for a, b in (("amsterdam", "tokyo"), ("tokyo", "amsterdam")):
                t.connect(a, b, t.link(a, b).drop(fault, until=heal))
            mem = SiteMembership(t, "amsterdam", lease_steps=2,
                                 **({} if pre_evict else {"rejoin_after": 2}))
            if pre_evict:
                mem.evict("tokyo", 0, reason="baseline")
            tr = Trainer(rc, mesh, route=t.route("amsterdam", "espoo"),
                         site_groups=t.pod_groups(), membership=mem, check_replicas=True)
            tr.init_or_restore()
            tr.state = state_from_jax(full, "cpu")
            hist = tr.run(batches(), STEPS, log_every=0, log=lambda *_: None)
            res[name] = {"timeline": [[e.kind, e.subject, e.step] for e in log.events()],
                         "details": [dict(e.detail) for e in log.events()],
                         "epoch": mem.epoch, "losses": [h["loss"] for h in hist],
                         "sums": [h["checksum"] for h in hist],
                         "members": [h["members"] for h in hist]}
        res["catchup_sums"] = catchups
        train_loop.build_catchup = step_mod.build_catchup

        # elastic_restart: 2 pods x 2 data ranks (ZeRO) -> 1 pod x 4 data ranks
        rc2 = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                        comm=CommConfig(**TRAIN_COMM), train=TrainConfig(**TRAIN))
        m22 = make_local_mesh(pod=2, data=2, device="cpu", timeout=GLOO_TIMEOUT)
        tr = Trainer(rc2, m22, ckpt_dir=f"{out}/restart_ck", check_replicas=True)
        tr.init_or_restore()
        h1 = tr.run(batches(), 2, log_every=0)
        saved = _full_checksum(tr)
        m14 = make_local_mesh(pod=1, data=4, device="cpu", timeout=GLOO_TIMEOUT)
        t2 = elastic_restart(rc2, tr, m14, check_replicas=True)
        res["restart"] = {
            "zero": [tr.bundle.zero, t2.bundle.zero], "step": t2.step,
            "saved": saved, "restored": _full_checksum(t2),
            "shapes": [[list(x.shape) for x in flatten(t.state["params"])[0]]
                       for t in (tr, t2)],
            "losses": [h["loss"] for h in h1 + t2.run(batches(), 2, log_every=0)]}
        t2.close()
        with open(f"{out}/scenario_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    out = tmp_path_factory.mktemp("telastic")
    # the port's ranks start once the reference has written its batches and
    # initial state, and run while the reference trains
    proc = _start_reference(_REF_SCENARIO, out)
    _wait_for(f"{out}/state0.npz", proc)
    spawn(_scenario_rank, 4, (f"file://{out}/rdv", str(out)))
    ref = _reference_result(proc)
    return ref, [json.load(open(f"{out}/scenario_rank{r}.json")) for r in range(4)]


def test_evict_rejoin_timeline_is_golden_on_every_rank(scenario):
    ref, port = scenario
    assert ref["timeline"] == GOLDEN and ref["epoch"] == 2
    for r in range(4):
        got = port[r]["chaos"]
        assert got["timeline"] == GOLDEN and got["epoch"] == 2
        assert got["details"] == ref["details"], r


def test_members_bit_identical_after_every_delta_sync(scenario):
    _, port = scenario
    names = ["amsterdam", "tokyo", "espoo", "edinburgh"]
    synced = [s for s in range(STEPS) if (s + 1) % 4 == 0] + [8, 15]
    for s in sorted(set(synced)):
        members = port[0]["chaos"]["members"][s]
        sums = {port[r]["chaos"]["sums"][s] for r in range(4) if names[r] in members}
        assert len(sums) == 1, (s, members)
    # evicted tokyo trained on alone between the syncs
    assert port[1]["chaos"]["sums"][11] != port[0]["chaos"]["sums"][11]


def test_rejoined_site_catches_up_from_a_survivor(scenario):
    _, port = scenario
    # one catch-up, at step 15: tokyo (pod 1) holds amsterdam's (pod 0) bits
    assert all(len(port[r]["catchup_sums"]) == 1 for r in range(4))
    assert port[1]["catchup_sums"] == port[0]["catchup_sums"]
    cu = next(d for (k, _, _), d in zip(port[0]["chaos"]["timeline"],
                                       port[0]["chaos"]["details"]) if k == "catchup")
    assert cu == {"source": "amsterdam", "pods": [1]}


def test_elastic_losses_track_reference_and_baseline(scenario):
    ref, port = scenario
    for r in range(4):
        got = port[r]["chaos"]["losses"]
        assert all(math.isfinite(x) for x in got)
        assert abs(got[0] - ref["losses"][0]) <= FIRST_STEP_TOL
        for a, b in zip(got, ref["losses"]):
            assert abs(a - b) <= LOSS_TOL, (got, ref["losses"])
        base = port[r]["baseline"]
        assert base["epoch"] == 1 and abs(got[-1] - base["losses"][-1]) < 0.25
        assert got == port[0]["chaos"]["losses"]


def test_elastic_restart_onto_one_pod_of_four(scenario):
    _, port = scenario
    for r in range(4):
        got = port[r]["restart"]
        assert got["zero"] == [True, True] and got["step"] == 2
        # the whole state, gathered in each layout, is the one saved
        assert got["restored"] == got["saved"] == port[0]["restart"]["saved"]
        assert len(got["losses"]) == 4 and all(math.isfinite(x) for x in got["losses"])
        # each rank holds a quarter of a scattered leaf, not a half
        halves, quarters = got["shapes"]
        assert any(2 * q[0] == h[0] or 2 * q[-1] == h[-1]
                   for h, q in zip(halves, quarters) if h != q)


# ---------------------------------------------------------------------------
# the facade and the launcher
# ---------------------------------------------------------------------------

def test_facade_membership_and_local_steps():
    from repro.core.api import MPW as JMPW
    from repro.core.topology import cosmogrid_topology as jtopo
    from repro_torch.core.api import MPW
    from repro_torch.core.membership import SiteMembership
    from repro_torch.core.topology import cosmogrid_topology
    out = []
    for mpw_cls, topo in ((JMPW, jtopo), (MPW, cosmogrid_topology)):
        mpw = mpw_cls.Init()
        pid = mpw.CreatePath()
        mpw.setLocalSteps(pid, 4)
        with pytest.raises(ValueError, match="local steps must be >= 1, got 0"):
            mpw.setLocalSteps(pid, 0)
        mem = mpw.Membership(topo(), "amsterdam", lease_steps=3)
        out.append([mpw.path(pid).comm.local_steps, mem.lease_steps,
                    mpw.membership is mem, mem.members()])
        mpw.Finalize()
    assert out[0] == out[1] and out[1][:3] == [4, 3, True]
    assert isinstance(MPW.Init().Membership(cosmogrid_topology(), "tokyo"), SiteMembership)


def _launch(args: list, tmp_path) -> subprocess.CompletedProcess:
    # one intra-op thread a rank: four ranks share the worker's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--smoke", "--device", "cpu", "--seq-len", "32", "--pods", "4",
         "--streams", "4", "--chunk-mb", "0.01", *args],
        env=env, capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    return out


def test_launcher_local_steps_and_coordinator(tmp_path):
    out = _launch(["--steps", "8", "--route", "amsterdam:espoo", "--local-steps", "4",
                   "--coordinator", "amsterdam", "--lease-steps", "2",
                   "--report", str(tmp_path / "run")], tmp_path)
    assert "membership coordinated by amsterdam" in out.stdout
    assert "local_steps=4" in out.stdout and "[train] done: loss" in out.stdout
    rep = json.load(open(tmp_path / "run.rank0.json"))
    assert [h["members"] for h in rep["history"]][-1] == [
        "amsterdam", "tokyo", "espoo", "edinburgh"]
    assert all(h["n_chunks"] == 0 for h in rep["history"])   # no WAN stage a step


def test_launcher_chaos_drop_and_backup_links(tmp_path):
    out = _launch(["--steps", "8", "--route", "amsterdam:tokyo", "--backup-links",
                   "--chaos-drop", "4", "--report", str(tmp_path / "run")], tmp_path)
    assert "; chaos drop at step 4" in out.stdout
    # the launcher's monitor keeps the detector's default window of 3
    assert "[chaos] step 6: route replanned -> amsterdam -> edinburgh -> tokyo" in out.stdout
    for r in range(4):
        rep = json.load(open(tmp_path / f"run.rank{r}.json"))
        assert rep["final_route"] == ["amsterdam", "edinburgh", "tokyo"]
        assert [(x["event"], x["step"]) for x in rep["incidents"]] == [
            ("inject", 4), ("detect", 6), ("replan", 6), ("retune", 6)]


def test_launcher_checks_the_new_flags():
    from repro_torch.launch.train import main
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--pods", "4"]
    with pytest.raises(SystemExit, match="needs --route"):
        main(base + ["--coordinator", "amsterdam"])
    with pytest.raises(SystemExit, match="direct tokyo-espoo link"):
        main(base + ["--route", "tokyo:espoo", "--chaos-drop", "2"])
    with pytest.raises(SystemExit, match="is not a site"):
        main(base + ["--route", "tokyo:amsterdam", "--coordinator", "mars"])
