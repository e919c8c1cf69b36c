"""The port's MPW facade (``core/api.py``) against the JAX package's.

Across ranks: 4 spawned gloo ranks, one ``MPW`` session each on a 4-pod
mesh, against the reference's facade inside a shard_map over a ("pod",)
mesh of 4 fake CPU devices, with the same per-rank numpy trees: Send,
Recv, SendRecv, DSendRecv, ISendRecv/Wait, Cycle, Relay, Forward both ways
over ``CreateForwarder(cosmogrid, "tokyo", "espoo")``, Barrier, and
AllReduce.  Messages move bits: **bit for bit**, and so is the
site-hierarchical AllReduce (two-way sums, then sums with zeros); the plain
4-pod AllReduce sums in another order than XLA's, within 1e-6 relative.
The traffic plans the verbs note must be equal field for field.

In process (no collective): path ids and telemetry keys, ``Route``,
``CreatePathVariadic``, the setters, ``setAutoTuning`` and ``Observe`` (with
the online and per-hop tuners), ``Serve``/``Admit``/``ServeStats``,
``Report``/``PathStats`` keys and ``Incidents``: identical to the
reference's (path ids normalized, as each package counts its own).
``Membership`` and ``setLocalSteps`` do what the reference's do.  Every
spawned run gives gloo a 120 s timeout and is joined with a deadline.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import os
import re
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import spawn

GLOO_TIMEOUT = timedelta(seconds=120)
LEAVES = {"a": ((96, 256), 0), "b": ((5, 130), 1), "s": ((), None)}
SITES = [[0, 1], [2, 3]]
MAX_LEN = 64
VERBS = ("Send", "Recv", "SendRecv2", "ISendRecv", "Cycle", "Relay", "Forward",
         "ForwardBack", "AllReduceSites")


def rank_leaves(rank: int) -> dict:
    rng = np.random.default_rng(1100 + rank)
    return {k: np.asarray(rng.standard_normal(shape), dtype=np.float32)
            for k, (shape, _) in LEAVES.items()}


def _dims() -> dict:
    return {k: d for k, (_, d) in LEAVES.items()}


def _norm_keys(d: dict) -> dict:
    return {re.sub(r"mpw\d+", "mpwN", k): v for k, v in d.items()}


_REF = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
from repro.core import telemetry as tel
from repro.core.api import MPW
from repro.core.topology import cosmogrid_topology
sys.path.insert(0, TESTS)
from test_torch_facade import LEAVES, MAX_LEN, SITES, VERBS, _dims, _norm_keys, rank_leaves

mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
per = [rank_leaves(r) for r in range(4)]
glob = {k: jnp.asarray(np.concatenate([np.reshape(p[k], (-1,) + np.shape(p[k])[1:])
                                       if np.ndim(p[k]) else np.reshape(p[k], (1,))
                                       for p in per], 0)) for k in per[0]}

def unscalar(t):
    return {k: (t[k].reshape(()) if LEAVES[k][0] == () else t[k]) for k in t}

def rescalar(t):
    return {k: (t[k].reshape((1,)) if LEAVES[k][0] == () else t[k]) for k in t}

def run(body, tree):
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod"),
                      axis_names={"pod"}, check_vma=False)
    with jax.set_mesh(mesh):
        return jax.jit(f)(tree)

mpw = MPW.Init()
link = mpw.CreatePath(comm=CommConfig(streams=2, chunk_mb=0.0625, autotune=False))
other = mpw.CreatePath(comm=CommConfig(streams=3, chunk_mb=0.125, autotune=False))
fwd = mpw.CreateForwarder(cosmogrid_topology(), "tokyo", "espoo")
mpw.setChunkSize(fwd, 1 << 16)
d = _dims()
fns = {"Send": lambda t: mpw.Send(link, t, dims=d),
       "Recv": lambda t: mpw.Recv(link, t, dims=d),
       "SendRecv2": lambda t: mpw.SendRecv(link, t, 2, dims=d),
       "ISendRecv": lambda t: mpw.Wait(*mpw.ISendRecv(link, t)),
       "Cycle": lambda t: mpw.Cycle(link, other, t, dims=d),
       "Relay": lambda t: mpw.Relay(link, t, 3, dims=d),
       "Forward": lambda t: mpw.Forward(fwd, t, dims=d),
       "ForwardBack": lambda t: mpw.Forward(fwd, t, dims=d, reverse=True),
       "AllReduceSites": lambda t: mpw.AllReduce(link, t, dims=d, site_groups=SITES),
       "AllReduce": lambda t: mpw.AllReduce(link, t, dims=d)}
res = {}
for name, fn in fns.items():
    tel.get_telemetry().reset()
    out = run(lambda t: rescalar(fn(unscalar(t))), glob)
    np.savez(f"{OUT}/ref_{name}.npz", **{k: np.asarray(v) for k, v in out.items()})
    res[name] = _norm_keys({k: v["plan"] for k, v in tel.get_telemetry().report().items()})
buf = jnp.concatenate([jnp.arange(4 * MAX_LEN, dtype=jnp.float32)])
lens = jnp.asarray([10, 20, 30, 40], jnp.int32)
def dsr(t):
    b, n = mpw.DSendRecv(link, t["buf"], t["len"][0], MAX_LEN)
    return {"buf": b, "len": n.reshape(1)}
out = run(dsr, {"buf": buf, "len": lens})
res["DSendRecv"] = {"buf": np.asarray(out["buf"]).tolist(), "len": np.asarray(out["len"]).tolist()}
out = run(lambda t: mpw.Barrier().reshape(1), glob["s"])
res["Barrier"] = np.asarray(out).tolist()
res["route"] = mpw.Route(fwd)
print("RESULT:" + json.dumps(res))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.api import MPW
    from repro_torch.core.topology import cosmogrid_topology
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=4, device="cpu", timeout=GLOO_TIMEOUT)
        mine = {k: torch.from_numpy(v) for k, v in rank_leaves(rank).items()}
        mpw = MPW.Init(mesh)
        link = mpw.CreatePath(comm=CommConfig(streams=2, chunk_mb=0.0625, autotune=False))
        other = mpw.CreatePath(comm=CommConfig(streams=3, chunk_mb=0.125, autotune=False))
        fwd = mpw.CreateForwarder(cosmogrid_topology(), "tokyo", "espoo")
        mpw.setChunkSize(fwd, 1 << 16)
        d = _dims()
        fns = {"Send": lambda t: mpw.Send(link, t, dims=d),
               "Recv": lambda t: mpw.Recv(link, t, dims=d),
               "SendRecv2": lambda t: mpw.SendRecv(link, t, 2, dims=d),
               "ISendRecv": lambda t: mpw.Wait(*mpw.ISendRecv(link, t)),
               "Cycle": lambda t: mpw.Cycle(link, other, t, dims=d),
               "Relay": lambda t: mpw.Relay(link, t, 3, dims=d),
               "Forward": lambda t: mpw.Forward(fwd, t, dims=d),
               "ForwardBack": lambda t: mpw.Forward(fwd, t, dims=d, reverse=True),
               "AllReduceSites": lambda t: mpw.AllReduce(link, t, dims=d,
                                                         site_groups=SITES),
               "AllReduce": lambda t: mpw.AllReduce(link, t, dims=d)}
        res = {}
        for name, fn in fns.items():
            tel.get_telemetry().reset()
            got = fn(mine)
            np.savez(f"{out}/port_{name}_rank{rank}.npz",
                     **{k: v.numpy() for k, v in got.items()})
            res[name] = _norm_keys({k: v["plan"] for k, v in
                                    tel.get_telemetry().report().items()})
        # ISendRecv: the token completes, and Has_NBE_Finished says so
        val, tok = mpw.ISendRecv(link, mine)
        mpw.Wait(val, tok)
        res["finished"] = mpw.Has_NBE_Finished(tok)
        buf = torch.arange(MAX_LEN, dtype=torch.float32) + MAX_LEN * rank
        b, n = mpw.DSendRecv(link, buf, 10 * (rank + 1), MAX_LEN)
        res["DSendRecv"] = {"buf": b.tolist(), "len": int(n)}
        res["Barrier"] = float(mpw.Barrier())
        res["route"] = mpw.Route(fwd)
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tfacade")
    tests = os.path.dirname(os.path.abspath(__file__))
    ref = multidev(f"TESTS = {tests!r}\nOUT = {str(out)!r}\n" + _REF, ndev=4,
                   timeout=600)
    spawn(_port_rank, 4, (f"file://{out}/rdv", str(out)))
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(4)]
    return out, ref, port


def _block(a: np.ndarray, shape: tuple, r: int) -> np.ndarray:
    if shape == ():
        return a[r:r + 1].reshape(())
    return a[r * shape[0]:(r + 1) * shape[0]]


@pytest.mark.parametrize("verb", VERBS)
def test_verb_bit_identical_to_reference(runs, verb):
    out, ref, port = runs
    want = np.load(f"{out}/ref_{verb}.npz")
    for r in range(4):
        got = np.load(f"{out}/port_{verb}_rank{r}.npz")
        for name, (shape, _) in LEAVES.items():
            np.testing.assert_array_equal(got[name], _block(want[name], shape, r),
                                          err_msg=f"{verb} {name} rank {r}")
        assert port[r][verb] == ref[verb], (verb, r)


def test_allreduce_within_reordered_sums(runs):
    out, ref, port = runs
    want = np.load(f"{out}/ref_AllReduce.npz")
    total = {k: sum(rank_leaves(r)[k] for r in range(4)) for k in LEAVES}
    for r in range(4):
        got = np.load(f"{out}/port_AllReduce_rank{r}.npz")
        for name, (shape, _) in LEAVES.items():
            np.testing.assert_allclose(got[name], _block(want[name], shape, r),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got[name], total[name], rtol=1e-6, atol=1e-6)
        assert port[r]["AllReduce"] == ref["AllReduce"]


def test_messages_come_from_the_right_pod(runs):
    """Send and Forward deliver the pod behind's tree, Recv and the reverse
    Forward the pod ahead's, a shift of 2 and a Cycle the one two back."""
    out, _, _ = runs
    src = {"Send": -1, "Recv": 1, "SendRecv2": -2, "ISendRecv": -1, "Cycle": -2,
           "Relay": -3, "Forward": -1, "ForwardBack": 1}
    for verb, delta in src.items():
        for r in range(4):
            got = np.load(f"{out}/port_{verb}_rank{r}.npz")
            np.testing.assert_array_equal(got["a"], rank_leaves((r + delta) % 4)["a"])


def test_dsendrecv_barrier_and_isendrecv_token(runs):
    _, ref, port = runs
    for r in range(4):
        got = port[r]
        assert got["DSendRecv"]["buf"] == ref["DSendRecv"]["buf"][r * MAX_LEN:(r + 1) * MAX_LEN]
        assert got["DSendRecv"]["len"] == ref["DSendRecv"]["len"][r] == 10 * ((r - 1) % 4 + 1)
        assert got["Barrier"] == ref["Barrier"][r] == 4.0
        assert got["finished"] is True
        assert got["route"] == ref["route"]


# -- in process -----------------------------------------------------------------

def _pkg(root: str):
    return (importlib.import_module(f"{root}.core.api").MPW,
            importlib.import_module(f"{root}.configs.base").CommConfig,
            importlib.import_module(f"{root}.core.topology"),
            importlib.import_module(f"{root}.core.path"),
            importlib.import_module(f"{root}.core.telemetry"))


def _session(root: str) -> dict:
    """Drive the host-side verbs of one session; what they return and note."""
    MPW, CommConfig, topo, path, tel = _pkg(root)
    tel.get_telemetry().reset()
    mpw = MPW.Init()
    pid = mpw.CreatePath(nstreams=8)
    var = mpw.CreatePathVariadic(streams_per_hop=(32, 1),
                                 links=[path.WAN_LONDON_POZNAN, path.ICI])
    fwd = mpw.CreateForwarder(topo.cosmogrid_topology(), "tokyo", "espoo")
    out = {"ids": [var - pid, fwd - pid],
           "keys": [re.sub(r"mpw\d+", "mpwN", mpw.path(p).key) for p in (pid, var, fwd)],
           "routes": [mpw.Route(p) for p in (var, fwd)]}
    mpw.setChunkSize(pid, 3 << 20)
    mpw.setPacingRate(pid, 0.5)
    mpw.setAlgorithm(pid, "ring2")
    mpw.setBucketSize(pid, 1 << 22)
    mpw.setWin(var, 1 << 20)
    out["comm"] = [dataclasses.asdict(mpw.path(p).comm) for p in (pid, var)]
    with pytest.raises(ValueError) as e:
        mpw.setAlgorithm(pid, "tree")
    out["algo_error"] = str(e.value)
    mpw.setAutoTuning(pid, True, payload_bytes=64 << 20, online=True, window=2)
    mpw.setAutoTuning(fwd, True, payload_bytes=64 << 20, online=True, window=2)
    retuned = []
    for i in range(8):
        retuned.append(mpw.Observe(pid, 0.5 + 0.1 * (i % 3), nbytes=64 << 20))
        retuned.append(mpw.Observe(fwd, 2.0 + 0.3 * (i % 2), nbytes=64 << 20))
        retuned.append(mpw.Observe(fwd, 1.0 + 0.1 * i, hop=1))
    out["observe"] = retuned
    out["tuned"] = [dataclasses.asdict(mpw.path(p).comm) for p in (pid, fwd)]
    out["hops"] = [dataclasses.asdict(h.comm) for h in mpw.path(fwd).route]
    b = mpw.Serve(pid, max_slots=2, queue_limit=3, kv_bytes=1 << 24, step_s=0.01)
    out["admit"] = [mpw.Admit(pid, 128 + 32 * i, 8) for i in range(6)]
    stats = mpw.ServeStats(pid)
    out["serve"] = {k: v for k, v in stats.items() if k != "timeline"}
    out["timeline"] = stats["timeline"]
    out["batcher"] = type(b).__name__
    out["path_stats"] = sorted(mpw.PathStats(fwd))
    out["hop_stats"] = [sorted(h) for h in mpw.PathStats(fwd)["hops"]]
    out["report"] = sorted(_norm_keys(mpw.Report()))
    out["report_rows"] = {k: sorted(v) for k, v in _norm_keys(mpw.Report()).items()}
    out["formatted"] = re.sub(r"mpw\d+", "mpwN", mpw.Report(formatted=True))
    out["incidents"] = mpw.Incidents()
    out["dns"] = MPW.DNSResolve("tokyo")
    mpw.DestroyPath(var)
    out["left"] = len(mpw.paths)
    mpw.Finalize()
    out["after"] = len(mpw.paths)
    return out


def test_host_verbs_identical_to_reference(monkeypatch):
    # both packages number their paths from the same id: the report sorts
    # its rows by key, and "mpw9" sorts after "mpw10", so ids that earlier
    # tests of the worker left at other counts would reorder the rows
    for root in ("repro", "repro_torch"):
        monkeypatch.setattr(importlib.import_module(f"{root}.core.api"),
                            "_PATH_IDS", itertools.count(100))
    want, got = _session("repro"), _session("repro_torch")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("verb", ["Membership", "setLocalSteps"])
def test_unported_verbs_name_their_item(verb):
    """Both verbs are ported: each does what the reference's does."""
    out = []
    for root in ("repro", "repro_torch"):
        MPW = importlib.import_module(f"{root}.core.api").MPW
        topo = importlib.import_module(f"{root}.core.topology")
        mpw = MPW.Init()
        pid = mpw.CreatePath()
        if verb == "Membership":
            mem = mpw.Membership(topo.cosmogrid_topology(), "amsterdam", lease_steps=2)
            out.append([mpw.membership is mem, mem.lease_steps, mem.epoch, mem.members()])
        else:
            mpw.setLocalSteps(pid, 4)
            with pytest.raises(ValueError) as e:
                mpw.setLocalSteps(pid, 0)
            out.append([mpw.path(pid).comm.local_steps, str(e.value)])
        mpw.Finalize()
    assert out[0] == out[1]


def test_one_pod_messages_return_the_tree():
    from repro_torch.core.api import MPW
    mpw = MPW.Init()
    pid = mpw.CreatePath()
    tree = {"a": torch.ones(3)}
    assert mpw.SendRecv(pid, tree) is tree
    assert mpw.Relay(pid, tree, 2) is tree
    val, tok = mpw.ISendRecv(pid, tree)
    assert mpw.Has_NBE_Finished(tok) and mpw.Wait(val, tok) is tree
    assert float(mpw.Barrier()) == 1.0
