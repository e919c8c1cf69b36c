"""Serving under fault schedules: the port against the JAX package, on the
CPU.

* The scheduler (``core/serving.py``, a copy): the golden serve-chaos
  timeline and incidents of ``tests/test_serve_chaos.py`` (the light path
  drops mid-ship, the KV ship reships, reroutes over the tokyo-edinburgh
  backup and recovers), the decode-site failover on an eviction, and the
  degraded collocated fallback, each identical to the reference's run.
* ``ship_kv`` under a route's fault schedules: a dead hop reshipped then
  rerouted, a corrupting hop reshipped, ``max_reships=0``, a stranded ship
  raising ``ShipError``, for the none and int8 codecs: the same
  ``KVShipResult`` (reships, reroutes, the route taken, modeled seconds),
  the same per-hop telemetry and incidents, and the same bits.
* The engine (``runtime/serving.py``) on the smoke llama3.2-3b with the
  reference's parameters: disaggregated over the CosmoGrid route with its
  backup link and a drop window, the same batcher timeline, stats and
  incidents as the reference's engine and tokens bit-identical to the
  port's own mono run; on a topology with no detour the engine degrades to
  the in-memory handoff and still completes every request, as the
  reference's does.
* ``launch/serve.py --chaos-drop`` on the CPU.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_serve_chaos import GOLDEN_INCIDENTS, GOLDEN_TIMELINE, GOLDEN_TRACE

REPO = Path(__file__).resolve().parents[1]
STEP_S = 0.5
KV_BYTES = 16 << 20


def _mods(root: str):
    m = lambda n: importlib.import_module(f"{root}.{n}")
    return (m("core.topology"), m("core.chaos"), m("core.serving"),
            m("core.membership"), m("core.telemetry"))


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _golden(root: str) -> dict:
    topo_m, chaos, serving, _, tel = _mods(root)
    tel.get_telemetry().reset("serve/req0/kv")
    topo = topo_m.cosmogrid_topology(backup_links=True)
    topo.connect("amsterdam", "tokyo", topo.link("amsterdam", "tokyo").with_fault(
        topo_m.Fault("drop", start=4, stop=60)))
    log = chaos.IncidentLog()
    shipper = serving.FaultAwareShipper(
        topo, "amsterdam", "tokyo", kv_bytes=KV_BYTES, step_s=STEP_S,
        max_reships=1, timeout_s=STEP_S, log=log, seed=0)
    b = serving.ContinuousBatcher(2, 8, prefill_steps=2, step_s=STEP_S,
                                  deadline_steps=200, shipper=shipper, log=log,
                                  prefill_site="amsterdam", decode_site="tokyo")
    stats = b.run(GOLDEN_TRACE)
    row = tel.get_telemetry().path("serve/req0/kv").summary()
    return {"timeline": b.timeline(), "incidents": log.timeline(), "stats": stats,
            "route": list(shipper.route_names), "detoured": shipper.detoured,
            "tel": [row["reships"], row["reroutes"]]}


def _evict(root: str) -> dict:
    topo_m, chaos, serving, membership, _ = _mods(root)
    topo = topo_m.cosmogrid_topology(backup_links=True)
    for a, b in [("amsterdam", "tokyo"), ("tokyo", "edinburgh")]:
        topo.connect(a, b, topo.link(a, b).with_fault(
            topo_m.Fault("drop", start=5, stop=200)))
    log = chaos.IncidentLog()
    shipper = serving.FaultAwareShipper(topo, "amsterdam", "tokyo", kv_bytes=4 << 20,
                                        step_s=STEP_S, max_reships=1, timeout_s=STEP_S,
                                        log=log)
    ms = membership.SiteMembership(topo, "amsterdam", lease_steps=3, log=log)
    b = serving.ContinuousBatcher(2, 8, prefill_steps=2, step_s=STEP_S,
                                  shipper=shipper, log=log, membership=ms,
                                  prefill_site="amsterdam", decode_site="tokyo")
    stats = b.run([(0, 8, 40), (1, 8, 2), (30, 8, 2)])
    return {"timeline": b.timeline(), "incidents": log.timeline(), "stats": stats,
            "decode_site": b._decode_site, "route": list(shipper.route_names)}


def _degrade(root: str) -> dict:
    topo_m, chaos, serving, _, _ = _mods(root)
    topo = topo_m.cosmogrid_topology()
    topo.connect("amsterdam", "tokyo", topo.link("amsterdam", "tokyo").with_fault(
        topo_m.Fault("drop", start=3, stop=1 << 20)))
    log = chaos.IncidentLog()
    shipper = serving.FaultAwareShipper(topo, "amsterdam", "tokyo", kv_bytes=4 << 20,
                                        step_s=STEP_S, max_reships=1, timeout_s=STEP_S,
                                        log=log)
    b = serving.ContinuousBatcher(2, 8, prefill_steps=2, step_s=STEP_S,
                                  shipper=shipper, log=log,
                                  prefill_site="amsterdam", decode_site="tokyo")
    stats = b.run([(0, 8, 3), (4, 8, 2)])
    return {"timeline": b.timeline(), "incidents": log.timeline(), "stats": stats}


@pytest.mark.parametrize("scenario", [_golden, _evict, _degrade],
                         ids=["golden", "decode_failover", "degrade"])
def test_scheduler_scenario_identical_to_reference(scenario):
    want, got = scenario("repro"), scenario("repro_torch")
    assert got == want


def test_scheduler_keeps_the_golden_timeline():
    got = _golden("repro_torch")
    assert got["timeline"] == GOLDEN_TIMELINE
    assert got["incidents"] == GOLDEN_INCIDENTS
    assert (got["stats"]["reships"], got["stats"]["reroutes"]) == (1, 1)
    assert got["route"] == ["amsterdam", "tokyo"] and not got["detoured"]
    assert got["tel"] == [1, 1]
    ev = _evict("repro_torch")
    assert ev["decode_site"] == "espoo" and ev["stats"]["failovers"] == 1
    assert _degrade("repro_torch")["stats"]["degraded"] is True


# ---------------------------------------------------------------------------
# ship_kv under fault schedules
# ---------------------------------------------------------------------------

def _kv(root: str):
    rng = np.random.default_rng(5)
    arrs = {n: rng.standard_normal((4, 24, 2, 8)).astype(np.float32) for n in "kv"}
    if root == "repro":
        import jax.numpy as jnp
        return {n: jnp.asarray(a) for n, a in arrs.items()}
    return {n: torch.from_numpy(a) for n, a in arrs.items()}


# name -> (codec, fault on the light path, ship step, max_reships, backup)
SHIPS = {
    "dead_then_reroute": ("none", ("drop", 3, 9, 1.0, 0.0), 4, 2, True),
    "dead_then_reroute_int8": ("int8", ("drop", 3, 9, 1.0, 0.0), 4, 2, True),
    "dead_window_passes": ("none", ("drop", 3, 5, 1.0, 0.0), 4, 2, True),
    "corrupt_reship": ("none", ("degrade", 0, 50, 0.5, 0.6), 2, 3, True),
    "no_reships": ("int8", ("drop", 0, 50, 1.0, 0.0), 1, 0, True),
    "stranded": ("none", ("drop", 0, 50, 1.0, 0.0), 1, 1, False),
}


def _ship(root: str, name: str) -> dict:
    topo_m, chaos, _, _, tel = _mods(root)
    kvship = importlib.import_module(f"{root}.core.kvship")
    path_m = importlib.import_module(f"{root}.core.path")
    CommConfig = importlib.import_module(f"{root}.configs.base").CommConfig
    codec, (kind, start, stop, factor, err), step, reships, backup = SHIPS[name]
    topo = topo_m.cosmogrid_topology(backup_links=backup)
    topo.connect("amsterdam", "tokyo", topo.link("amsterdam", "tokyo").with_fault(
        topo_m.Fault(kind, start=start, stop=stop, factor=factor, error_rate=err,
                     seed=17)))
    route = topo.route("amsterdam", "tokyo")
    path = path_m.WidePath(axis="pod", name="kvship", hops=route.as_hops(),
                           comm=CommConfig(streams=4, chunk_mb=0.001, compress=codec))
    kv = _kv(root)
    plan = kvship.plan_kv_ship(kv, path)
    rid = 40 + list(SHIPS).index(name)
    t = tel.get_telemetry()
    t.reset()
    log = chaos.IncidentLog()
    try:
        out, res = kvship.ship_kv(kv, plan, rid, step=step, route=route,
                                  max_reships=reships, topo=topo, log=log,
                                  timeout_s=0.5)
    except kvship.ShipError as e:
        return {"error": str(e), "incidents": log.timeline()}
    rep = {k: [v["total_bytes"], v["transfers"], v.get("checksum_errors"),
               v.get("reships"), v.get("reroutes")]
           for k, v in t.report(prefix=f"serve/req{rid}/kv").items()}
    return {"result": [res.wire_bytes_hop, res.wire_bytes_total, res.modeled_s,
                       list(res.per_hop_s), res.n_chunks, res.reships, res.reroutes,
                       list(res.route)],
            "tel": rep, "incidents": log.timeline(),
            "bits": {n: np.asarray(out[n]).tobytes() for n in "kv"}}


@pytest.mark.parametrize("name", list(SHIPS))
def test_ship_kv_under_faults_identical_to_reference(name):
    want, got = _ship("repro", name), _ship("repro_torch", name)
    assert got == want
    if name == "stranded":
        assert got["error"].startswith("req45: no surviving route amsterdam -> tokyo")
    elif name.startswith("dead_then"):
        assert got["result"][5:] == [2, 1, ["amsterdam", "edinburgh", "tokyo"]]


def test_ship_kv_checks_its_arguments():
    from repro_torch.core import kvship
    from repro_torch.core.topology import cosmogrid_topology
    topo = cosmogrid_topology()
    route = topo.route("tokyo", "espoo")
    path = importlib.import_module("repro_torch.core.path").WidePath(
        axis="pod", hops=topo.route("amsterdam", "tokyo").as_hops(), name="kvship")
    kv = _kv("repro_torch")
    plan = kvship.plan_kv_ship(kv, path)
    with pytest.raises(ValueError, match="max_reships must be >= 0, got -1"):
        kvship.ship_kv(kv, plan, 1, step=0, route=route, max_reships=-1)
    with pytest.raises(ValueError, match="route has 2 hops but the plan's path has 1"):
        kvship.ship_kv(kv, plan, 1, step=0, route=route)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    from repro.configs import CommConfig as JComm, RunConfig as JRC
    from repro.configs import ShapeConfig as JShape, TrainConfig as JTrain
    from repro.configs import get_config as jget, smoke_config as jsmoke
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.models.param import tree_init
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig, TrainConfig,
                                     get_config, smoke_config)
    from repro_torch.models.param import params_from_jax
    from test_serving import _requests
    jcfg = jsmoke(jget("llama3.2-3b"))
    jparams = tree_init(build_model(jcfg).param_defs(), 0)
    return {
        "repro": dict(rc=JRC(model=jcfg, shape=JShape("d", 64, 3, "decode"),
                             comm=JComm(), train=JTrain()),
                      mesh=make_local_mesh(), params=jparams, CommConfig=JComm),
        "repro_torch": dict(rc=RunConfig(model=smoke_config(get_config("llama3.2-3b")),
                                         shape=ShapeConfig("d", 64, 3, "decode"),
                                         comm=CommConfig(), train=TrainConfig()),
                            params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
                            CommConfig=CommConfig),
        "reqs": _requests(jcfg)}


def _serve(engines, root: str, backup: bool, drop: tuple, mono: bool = False) -> dict:
    topo_m, chaos, _, _, tel = _mods(root)
    path_m = importlib.import_module(f"{root}.core.path")
    Engine = importlib.import_module(f"{root}.runtime.serving").ServingEngine
    e = engines[root]
    kw = {"device": "cpu"} if root == "repro_torch" else {}
    args = (e["rc"],) if root == "repro_torch" else (e["rc"], e["mesh"])
    reqs = engines["reqs"]
    if mono:
        eng = Engine(*args, mode="mono", params=e["params"], **kw)
    else:
        topo = topo_m.cosmogrid_topology(backup_links=backup)
        topo.connect("amsterdam", "tokyo", topo.link("amsterdam", "tokyo").with_fault(
            topo_m.Fault("drop", start=drop[0], stop=drop[1])))
        route = topo.route("amsterdam", "tokyo")
        path = path_m.WidePath(axis="pod", comm=e["CommConfig"](streams=4, chunk_mb=0.001),
                               hops=route.as_hops(), name="kvship")
        log = chaos.IncidentLog()
        eng = Engine(*args, mode="disagg", path=path, params=e["params"], route=route,
                     topo=topo, log=log, ship_timeout_s=0.5, prefill_site="amsterdam",
                     decode_site="tokyo", **kw)
    t = tel.get_telemetry()
    t.reset()
    for prompt, mnew in reqs:
        assert eng.submit(prompt, mnew) is not None
    stats = eng.run_to_completion()
    out = {"timeline": eng.batcher.timeline(), "stats": stats,
           "results": {r: np.asarray(x).tolist() for r, x in eng.results.items()}}
    if not mono:
        out["incidents"] = log.timeline()
        out["tel"] = {k: v["total_bytes"] for k, v in t.report(prefix="serve").items()
                      if k.startswith("serve/req")}
    return out


DROP = (1, 6)


@pytest.mark.parametrize("backup", [True, False], ids=["reroute", "no_detour"])
def test_engine_under_faults_identical_to_reference(engines, backup):
    want = _serve(engines, "repro", backup, DROP)
    got = _serve(engines, "repro_torch", backup, DROP)
    assert got["timeline"] == want["timeline"]
    assert got["stats"] == want["stats"]
    assert got["incidents"] == want["incidents"]
    assert got["tel"] == want["tel"]
    assert got["stats"]["completed"] == len(engines["reqs"])
    if backup:
        assert got["stats"]["reships"] >= 1 and got["stats"]["reroutes"] >= 1
        assert got["stats"]["degraded"] is False
    else:
        assert got["stats"]["degraded"] is True
        assert any(r["event"] == "degrade" for r in got["incidents"])


def test_engine_tokens_under_faults_are_the_mono_run_s(engines):
    mono = _serve(engines, "repro_torch", True, DROP, mono=True)["results"]
    for backup in (True, False):
        assert _serve(engines, "repro_torch", backup, DROP)["results"] == mono


def test_engine_ship_results_follow_the_hops_taken(engines):
    from repro_torch.core.kvship import plan_kv_ship
    e = engines["repro_torch"]
    got = _serve(engines, "repro_torch", True, DROP)
    cfg = e["rc"].model
    rerouted = 0
    for rid, (prompt, _) in enumerate(engines["reqs"]):
        shape = (cfg.num_layers, len(prompt), cfg.num_kv_heads, cfg.resolved_head_dim)
        kv = {n: torch.empty(shape, dtype=torch.bfloat16, device="meta") for n in "kv"}
        from repro_torch.core.path import WidePath
        plan = plan_kv_ship(kv, WidePath(axis="pod", name="kvship"))
        hops = [k for k in got["tel"] if k.startswith(f"serve/req{rid}/kv/hop")]
        assert all(got["tel"][k] == plan.wire_bytes_hop for k in hops)
        assert got["tel"][f"serve/req{rid}/kv"] == plan.wire_bytes_hop * len(hops)
        rerouted += len(hops) == 2
    assert rerouted >= 1


def test_serve_cli_chaos_drop_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3.2-3b",
         "--smoke", "--device", "cpu", "--engine", "disagg", "--requests", "4",
         "--tokens", "4", "--chaos-drop", "1", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "completed=4" in out.stdout and "degraded=False" in out.stdout
    assert "[serve] incident: step=" in out.stdout and " reroute " in out.stdout
