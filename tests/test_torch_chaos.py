"""The port's chaos layer against the JAX package's: fault schedules, link
health, the detector, the modeled hop seconds, the healing file transfer,
and the Trainer's self-healing reroute and replica failover.

* In process, both packages: every fault-schedule, topology, detector and
  ``simulate_hop_s`` case of ``tests/test_chaos.py`` gives identical
  results (the port's modules are copies of the host-only reference), and
  ``healing_transfer`` heals a copy over a dead light path with the same
  incident timeline, result and file on both engines.
* The training scenarios of ``tests/test_chaos.py`` on the smoke
  qwen1.5-0.5b, the reference once per module on a (pod 4, data 1, model 1)
  mesh of 4 fake CPU devices (its timelines are the (4, 2, 1) mesh's, a
  property of the fault schedules alone), the port on 4 spawned gloo ranks,
  both from the reference's initial state and batches:

  - reroute: the amsterdam-tokyo light path drops at step 4 on the
    CosmoGrid topology with its backup link; the golden timeline (inject 4,
    detect 5, replan 5, retune 5, recover 7) on every rank and in the
    reference, the route amsterdam -> edinburgh -> tokyo after it, the
    port's losses within 1e-6 of its own fault-free run (as the reference's
    test holds its own) and within the tolerances of
    ``test_torch_train_zero.py`` of the reference's at every step, every
    rank's parameters bit-identical, the new route's per-hop plans the
    reference's;
  - failover: tokyo partitioned at step 7 on the plain topology, a
    checkpoint every 5 steps with the replica shipped over the route, 6
    steps, the primary removed, 6 more: inject, detect, failover
    (``outcome: restored``, ``resume_step`` 6), recover on every rank as in
    the reference, the same history of steps;
  - the per-rank monitors' agreement check: a rank whose fault schedule
    differs makes every rank raise ``MembershipDivergence`` at the step
    its monitor decides otherwise, instead of posting other collectives.

Every spawned run gives gloo a 120 s timeout and is joined with a deadline.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import shutil
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import FIRST_STEP_TOL, LOSS_TOL, NORM_RTOL, spawn
from test_torch_train_step import _load_state

GLOO_TIMEOUT = timedelta(seconds=120)
COMM = dict(mode="hierarchical", streams=4, chunk_mb=0.01, autotune=False)
TRAIN = dict(zero1=True, warmup_steps=2, total_steps=50)
REROUTE_STEPS, FAULT_AT = 8, 4
FAILOVER_STEPS, PARTITION_AT, FAILOVER_CKPT_EVERY = 6, 7, 5
N_BATCHES = 24
CHAOS_LOSS_TOL = 1e-6


# ---------------------------------------------------------------------------
# host-only cases, both packages
# ---------------------------------------------------------------------------

def _mods(root: str):
    m = lambda n: importlib.import_module(f"{root}.{n}")
    return (m("core.topology"), m("core.chaos"), m("core.autotune"),
            m("core.telemetry"))


def _wan(topo, name="wan", faults=()):
    return topo.LinkProfile(name, 50e-3, 1e8, window=64 << 10, streams=16,
                            chunk_mb=1.0, faults=tuple(faults))


def _health(h) -> list:
    return [h.alive, h.bandwidth_factor, h.error_rate, h.faulty,
            list(h.partitioned), h.seed]


def _err(fn) -> str:
    try:
        fn()
    except (KeyError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _observe(det, samples) -> list:
    return [det.observe("k", s) for s in samples]


def _case(root: str, name: str):
    topo, chaos, at, _ = _mods(root)
    if name == "health_folding":
        prof = _wan(topo).drop(5, until=9).degrade(0.25, (2, 4), error_rate=0.1)
        return [_health(prof.health(s)) for s in range(11)]
    if name == "active_and_partition":
        f = topo.Fault("drop", start=4)
        prof = _wan(topo).partition("tokyo", at_step=2)
        return [[f.active(s) for s in (3, 4, 10 ** 6)],
                [_health(prof.health(s)) for s in (1, 2)]]
    if name == "degrade_validates":
        return [_err(lambda: _wan(topo).degrade(x, (0, 5))) for x in (0.0, 1.5)]
    if name == "transfer_s":
        nb = 64 << 20
        dead = _wan(topo, faults=[topo.Fault("drop", start=0)])
        slow = _wan(topo, faults=[topo.Fault("degrade", start=0, factor=0.1)])
        return [dead.transfer_s(nb), dead.transfer_s(nb, step=0),
                slow.transfer_s(nb), slow.transfer_s(nb, step=0)]
    if name == "health_seed":
        return [_wan(topo).degrade(0.5, (0, 4), seed=s).health(1).seed
                for s in (7, 7, 8)]
    if name == "reroute_around_failed_link":
        t = topo.cosmogrid_topology(backup_links=True)
        out = [list(t.route("amsterdam", "tokyo").sites)]
        t.fail_link("amsterdam", "tokyo")
        out += [t.is_down("amsterdam", "tokyo"), t.is_down("tokyo", "amsterdam")]
        detour = t.route("amsterdam", "tokyo")
        out += [list(detour.sites), detour.profiles[-1].name]
        t.restore_link("amsterdam", "tokyo")
        return out + [t.down_links(), list(t.route("amsterdam", "tokyo").sites)]
    if name == "site_loss":
        t = topo.cosmogrid_topology(backup_links=True)
        hit = sorted(map(list, t.fail_site("tokyo")))
        return [hit, _err(lambda: t.route("amsterdam", "tokyo")),
                t.route("amsterdam", "espoo").n_hops]
    if name == "plain_has_no_backup":
        t = topo.cosmogrid_topology()
        out = [t.link("tokyo", "edinburgh")]
        t.fail_link("amsterdam", "tokyo")
        return out + [_err(lambda: t.route("amsterdam", "tokyo")),
                      _err(lambda: t.fail_link("amsterdam", "nowhere"))]
    if name == "detector_collapse":
        det = chaos.ChaosDetector(collapse=8.0, window=2, min_baseline=2)
        out = _observe(det, [1.0, 1.1])
        out.append(det.baseline("k"))
        out += _observe(det, [50.0, 50.0, 50.0])
        det.reset("k")
        return out + [det.baseline("k")]
    if name == "detector_timeout":
        det = chaos.ChaosDetector(window=2, min_baseline=2, abs_timeout_s=30.0)
        return [det.observe("dead", 30.0), det.observe("dead", 30.0)]
    if name == "detector_mild_degrade":
        det = chaos.ChaosDetector(collapse=8.0, window=1, min_baseline=2)
        return _observe(det, [1.0, 1.0, 3.0, 3.0])
    if name == "detector_streak":
        det = chaos.ChaosDetector(collapse=8.0, window=3, min_baseline=2)
        return _observe(det, [1.0, 1.0, 20.0, 20.0, 1.0, 20.0, 20.0, 20.0])
    if name == "detector_rearm":
        det = chaos.ChaosDetector(collapse=8.0, window=2, min_baseline=2,
                                  rearm_after=3)
        return _observe(det, [1.0, 1.1, 50.0, 50.0, 50.0, 1.0, 1.0, 50.0,
                              1.0, 1.0, 1.0, 50.0, 50.0])
    if name == "simulate_degrade_window":
        prof = topo.LinkProfile("metro", 1e-3, 1e8, window=64 << 10, streams=16,
                                chunk_mb=1.0).degrade(0.05, (3, 6))
        nb = 64 << 20
        secs = [at.simulate_hop_s(nb, prof, s) for s in range(10)]
        det = chaos.ChaosDetector(collapse=4.0, window=2, min_baseline=2,
                                  abs_timeout_s=30.0)
        fired = [s for s, x in enumerate(secs) if det.observe("hop", x)]
        return [secs, fired]
    if name == "simulate_dead_link":
        prof = _wan(topo).drop(2)
        return [at.simulate_hop_s(1 << 20, prof, s, timeout_s=30.0) for s in (1, 2)]
    raise KeyError(name)


HOST_CASES = ("health_folding", "active_and_partition", "degrade_validates",
              "transfer_s", "health_seed", "reroute_around_failed_link",
              "site_loss", "plain_has_no_backup", "detector_collapse",
              "detector_timeout", "detector_mild_degrade", "detector_streak",
              "detector_rearm", "simulate_degrade_window", "simulate_dead_link")


@pytest.mark.parametrize("case", HOST_CASES)
def test_host_case_identical_to_reference(case):
    want, got = _case("repro", case), _case("repro_torch", case)
    assert json.dumps(got, default=str) == json.dumps(want, default=str), (got, want)


def test_host_cases_keep_the_reference_goldens():
    assert _case("repro_torch", "detector_collapse") == [
        False, False, pytest.approx(1.05), False, True, False, None]
    secs, fired = _case("repro_torch", "simulate_degrade_window")
    assert fired == [4] and secs[4] > 5 * secs[0]
    assert _case("repro_torch", "simulate_dead_link")[1] == 30.0
    assert math.isinf(_case("repro_torch", "transfer_s")[1])


def _healing_copy(root: str, tmp, backup: bool):
    topo, chaos, _, tel = _mods(root)
    CommConfig = importlib.import_module(f"{root}.configs.base").CommConfig
    ft = importlib.import_module(f"{root}.core.filetransfer")
    log = chaos.IncidentLog()
    tel.get_telemetry().reset()
    t = topo.cosmogrid_topology(backup_links=backup)
    t.connect("amsterdam", "tokyo", t.link("amsterdam", "tokyo").drop(0))
    eng = chaos.healing_transfer(t, "amsterdam", "tokyo", log=log,
                                 comm=CommConfig(streams=4, chunk_mb=0.0625),
                                 max_retries=1)
    os.makedirs(tmp, exist_ok=True)
    src, dst = os.path.join(tmp, "src.bin"), os.path.join(tmp, "dst.bin")
    with open(src, "wb") as f:
        f.write(bytes((123 + i * 31) % 256 for i in range(1 << 20)))
    try:
        res = eng.copy(src, dst)
    except ft.ChecksumError as e:
        return {"error": type(e).__name__, "timeline": log.timeline()}
    with open(dst, "rb") as f:
        data = f.read()
    return {"timeline": log.timeline(), "data": data,
            "res": [res.reroutes, res.retries, res.wire_bytes, res.nbytes,
                    res.sha256, res.reroute_history]}


@pytest.mark.parametrize("backup", [True, False], ids=["detour", "no_detour"])
def test_healing_transfer_identical_on_both_engines(tmp_path, backup):
    want = _healing_copy("repro", str(tmp_path / "ref"), backup)
    got = _healing_copy("repro_torch", str(tmp_path / "port"), backup)
    assert got == want
    kinds = [r["event"] for r in got["timeline"]]
    if backup:
        assert got["res"][0] == 1 and got["data"] == open(tmp_path / "ref" / "src.bin", "rb").read()
        assert kinds[:4] == ["inject", "detect", "replan", "requeue"]
    else:
        assert got["error"] == "ChecksumError" and "replan" not in kinds


# ---------------------------------------------------------------------------
# the Trainer's reroute and failover, against the reference
# ---------------------------------------------------------------------------

_REF = r"""
import json, os, shutil, sys
import numpy as np
import jax
from repro.checkpoint import store
from repro.configs import (get_config, smoke_config, RunConfig, ShapeConfig,
                           CommConfig, TrainConfig)
from repro.core import (cosmogrid_topology, ChaosMonitor, ChaosDetector,
                        get_incident_log, get_telemetry)
from repro.models.registry import batch_concrete
from repro.runtime import Trainer
sys.path.insert(0, TESTS)
from test_torch_chaos import (COMM, TRAIN, REROUTE_STEPS, FAULT_AT, FAILOVER_STEPS,
                              PARTITION_AT, FAILOVER_CKPT_EVERY, N_BATCHES)

cfg = smoke_config(get_config("qwen1.5-0.5b"))
rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
               comm=CommConfig(**COMM), train=TrainConfig(**TRAIN))
mesh = jax.make_mesh((4, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=90 + i)["tokens"])
        for i in range(N_BATCHES)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
batches = lambda: iter([{"tokens": t} for t in toks])
log = get_incident_log()

def timeline():
    return [[e.kind, e.subject, e.step, dict(e.detail)] for e in log.events()]

res = {}
with jax.set_mesh(mesh):
    t0 = cosmogrid_topology(backup_links=True)
    ctr = Trainer(rc, mesh, route=t0.route("amsterdam", "tokyo"),
                  site_groups=t0.pod_groups())
    ctr.init_or_restore()
    flat = {}
    for kp, a in jax.tree_util.tree_leaves_with_path(ctr.state):
        a = np.asarray(a)
        key = jax.tree_util.keystr(kp)
        flat[("bf16" if a.dtype.name == "bfloat16" else "") + key] = (
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    np.savez(f"{OUT}/state0.npz", **flat)
    ref = ctr.run(batches(), REROUTE_STEPS, log_every=0)

    log.clear()
    get_telemetry().reset()
    t1 = cosmogrid_topology(backup_links=True)
    t1.connect("amsterdam", "tokyo", t1.link("amsterdam", "tokyo").drop(FAULT_AT))
    mon = ChaosMonitor(t1, "amsterdam", "tokyo",
                       detector=ChaosDetector(window=2, min_baseline=2), recover_after=2)
    tr = Trainer(rc, mesh, route=t1.route("amsterdam", "tokyo"),
                 site_groups=t1.pod_groups(), chaos=mon)
    tr.init_or_restore()
    hist = tr.run(batches(), REROUTE_STEPS, log_every=0, log=lambda _: None)
    key = tr.bundle.path.key
    res["reroute"] = {
        "control": [h["loss"] for h in ref], "losses": [h["loss"] for h in hist],
        "norms": [h["grad_norm"] for h in hist], "timeline": timeline(),
        "route": list(tr.route.sites), "key": key,
        "hop_plans": {k: v["plan"] for k, v in get_telemetry().report(prefix=key).items()
                      if "/hop" in k}}

    log.clear()
    t = cosmogrid_topology()
    t.connect("amsterdam", "tokyo",
              t.link("amsterdam", "tokyo").partition("tokyo", at_step=PARTITION_AT))
    mon = ChaosMonitor(t, "amsterdam", "tokyo",
                       detector=ChaosDetector(window=2, min_baseline=2), recover_after=2)
    primary, replica = f"{OUT}/ref_ck", f"{OUT}/ref_rep"
    tr = Trainer(rc, mesh, route=t.route("amsterdam", "tokyo"),
                 site_groups=t.pod_groups(), ckpt_dir=primary, replica_dir=replica,
                 ckpt_every=FAILOVER_CKPT_EVERY, chaos=mon)
    tr.init_or_restore()
    it = batches()
    h1 = tr.run(it, FAILOVER_STEPS, log_every=0, log=lambda _: None)
    shutil.rmtree(primary)
    h2 = tr.run(it, FAILOVER_STEPS, log_every=0, log=lambda _: None)
    tr.close()
    res["failover"] = {"timeline": timeline(), "route": tr.route,
                       "steps": [h["step"] for h in h1 + h2],
                       "losses": [h["loss"] for h in h1 + h2],
                       "recovery": log.recovery_latencies(), "final": tr.step}
print("RESULT:" + json.dumps(res))
"""


def _timeline(log) -> list:
    return [[e.kind, e.subject, e.step, dict(e.detail)] for e in log.events()]


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import (ChaosDetector, ChaosMonitor, cosmogrid_topology,
                                  get_incident_log, get_telemetry)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.train_loop import MembershipDivergence
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=4, device="cpu", timeout=GLOO_TIMEOUT)
        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                       comm=CommConfig(**COMM), train=TrainConfig(**TRAIN))
        toks = np.load(f"{out}/tokens.npy")
        full = _load_state(f"{out}/state0.npz")
        batches = lambda: iter([{"tokens": t} for t in toks])
        log = get_incident_log()
        quiet = lambda *_: None

        def trainer(topo, **kw):
            tr = Trainer(rc, mesh, route=topo.route("amsterdam", "tokyo"),
                         site_groups=topo.pod_groups(), check_replicas=True, **kw)
            tr.init_or_restore()
            tr.state = state_from_jax(full, "cpu")
            return tr

        def monitor(topo):
            return ChaosMonitor(topo, "amsterdam", "tokyo",
                                detector=ChaosDetector(window=2, min_baseline=2),
                                recover_after=2)

        res = {}
        ctr = trainer(cosmogrid_topology(backup_links=True))
        control = ctr.run(batches(), REROUTE_STEPS, log_every=0)
        log.clear()
        get_telemetry().reset()
        t1 = cosmogrid_topology(backup_links=True)
        t1.connect("amsterdam", "tokyo", t1.link("amsterdam", "tokyo").drop(FAULT_AT))
        tr = trainer(t1, chaos=monitor(t1))
        hist = tr.run(batches(), REROUTE_STEPS, log_every=0, log=quiet)
        key = tr.bundle.path.key
        res["reroute"] = {
            "control": [h["loss"] for h in control], "losses": [h["loss"] for h in hist],
            "norms": [h["grad_norm"] for h in hist], "sums": [h["checksum"] for h in hist],
            "routes": [h["route"] for h in hist], "timeline": _timeline(log),
            "route": list(tr.route.sites), "key": key,
            "hop_plans": {k: v["plan"] for k, v in get_telemetry().report(prefix=key).items()
                          if "/hop" in k}}

        log.clear()
        t = cosmogrid_topology()
        t.connect("amsterdam", "tokyo",
                  t.link("amsterdam", "tokyo").partition("tokyo", at_step=PARTITION_AT))
        primary, replica = f"{out}/port_ck", f"{out}/port_rep"
        tr = trainer(t, chaos=monitor(t), ckpt_dir=primary, replica_dir=replica,
                     ckpt_every=FAILOVER_CKPT_EVERY)
        it = batches()
        h1 = tr.run(it, FAILOVER_STEPS, log_every=0, log=quiet)
        dist.barrier()
        if rank == 0:
            # the mirror dies with the site: a pass racing the removal would
            # prune the replica (ROADMAP.md §C 15)
            tr.manager.gatherer.stop()
            shutil.rmtree(primary)
        dist.barrier()
        h2 = tr.run(it, FAILOVER_STEPS, log_every=0, log=quiet)
        tr.close()
        res["failover"] = {"timeline": _timeline(log), "route": tr.route,
                           "steps": [h["step"] for h in h1 + h2],
                           "losses": [h["loss"] for h in h1 + h2],
                           "sums": [h["checksum"] for h in h1 + h2],
                           "recovery": log.recovery_latencies(), "final": tr.step}

        # rank 3 alone sees the light path die: its monitor reroutes at
        # step 1, and every rank raises instead of posting other collectives
        t = cosmogrid_topology(backup_links=True)
        if rank == 3:
            t.connect("amsterdam", "tokyo", t.link("amsterdam", "tokyo").drop(0))
        tr = trainer(t, chaos=monitor(t))
        try:
            tr.run(batches(), 3, log_every=0, log=quiet)
            res["divergence"] = None
        except MembershipDivergence as e:
            res["divergence"] = [len(tr.history), str(e)]
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tchaos")
    tests = os.path.dirname(os.path.abspath(__file__))
    ref = multidev(f"TESTS = {tests!r}\nOUT = {str(out)!r}\n" + _REF, ndev=4,
                   timeout=900)
    spawn(_port_rank, 4, (f"file://{out}/rdv", str(out)))
    return ref, [json.load(open(f"{out}/port_rank{r}.json")) for r in range(4)]


GOLDEN_REROUTE = [("inject", 4), ("detect", 5), ("replan", 5), ("retune", 5),
                  ("recover", 7)]


def test_reroute_timeline_is_the_reference_on_every_rank(runs):
    ref, port = runs
    want = ref["reroute"]["timeline"]
    assert [(k, s) for k, _, s, _ in want] == GOLDEN_REROUTE
    for r in range(4):
        assert port[r]["reroute"]["timeline"] == want, r


def test_reroute_route_and_losses(runs):
    ref, port = runs
    want = ref["reroute"]
    assert want["route"] == ["amsterdam", "edinburgh", "tokyo"]
    for r in range(4):
        got = port[r]["reroute"]
        assert got["route"] == want["route"]
        assert got["routes"][FAULT_AT] == ["amsterdam", "tokyo"]  # still direct
        assert got["routes"][FAULT_AT + 1] == want["route"]       # replanned at 5
        # the detour changes the chunking, not the sums
        assert max(abs(a - b) for a, b in zip(got["losses"], got["control"])) \
            <= CHAOS_LOSS_TOL
        assert abs(got["losses"][0] - want["losses"][0]) <= FIRST_STEP_TOL
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= LOSS_TOL, (got["losses"], want["losses"])
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL)
    assert max(abs(a - b) for a, b in zip(want["losses"], want["control"])) \
        <= CHAOS_LOSS_TOL


def test_reroute_replicas_and_hop_plans(runs):
    ref, port = runs
    want = ref["reroute"]
    sums = [port[r]["reroute"]["sums"] for r in range(4)]
    assert sums[0] == sums[1] == sums[2] == sums[3]
    key = want["key"]
    assert sorted(want["hop_plans"]) == [f"{key}/hop0:amsterdam->edinburgh",
                                         f"{key}/hop1:edinburgh->tokyo"]
    for r in range(4):
        assert port[r]["reroute"]["key"] == key
        assert port[r]["reroute"]["hop_plans"] == want["hop_plans"], r


def test_failover_timeline_is_the_reference_on_every_rank(runs):
    ref, port = runs
    want = ref["failover"]
    assert [k for k, *_ in want["timeline"]] == ["inject", "detect", "failover",
                                                 "recover"]
    fo = next(d for k, _, _, d in want["timeline"] if k == "failover")
    assert fo == {"outcome": "restored", "resume_step": 6}
    for r in range(4):
        got = port[r]["failover"]
        assert got["timeline"] == want["timeline"], r
        assert got["route"] is None and want["route"] is None
        assert got["recovery"] == want["recovery"] and got["recovery"][0][1] > 0


def test_failover_history_is_the_reference(runs):
    ref, port = runs
    want = ref["failover"]
    for r in range(4):
        got = port[r]["failover"]
        # the rollback shows as repeated step numbers
        assert got["steps"] == want["steps"] and got["final"] == want["final"]
        assert min(got["steps"][FAILOVER_STEPS:]) <= FAILOVER_STEPS
        assert all(math.isfinite(x) for x in got["losses"])
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= LOSS_TOL, (got["losses"], want["losses"])
    sums = [port[r]["failover"]["sums"] for r in range(4)]
    assert sums[0] == sums[1] == sums[2] == sums[3]


def test_monitors_that_disagree_raise_on_every_rank(runs):
    _, port = runs
    for r in range(4):
        n, msg = port[r]["divergence"]
        assert n == 1, (r, msg)                 # step 0 ran, step 1 decided otherwise
        assert msg.startswith("step 1: rank ") and "'route'" in msg
        assert "'edinburgh'" in msg


@pytest.mark.parametrize("root", ["repro", "repro_torch"])
def test_mirror_pass_racing_the_primary_removal_prunes_the_replica(tmp_path, root):
    """A fault of the reference's mirror, copied by the port (ROADMAP.md
    §C 15): a pass whose source vanishes between its copies and its prune
    takes every replica entry for deleted and removes it, the very replica
    a site loss should restore from.  So the chaos scenarios stop the
    mirror before they remove the primary."""
    replicate = importlib.import_module(f"{root}.checkpoint.replicate")
    src, dst = tmp_path / "ck", tmp_path / "rep"
    (src / "step_1").mkdir(parents=True)
    (src / "step_1" / "a.bin").write_bytes(b"a" * 64)
    assert replicate.sync_once(str(src), str(dst)) == 1
    (src / "step_2").mkdir()
    (src / "step_2" / "b.bin").write_bytes(b"b" * 64)

    class SiteLostMidPass:
        def copy(self, s, t, resume=False):
            shutil.copyfile(s, t)
            shutil.rmtree(src)          # the primary dies during the pass

    assert replicate.sync_once(str(src), str(dst), transfer=SiteLostMidPass()) == 1
    assert not src.exists()
    assert sorted(p.name for p in dst.rglob("*.bin")) == []
