"""Training over a Forwarder route, with checkpoints and fault recovery, on 4
gloo ranks against the JAX package on 4 fake CPU devices, and the
launcher's route and checkpoint flags.

The route is the CosmoGrid topology's tokyo -> espoo (no direct link: 2
hops through Amsterdam, pod shifts -1 and 2), on a (pod 4, data 1) mesh of
the smoke qwen1.5-0.5b.

* ``build_train_step(route=...)``: 2 steps with no codec and with int8 from
  the reference's initial state and batches; the losses and ``grad_norm``
  within the tolerances of ``test_torch_sites.py`` (the reference's
  4-pod sums run in another order, and its jitted int8 codec is XLA's
  arithmetic, ROADMAP.md §C 5), every rank's parameters bit-identical, and
  the sync's plan and both per-hop plans equal to the reference's field
  for field.
* ``Trainer(ckpt_dir=, replica_dir=, ckpt_every=2, keep=1, fault_hook=,
  retry=, route=, site_groups=)``: both packages start from the reference's
  initial state, written once as a step-0 checkpoint in the reference's
  format, and take the same batches; a fault at step 3 (on rank 1 alone in
  the port) makes every rank restore the step-2 checkpoint.  The histories
  must have the same steps (0, 1, 2, 2, 3, 4) and losses within the same
  tolerances; the port's replica holds the final checkpoint, shipped over
  the route with per-hop ``ckpt:*`` telemetry.
* ``launch/train.py``: ``--route``, ``--ckpt-dir`` (a second run restores)
  and ``--replica-dir``, one test each, and ``--route`` refused off 4 pods.

Every spawned run gives gloo a 120 s timeout and is joined with a
deadline.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import (FIRST_STEP_TOL, LOSS_TOL, NORM_RTOL, TRAIN,
                              spawn)
from test_torch_train_step import _load_state

GLOO_TIMEOUT = timedelta(seconds=120)
STEPS = 2
CODECS = ("none", "int8")
STEP_COMM = dict(mode="hierarchical", streams=2, chunk_mb=0.01, autotune=False)
RUN_STEPS = 5
FAULT_STEP = 3
N_BATCHES = 7            # steps 0-2, the failed step 3, steps 2-4 again
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = r"""
import json, os, shutil, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import store
from repro.configs import (get_config, smoke_config, RunConfig, ShapeConfig,
                           CommConfig, TrainConfig)
from repro.core import telemetry as tel
from repro.core.retry import RetryPolicy
from repro.core.topology import cosmogrid_topology
from repro.models.registry import batch_concrete
from repro.runtime import InjectedFault, Trainer
from repro.runtime.step import build_train_step
sys.path.insert(0, TESTS)
from test_torch_train_route import (CODECS, FAULT_STEP, N_BATCHES, RUN_STEPS,
                                    STEPS, STEP_COMM, TRAIN)

cfg = smoke_config(get_config("qwen1.5-0.5b"))
mesh = jax.make_mesh((4, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
topo = cosmogrid_topology()
route = topo.route("tokyo", "espoo")
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=60 + i)["tokens"])
        for i in range(N_BATCHES)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
res = {"steps": {}}
for c in CODECS:
    tel.get_telemetry().reset()
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                   comm=CommConfig(compress=c, **STEP_COMM), train=TrainConfig(**TRAIN))
    with jax.set_mesh(mesh):
        b = build_train_step(rc, mesh, route=route)
        sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda x: isinstance(x, P))
        state0 = b.init_state(0)
        if not res["steps"]:
            flat = {}
            for kp, a in jax.tree_util.tree_leaves_with_path(state0):
                a = np.asarray(a)
                key = jax.tree_util.keystr(kp)
                flat[("bf16" if a.dtype.name == "bfloat16" else "") + key] = (
                    a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
            np.savez(f"{OUT}/state0.npz", **flat)
            store.save(state0, f"{OUT}/init/step_00000000", step=0)
        state = jax.device_put(state0, sh(b.state_specs))
        losses, norms = [], []
        for i in range(STEPS):
            batch = jax.device_put({"tokens": jnp.asarray(toks[i])}, sh(b.batch_specs))
            state, m = b.fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    rep = tel.get_telemetry().report(prefix=b.path.key)
    res["steps"][c] = {"losses": losses, "norms": norms, "key": b.path.key,
                       "plans": {k: v["plan"] for k, v in rep.items()}}

# the Trainer: checkpoints, a replica over the route, a fault at step 3
fired = []
def hook(step):
    if step == FAULT_STEP and not fired:
        fired.append(step)
        raise InjectedFault("boom")
rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
               comm=CommConfig(compress="none", **STEP_COMM), train=TrainConfig(**TRAIN))
shutil.copytree(f"{OUT}/init", f"{OUT}/ref_ckpt")
logs = []
with jax.set_mesh(mesh):
    tr = Trainer(rc, mesh, ckpt_dir=f"{OUT}/ref_ckpt", replica_dir=f"{OUT}/ref_replica",
                 ckpt_every=2, keep=1, fault_hook=hook, retry=RetryPolicy(max_attempts=3),
                 route=route, site_groups=topo.pod_groups())
    how = tr.init_or_restore()
    hist = tr.run(iter([{"tokens": t} for t in toks]), RUN_STEPS, log_every=0,
                  log=logs.append)
    tr.close()
res["trainer"] = {"how": how, "steps": [h["step"] for h in hist],
                  "losses": [h["loss"] for h in hist],
                  "norms": [h["grad_norm"] for h in hist], "final": tr.step,
                  "logs": logs, "replica": sorted(os.listdir(f"{OUT}/ref_replica"))}
print("RESULT:" + json.dumps(res))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import telemetry as tel
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.core.topology import cosmogrid_topology
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime import InjectedFault, Trainer
    from repro_torch.runtime.step import build_train_step
    from repro_torch.runtime.train_loop import replica_checksum
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=4, device="cpu", timeout=GLOO_TIMEOUT)
        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        topo = cosmogrid_topology()
        route = topo.route("tokyo", "espoo")
        toks = np.load(f"{out}/tokens.npy")
        full = _load_state(f"{out}/state0.npz")
        res = {"steps": {}}
        for c in CODECS:
            tel.get_telemetry().reset()
            rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                           comm=CommConfig(compress=c, **STEP_COMM),
                           train=TrainConfig(**TRAIN))
            b = build_train_step(rc, mesh, route=route)
            state = state_from_jax(full, "cpu")
            rec = {"losses": [], "norms": [], "sums": [], "key": b.path.key}
            for i in range(STEPS):
                rows = torch.as_tensor(toks[i][2 * rank:2 * rank + 2], dtype=torch.int64)
                state, m = b.fn(state, {"tokens": rows})
                rec["losses"].append(float(m["loss"]))
                rec["norms"].append(float(m["grad_norm"]))
                rec["sums"].append(replica_checksum(state["params"]))
            rep = tel.get_telemetry().report(prefix=b.path.key)
            rec["plans"] = {k: v["plan"] for k, v in rep.items()}
            res["steps"][c] = rec

        fired = []

        def hook(step):
            if step == FAULT_STEP and not fired:
                fired.append(step)
                if rank == 1:
                    raise InjectedFault("boom")
        tel.get_telemetry().reset()
        rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                       comm=CommConfig(compress="none", **STEP_COMM),
                       train=TrainConfig(**TRAIN))
        if rank == 0:
            shutil.copytree(f"{out}/init", f"{out}/port_ckpt")
        dist.barrier()
        logs: list = []
        tr = Trainer(rc, mesh, ckpt_dir=f"{out}/port_ckpt",
                     replica_dir=f"{out}/port_replica", ckpt_every=2, keep=1,
                     fault_hook=hook, retry=RetryPolicy(max_attempts=3), route=route,
                     site_groups=topo.pod_groups(), check_replicas=True)
        how = tr.init_or_restore()
        hist = tr.run(iter([{"tokens": t} for t in toks]), RUN_STEPS, log_every=0,
                      log=logs.append)
        tr.close()
        res["trainer"] = {
            "how": how, "steps": [h["step"] for h in hist],
            "losses": [h["loss"] for h in hist], "norms": [h["grad_norm"] for h in hist],
            "sums": [h["checksum"] for h in hist], "final": tr.step, "logs": logs,
            "ckpt_wire": {k: v["total_bytes"] for k, v in tel.get_telemetry().report().items()
                          if k.startswith("ckpt:")}}
        if rank == 0:
            res["trainer"]["replica"] = sorted(os.listdir(f"{out}/port_replica"))
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


REF_TIMEOUT_S = 900


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    """The reference's run (a multidev subprocess on 4 fake devices), then
    the port's 4 ranks.  A failure names its stage: the reference (its
    output's tail, or its timeout), a rank of the port (``spawn`` names it,
    how it ended and when), or a rank's missing report."""
    out = tmp_path_factory.mktemp("troute")
    tests = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    try:
        ref = multidev(f"TESTS = {tests!r}\nOUT = {str(out)!r}\n" + _REF, ndev=4,
                       timeout=REF_TIMEOUT_S)
    except (AssertionError, subprocess.TimeoutExpired) as e:
        pytest.fail(f"the reference's run failed after {time.monotonic() - t0:.1f} "
                    f"s (timeout {REF_TIMEOUT_S} s): {e}")
    spawn(_port_rank, 4, (f"file://{out}/rdv", str(out)))
    missing = [r for r in range(4) if not os.path.exists(f"{out}/port_rank{r}.json")]
    if missing:
        pytest.fail(f"the port's ranks {missing} ended without writing their "
                    f"report; {out} holds {sorted(os.listdir(out))}")
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(4)]
    return out, ref, port


def _close(got: list, want: list) -> None:
    assert all(np.isfinite(got)), got
    assert abs(got[0] - want[0]) <= FIRST_STEP_TOL, (got, want)
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_TOL, (got, want)


@pytest.mark.parametrize("codec", CODECS)
def test_route_train_step_tracks_reference(runs, codec):
    _, ref, port = runs
    want = ref["steps"][codec]
    for r in range(4):
        got = port[r]["steps"][codec]
        _close(got["losses"], want["losses"])
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL)
    sums = [port[r]["steps"][codec]["sums"] for r in range(4)]
    assert sums[0] == sums[1] == sums[2] == sums[3], sums


@pytest.mark.parametrize("codec", CODECS)
def test_route_train_step_plans_match_reference(runs, codec):
    _, ref, port = runs
    want = ref["steps"][codec]
    key = want["key"]
    assert key == "train:ams-espoo"            # the bottleneck hop's link
    assert sorted(want["plans"]) == [key, f"{key}/hop0:tokyo->amsterdam",
                                     f"{key}/hop1:amsterdam->espoo"]
    for r in range(4):
        got = port[r]["steps"][codec]
        assert got["key"] == key
        assert got["plans"] == want["plans"], r


def test_trainer_recovers_like_reference(runs):
    _, ref, port = runs
    want = ref["trainer"]
    assert want["steps"] == [0, 1, 2, 2, 3, 4] and want["final"] == RUN_STEPS
    for r in range(4):
        got = port[r]["trainer"]
        assert got["how"] == want["how"] == "restored"
        assert got["steps"] == want["steps"] and got["final"] == want["final"]
        _close(got["losses"], want["losses"])
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=NORM_RTOL)
        # the same recovery line, the fault named by the rank that saw it
        assert [line.split(":")[0] for line in got["logs"]] == \
            [line.split(":")[0] for line in want["logs"]] == ["[fault] step 3"]
        assert "restoring latest checkpoint (backoff" in got["logs"][0]
    sums = [port[r]["trainer"]["sums"] for r in range(4)]
    assert sums[0] == sums[1] == sums[2] == sums[3]


def test_trainer_replica_ships_over_the_route(runs):
    _, ref, port = runs
    got = port[0]["trainer"]
    assert got["replica"] == ref["trainer"]["replica"] == ["step_00000005"]
    hops = {k: v for k, v in got["ckpt_wire"].items() if "/hop" in k}
    assert sorted(hops) == ["ckpt:ams-espoo/hop0:tokyo->amsterdam",
                            "ckpt:ams-espoo/hop1:amsterdam->espoo"]
    assert all(v > 0 for v in hops.values())
    # only rank 0 writes and ships
    assert not any(port[r]["trainer"]["ckpt_wire"] for r in (1, 2, 3))


def test_fault_budget_exhausted_raises(tmp_path):
    """A fault on every try of a step: the retry policy's budget runs out
    and the fault propagates, as in the reference."""
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import InjectedFault, Trainer

    def hook(step):
        if step == 1:
            raise InjectedFault("always")
    rc = RunConfig(model=smoke_config(get_config("qwen1.5-0.5b")),
                   shape=ShapeConfig("t", 16, 2, "train"),
                   comm=CommConfig(mode="hierarchical", autotune=False),
                   train=TrainConfig())
    tr = Trainer(rc, make_local_mesh(device="cpu"), ckpt_dir=str(tmp_path / "c"),
                 ckpt_every=1, fault_hook=hook, retry=RetryPolicy(max_attempts=3))
    tr.init_or_restore(0)
    toks = np.random.default_rng(0).integers(0, 100, (2, 17))
    logs: list = []
    with pytest.raises(InjectedFault, match="always"):
        tr.run(iter([toks] * 8), 3, log_every=0, log=logs.append)
    assert len(logs) == 3 and "recovery budget exhausted (3 attempts)" in logs[-1]
    assert [h["step"] for h in tr.history] == [0]
    tr.close()


def test_fault_without_checkpoint_raises():
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import InjectedFault, Trainer

    def hook(step):
        raise InjectedFault("no checkpoint")
    rc = RunConfig(model=smoke_config(get_config("qwen1.5-0.5b")),
                   shape=ShapeConfig("t", 16, 2, "train"),
                   comm=CommConfig(mode="hierarchical", autotune=False),
                   train=TrainConfig())
    tr = Trainer(rc, make_local_mesh(device="cpu"), fault_hook=hook)
    tr.init_or_restore(0)
    with pytest.raises(RuntimeError, match="no checkpoint to restore from"):
        tr.run(iter([np.zeros((2, 17), np.int64)]), 1, log_every=0, log=lambda _: None)


# -- the launcher's flags ------------------------------------------------------

def _launch(args: list, tmp_path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--smoke", "--device", "cpu", "--seq-len", "32", "--compress", "int8",
         *args], env=env, capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    return out


def test_launcher_route_flag(tmp_path):
    out = _launch(["--pods", "4", "--steps", "2", "--route", "tokyo:espoo",
                   "--check-replicas", "--report", str(tmp_path / "run")], tmp_path)
    assert ("[train] WAN route: tokyo --[ams-tokyo-lightpath]--> amsterdam "
            "--[ams-espoo]--> espoo") in out.stdout
    assert "[train] done: loss" in out.stdout
    rep = json.load(open(tmp_path / "run.rank0.json"))
    assert sorted(rep["hop_plans"]) == ["train:ams-espoo/hop0:tokyo->amsterdam",
                                        "train:ams-espoo/hop1:amsterdam->espoo"]
    assert all(p["algo"] == "shift" for p in rep["hop_plans"].values())


def test_launcher_ckpt_dir_flag(tmp_path):
    ck = str(tmp_path / "ck")
    first = _launch(["--pods", "2", "--steps", "2", "--ckpt-dir", ck,
                     "--ckpt-every", "1"], tmp_path)
    assert "[train] initialized at step 0" in first.stdout
    assert sorted(os.listdir(ck)) == ["step_00000001", "step_00000002"]
    again = _launch(["--pods", "2", "--steps", "1", "--ckpt-dir", ck], tmp_path)
    assert "[train] restored at step 2" in again.stdout
    assert "step_00000003" in os.listdir(ck)


def test_launcher_replica_dir_flag(tmp_path):
    ck, rp = str(tmp_path / "ck"), str(tmp_path / "rp")
    _launch(["--pods", "2", "--steps", "2", "--ckpt-dir", ck, "--replica-dir", rp],
            tmp_path)
    assert os.listdir(rp) == ["step_00000002"]
    assert sorted(os.listdir(os.path.join(rp, "step_00000002"))) == \
        sorted(os.listdir(os.path.join(ck, "step_00000002")))


def test_launcher_route_needs_four_pods():
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit, match="needs --pods 4"):
        main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
              "--pods", "2", "--route", "tokyo:espoo"])
    with pytest.raises(SystemExit, match="is not SRC:DST"):
        main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
              "--pods", "4", "--route", "tokyo"])
