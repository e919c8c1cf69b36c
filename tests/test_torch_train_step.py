"""The port's training step on 2 pods against the JAX package's, on the CPU,
and the training launcher end to end.

The reference runs ``build_train_step`` at ``smoke_config(get_config(
"llama3.2-3b"))`` on a (pod 2, data 1, model 1) mesh of 2 fake CPU devices
(a subprocess); the port runs its ``build_train_step`` on 2 spawned gloo
ranks, from the reference's own initial state (``state_from_jax``) and the
reference's batches, pod r taking rows [4r, 4r + 4) of each global batch of
8, as ``P(dp)`` gives them to the reference.  Knobs are fixed
(``CommConfig(autotune=False)``): the port's autotuner warm-starts from the
H100's compute window and the reference's from its TPU's.

Tolerances: the first step's loss within 5e-3 (bf16 parameters and
activations, rounded at places that differ between XLA and PyTorch, at the
same weights); every step's loss within the tolerances the reference's own
test allows between its comm modes (``tests/test_step_integration.py``: 0.01,
and 0.05 for the bf16 wire).  The two pods' parameters must be bit-identical
after every step.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

CODECS = ("none", "bf16", "int8")
STEPS = 3
TOL = {"none": 0.01, "bf16": 0.05, "int8": 0.01}
FIRST_STEP_TOL = 5e-3
COMM = dict(mode="hierarchical", streams=4, chunk_mb=0.001, autotune=False)
TRAIN = dict(zero1=True, microbatches=1, warmup_steps=1, total_steps=10, lr=1e-3)

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

cfg = smoke_config(get_config("llama3.2-3b"))
mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {"losses": {}, "plans": {}}
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=i)["tokens"]) for i in range(STEPS)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
for c in CODECS:
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                   comm=CommConfig(compress=c, **COMM), train=TrainConfig(**TRAIN))
    with jax.set_mesh(mesh):
        b = build_train_step(rc, mesh)
        sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda x: isinstance(x, P))
        state0 = b.init_state(0)
        if c == CODECS[0]:
            flat = {}
            for path, a in jax.tree_util.tree_leaves_with_path(state0):
                a = np.asarray(a)
                name = jax.tree_util.keystr(path)
                flat[("bf16" if a.dtype.name == "bfloat16" else "") + name] = (
                    a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
            np.savez(f"{OUT}/state0.npz", **flat)
        state = jax.device_put(state0, sh(b.state_specs))
        losses = []
        for i in range(STEPS):
            batch = jax.device_put({"tokens": jnp.asarray(toks[i])}, sh(b.batch_specs))
            state, m = b.fn(state, batch)
            losses.append(float(m["loss"]))
    out["losses"][c] = losses
    out["plans"][c] = asdict(tel.get_telemetry().path(b.path.key).plan)
print("RESULT:" + json.dumps(out))
"""


def _load_state(path: str) -> dict:
    """The reference's state as nested numpy arrays (bf16 as ml_dtypes')."""
    import ml_dtypes
    tree: dict = {}
    for key, a in np.load(path).items():
        if key.startswith("bf16"):
            key, a = key[4:], a.view(ml_dtypes.bfloat16)
        names = re.findall(r"\['([^']+)'\]", key)
        node = tree
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = a
    return tree


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import telemetry as tel
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import state_from_jax
    from repro_torch.runtime.step import build_train_step
    from repro_torch.runtime.train_loop import replica_checksum
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        mesh = make_local_mesh(pod=2, device="cpu")
        cfg = smoke_config(get_config("llama3.2-3b"))
        toks = np.load(f"{out}/tokens.npy")
        res = {"losses": {}, "plans": {}, "checksums": {}, "wire": {}}
        for c in CODECS:
            rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                           comm=CommConfig(compress=c, **COMM),
                           train=TrainConfig(**TRAIN))
            b = build_train_step(rc, mesh)
            state = state_from_jax(_load_state(f"{out}/state0.npz"), "cpu")
            losses, sums, wire = [], [], []
            for i in range(STEPS):
                rows = torch.as_tensor(toks[i][4 * rank:4 * rank + 4], dtype=torch.int64)
                state, m = b.fn(state, {"tokens": rows})
                losses.append(float(m["loss"]))
                sums.append(replica_checksum(state["params"]))
                wire.append([len(m["chunks"]), m["wire_bytes"]])
            res["losses"][c] = losses
            res["plans"][c] = tel.get_telemetry().path(b.path.key).plan.__dict__
            res["checksums"][c] = sums
            res["wire"][c] = wire
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tstep")
    head = (f"OUT = {str(out)!r}\nCODECS = {CODECS!r}\nSTEPS = {STEPS}\n"
            f"COMM = {COMM!r}\nTRAIN = {TRAIN!r}\n")
    ref = multidev(head + _REFERENCE, ndev=2, timeout=900)
    torch.multiprocessing.start_processes(
        _port_rank, args=(f"file://{out}/rdv", str(out)), nprocs=2, join=True,
        start_method="spawn")
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(2)]
    return ref, port


@pytest.mark.parametrize("codec", CODECS)
def test_two_pod_train_step_tracks_reference(runs, codec):
    ref, port = runs
    want = ref["losses"][codec]
    for r in range(2):
        got = port[r]["losses"][codec]
        assert all(np.isfinite(got)), got
        assert abs(got[0] - want[0]) <= FIRST_STEP_TOL, (codec, got, want)
        for a, b in zip(got, want):
            assert abs(a - b) <= TOL[codec], (codec, got, want)
    # both pods leave every step with the same parameters
    assert port[0]["checksums"][codec] == port[1]["checksums"][codec]


@pytest.mark.parametrize("codec", CODECS)
def test_two_pod_train_step_plan_matches_reference(runs, codec):
    ref, port = runs
    plan = ref["plans"][codec]
    assert port[0]["plans"][codec] == plan
    for n_chunks, wire in port[0]["wire"][codec]:
        assert n_chunks == plan["n_chunks"]
        assert round(wire) == plan["wire_bytes"]


def test_train_launcher_runs_two_pods_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--smoke", "--pods", "2", "--device", "cpu", "--steps", "2",
         "--compress", "int8", "--check-replicas", "--report", str(tmp_path / "run")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] done: loss" in out.stdout
    reps = [json.load(open(tmp_path / f"run.rank{r}.json")) for r in range(2)]
    assert [h["checksum"] for h in reps[0]["history"]] == \
        [h["checksum"] for h in reps[1]["history"]]
    assert reps[0]["plan"]["n_chunks"] == reps[0]["history"][-1]["n_chunks"]
    # on the CPU every kernel wrapper runs its plain version: no launch
    assert not any(reps[0]["launches"].values())


def test_train_launcher_refuses_unported_flags():
    from repro_torch.launch.train import main
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit, match="ROADMAP"):
        main(base + ["--production-mesh"])
    # the chaos, local-SGD and membership flags are ported
    # (tests/test_torch_elastic.py); the launcher refuses their misuse
    with pytest.raises(SystemExit, match="--local-steps must be >= 1"):
        main(base + ["--local-steps", "0"])
    with pytest.raises(SystemExit, match="--coordinator needs --route"):
        main(base + ["--lease-steps", "4", "--coordinator", "amsterdam"])
    with pytest.raises(SystemExit, match="--chaos-drop needs a direct"):
        main(base + ["--pods", "4", "--route", "tokyo:espoo", "--chaos-drop", "4"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_replica_checksum_sees_where_each_value_sits(dtype):
    from repro_torch.runtime import train_loop
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(7, 5, generator=g).to(dtype),
              "b": {"c": torch.randn(300, generator=g).to(dtype)}}
    base = train_loop.replica_checksum(params)
    same = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
    assert train_loop.replica_checksum(same) == base
    # two elements swapped: the same multiset of bits
    swapped = same["b"]["c"].clone()
    swapped[[3, 250]] = swapped[[250, 3]]
    assert not torch.equal(swapped, same["b"]["c"])
    assert train_loop.replica_checksum({"a": same["a"], "b": {"c": swapped}}) != base
    # +k in one element's bits and -k in another's: the same plain bit sum
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    moved = same["a"].clone().reshape(-1)
    bits = moved.view(ints)
    bits[0] += 1
    bits[9] -= 1
    assert train_loop.replica_checksum({"a": moved.reshape(7, 5), "b": same["b"]}) != base
    # the slices of a long leaf are weighted by their global positions
    long = torch.randn(1000, generator=g).to(dtype)
    whole = train_loop.replica_checksum({"x": long})
    rolled = torch.roll(long, 400)
    mp = pytest.MonkeyPatch()
    mp.setattr(train_loop, "_SLICE", 400)
    try:
        assert train_loop.replica_checksum({"x": long}) == whole
        assert train_loop.replica_checksum({"x": rolled}) != whole
    finally:
        mp.undo()
