"""The port's training step on 2 pods x 2 data ranks against the JAX
package's, on the CPU: ZeRO-3, the in-pod stages and every comm mode.

The reference runs ``build_train_step`` at ``smoke_config(get_config(
"llama3.2-3b"))`` on a (pod 2, data 2, model 1) mesh of 4 fake CPU devices
(one subprocess); the port runs its ``build_train_step`` on 4 spawned gloo
ranks, rank ``pod * 2 + data``, from the reference's own initial state
(``state_from_jax``, under ZeRO this rank's shards) and the reference's
batches, rank r taking rows [2r, 2r + 2) of each global batch of 8, as
``P(("pod", "data"))`` gives them to the reference.  Knobs are fixed
(``CommConfig(autotune=False)``).

Cases: hierarchical + ZeRO with each wire codec, hierarchical without ZeRO,
flat, gateway, and hierarchical + ZeRO with 2 microbatches.

Tolerances, as in ``test_torch_train_step.py``: the first step's loss within
5e-3, every step's loss within 0.01 (0.05 for the bf16 wire).  Every step's
``grad_norm`` within 2e-3 relative of the reference's.  Under ZeRO the
reference counts each scattered leaf once per pod (ROADMAP.md §C 6), a
factor of sqrt(2) here, which the port must reproduce.  2e-3 and not less:
the modes without ZeRO, where no ZeRO code runs, already differ by 1.07e-3
at step 1 (the port's bf16 gradients are rounded at other places than the
jitted reference's; the reference itself moves 6.3e-4 between jit and op by
op).  The count itself is held tighter, inside each package: at step 1 the
ZeRO norm is sqrt(2) times the norm without ZeRO within 1e-4 (every leaf of
the smoke model is scattered; the bf16 rounding of the reduce-scattered
gradient moves it ~1e-5).  After every step each data index's shards are
bit-identical across pods (without ZeRO: every rank's parameters), and the
plan noted in telemetry equals the reference's.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_train_step import _load_state

STEPS = 3
FIRST_STEP_TOL = 5e-3
NORM_RTOL = 2e-3
COUNT_RTOL = 1e-4
# case -> (mode, compress, zero1, microbatches)
CASES = {
    "zero-none": ("hierarchical", "none", True, 1),
    "zero-bf16": ("hierarchical", "bf16", True, 1),
    "zero-int8": ("hierarchical", "int8", True, 1),
    "hierarchical": ("hierarchical", "none", False, 1),
    "flat": ("flat", "none", True, 1),
    "gateway": ("gateway", "none", True, 1),
    "zero-micro2": ("hierarchical", "none", True, 2),
}
COMM = dict(streams=4, chunk_mb=0.001, autotune=False)
TRAIN = dict(warmup_steps=1, total_steps=10, lr=1e-3)

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
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {"losses": {}, "norms": {}, "plans": {}, "zero": {}}
toks = [np.asarray(batch_concrete(cfg, "train", 8, 32, seed=i)["tokens"]) for i in range(STEPS)]
np.save(f"{OUT}/tokens.npy", np.stack(toks))
for name, (mode, c, zero1, micro) in CASES.items():
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                   comm=CommConfig(mode=mode, compress=c, **COMM),
                   train=TrainConfig(zero1=zero1, microbatches=micro, **TRAIN))
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
    out["zero"][name] = bool(b.zero)
    plan = tel.get_telemetry().path(b.path.key).plan
    out["plans"][name] = None if mode == "flat" else asdict(plan)
print("RESULT:" + json.dumps(out))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
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
        cfg = smoke_config(get_config("llama3.2-3b"))
        toks = np.load(f"{out}/tokens.npy")
        full = _load_state(f"{out}/state0.npz")
        res = {k: {} for k in ("losses", "norms", "plans", "checksums", "wire",
                               "zero", "shapes")}
        for name, (mode, c, zero1, micro) in CASES.items():
            rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                           comm=CommConfig(mode=mode, compress=c, **COMM),
                           train=TrainConfig(zero1=zero1, microbatches=micro, **TRAIN))
            b = build_train_step(rc, mesh)
            state = state_from_jax(full, "cpu", mesh=mesh, dims=b.dims)
            losses, norms, sums, wire = [], [], [], []
            for i in range(STEPS):
                rows = torch.as_tensor(toks[i][2 * rank:2 * rank + 2], dtype=torch.int64)
                state, m = b.fn(state, {"tokens": rows})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                sums.append(replica_checksum(state["params"]))
                wire.append([len(m["chunks"]), m["wire_bytes"],
                             sum(x["payload_bytes"] for x in m["chunks"])])
            res["losses"][name] = losses
            res["norms"][name] = norms
            res["checksums"][name] = sums
            res["wire"][name] = wire
            res["zero"][name] = b.zero
            res["shapes"][name] = list(state["params"]["embed"].shape)
            plan = tel.get_telemetry().path(b.path.key).plan
            res["plans"][name] = None if mode == "flat" else plan.__dict__
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tzero")
    head = (f"OUT = {str(out)!r}\nCASES = {CASES!r}\nSTEPS = {STEPS}\n"
            f"COMM = {COMM!r}\nTRAIN = {TRAIN!r}\n")
    ref = multidev(head + _REFERENCE, ndev=4, timeout=900)
    torch.multiprocessing.start_processes(
        _port_rank, args=(f"file://{out}/rdv", str(out)), nprocs=4, join=True,
        start_method="spawn")
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(4)]
    return ref, port


@pytest.mark.parametrize("case", list(CASES))
def test_pods_by_data_train_step_tracks_reference(runs, case):
    ref, port = runs
    mode, codec, zero1, micro = CASES[case]
    zero = zero1 and mode == "hierarchical"
    assert ref["zero"][case] == zero
    tol = 0.05 if codec == "bf16" else 0.01
    want, want_norm = ref["losses"][case], ref["norms"][case]
    for r in range(4):
        assert port[r]["zero"][case] == zero
        # a ZeRO rank stores its half of the embedding's d_model columns
        assert port[r]["shapes"][case] == [256, 64 if zero else 128]
        got = port[r]["losses"][case]
        assert all(np.isfinite(got)), got
        assert abs(got[0] - want[0]) <= FIRST_STEP_TOL, (case, got, want)
        for a, b in zip(got, want):
            assert abs(a - b) <= tol, (case, got, want)
        np.testing.assert_allclose(port[r]["norms"][case], want_norm,
                                   rtol=NORM_RTOL, err_msg=case)
    sums = [port[r]["checksums"][case] for r in range(4)]
    if zero:   # each data index's shards equal across the pods
        assert sums[0] == sums[2] and sums[1] == sums[3], sums
        assert sums[0] != sums[1]
    else:      # every rank holds the whole, equal parameters
        assert sums[0] == sums[1] == sums[2] == sums[3], sums


def test_zero_grad_norm_counts_scattered_leaves_once_per_pod(runs):
    """The reference's ZeRO norm is sqrt(P * scattered + replicated), not the
    true norm of the hierarchical mode without ZeRO (§C 6): at step 1, from
    the same parameters and batches, every leaf scattered, the two differ by
    sqrt(2) in the reference and in the port alike."""
    ref, port = runs
    ratios = [ref["norms"]["zero-none"][0] / ref["norms"]["hierarchical"][0]]
    ratios += [p["norms"]["zero-none"][0] / p["norms"]["hierarchical"][0]
               for p in port]
    np.testing.assert_allclose(ratios, 2 ** 0.5, rtol=COUNT_RTOL)


@pytest.mark.parametrize("case", [c for c in CASES if c != "flat"])
def test_pods_by_data_sync_plan_matches_reference(runs, case):
    ref, port = runs
    plan = ref["plans"][case]
    micro = CASES[case][3]
    for r in range(4):
        assert port[r]["plans"][case] == plan, (case, r)
        for n_chunks, wire, payload in port[r]["wire"][case]:
            # one sync per microbatch, each the plan's chunks
            assert n_chunks == micro * plan["n_chunks"]
            assert payload == micro * plan["payload_bytes"]
            assert round(wire) == micro * plan["wire_bytes"]


def test_flat_mode_crosses_no_chunk(runs):
    _, port = runs
    for r in range(4):
        assert all(w == [0, 0, 0] for w in port[r]["wire"]["flat"])


def test_train_launcher_runs_two_pods_by_two_data_ranks_on_the_cpu(tmp_path):
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--smoke", "--pods", "2", "--ranks", "4", "--device", "cpu", "--steps", "2",
         "--compress", "int8", "--check-replicas", "--report", str(tmp_path / "run")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "zero=True" in out.stdout and "[train] done: loss" in out.stdout
    reps = [json.load(open(tmp_path / f"run.rank{r}.json")) for r in range(4)]
    assert [(p["pod_index"], p["data_index"]) for p in reps] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    sums = [[h["checksum"] for h in p["history"]] for p in reps]
    assert sums[0] == sums[2] and sums[1] == sums[3] and sums[0] != sums[1]
    for p in reps:
        assert p["zero"] and p["data"] == 2
        for h in p["history"]:
            assert h["n_chunks"] == p["plan"]["n_chunks"]
            assert h["gather_s"] > 0 and h["reduce_scatter_s"] > 0


def test_what_stays_queued_names_its_roadmap_item():
    """A model axis runs the dense and moe families; the ssm family on one
    stays queued (tests/test_torch_tp.py holds the rest of the list), as do
    the launcher's production meshes."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config, smoke_config
    from repro_torch.launch.mesh import PodMesh
    from repro_torch.launch.train import main
    from repro_torch.runtime.step import build_train_step
    mesh = PodMesh(pod=1, data=2, model=2, rank=0, device=torch.device("cpu"))
    rc = RunConfig(model=smoke_config(get_config("mamba2-780m")),
                   shape=ShapeConfig("t", 32, 4, "train"))
    with pytest.raises(NotImplementedError, match="tensor parallelism and the production meshes"):
        build_train_step(rc, mesh)
    for flag in ("--production-mesh", "--multi-pod"):
        with pytest.raises(SystemExit, match="tensor parallelism and the production meshes"):
            main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", flag])
    with pytest.raises(SystemExit, match="does not split"):
        main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--pods", "2",
              "--ranks", "3"])
