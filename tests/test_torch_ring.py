"""The port's ring collectives on 2 and 3 gloo ranks against the JAX
package's on 2 and 3 fake CPU devices.

The same per-rank numpy leaves go through ``repro.core.ring`` (a shard_map
over a ("pod",) mesh, in a subprocess) and through ``repro_torch.core.ring``
(spawned ranks of a gloo group, ``file://`` rendezvous in a tmp dir):

* ``ring_allreduce`` for ``ring`` and ``ring2`` x none/bf16/int8, on leaves
  with odd extents along their scatter dim (padded to the world), segments
  longer and shorter than the 256-block (int8 wire blocks ``min(256, m)``),
  an extent of 1 (``ring2`` falls back to one direction) and a scalar;
* ``ring_reduce_scatter`` per codec and ``ring_all_gather``;
* ``streamed_psum`` with ``algo="ring"``/``"ring2"``: the chunks' results,
  and the traffic plan noted in telemetry field for field.

Tolerance: bit-identical.  Every hop is the same IEEE arithmetic in both
packages (the partial sum, quantize, send, dequantize, add the own segment).

The reference must compute what its source says.  Under a plain ``jax.jit``
XLA's CPU build does not (``test_torch_train_comm.py``: ``amax / 127`` as a
product with a rounded reciprocal, dequantize-and-add as fused
multiply-adds; requantized per hop, a third of a ring's int8 sums move).
Op by op (outside ``jit``) it does, but an int8 ring takes seconds per leaf
that way.  So the reference runs jitted with XLA's algebraic simplifier and
fp-conversion simplifier off and its backend at optimization level 0, and
the test holds that run bit for bit to the op-by-op run of one int8 case
per world (``ring2`` on leaf "a"), as well as to the port.
The port's ring reduce-scatter and all-gather are also held, bit for bit,
to its in-pod stages (``reduce_scatter_dim``, ``all_gather_dim``) on
values whose sums are exact in f32, so that the two summation orders (ring
order, rank order) give the same bits.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

WORLDS = (2, 3)
ALGOS = ("ring", "ring2")
CODECS = ("none", "bf16", "int8")
# leaf -> (shape, scatter dim, scale)
LEAVES = {"a": ((7, 300), 0, 3.0), "b": ((4, 5, 130), 2, 1.0),
          "c": ((1,), 0, 2.0), "e": ((2000,), 0, 1e3), "s": ((), None, 5.0)}
# reduce-scatter / all-gather leaves: extents divisible by 2 and by 3
RS_SHAPE, RS_DIM = (6, 12, 10), 1
AG_SHAPE, AG_DIM = (3, 4), 1
# streamed_psum: leaf -> (shape, scatter dim, scale), 64 KiB chunks
STREAMED = {"a": ((96, 300), 0, 3.0), "b": ((4, 130, 64), 1, 1.0),
            "c": ((3000,), None, 1e3), "s": ((), None, 2.0)}
COMM = dict(streams=3, chunk_mb=0.0625, pacing=0.5, autotune=False)


def _rng_leaves(rank: int, spec: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed + rank)
    out = {}
    for name, (shape, _, scale) in spec.items():
        x = np.asarray(rng.standard_normal(shape) * scale, dtype=np.float32)
        if name == "a":
            x[0] = 0.0            # all-zero int8 blocks
        out[name] = x
    return out


def rank_leaves(rank: int) -> dict:
    return _rng_leaves(rank, LEAVES, 200)


def streamed_leaves(rank: int) -> dict:
    return _rng_leaves(rank, STREAMED, 300)


def rs_leaf(rank: int) -> np.ndarray:
    return (np.random.default_rng(400 + rank).standard_normal(RS_SHAPE) * 2
            ).astype(np.float32)


def ag_leaf(rank: int) -> np.ndarray:
    return (np.arange(np.prod(AG_SHAPE), dtype=np.float32).reshape(AG_SHAPE)
            + 100 * rank)


def exact_leaf(rank: int) -> np.ndarray:
    """Multiples of 2^-8 below 2^8: every sum of three is exact in f32."""
    rng = np.random.default_rng(500 + rank)
    return (rng.integers(-2 ** 15, 2 ** 15, RS_SHAPE) / 256).astype(np.float32)


# XLA flags under which the jitted reference computes its source's arithmetic
STRICT_XLA = ("--xla_backend_optimization_level=0 "
              "--xla_disable_hlo_passes=algsimp,simplify-fp-conversions")

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] += " " + STRICT
import numpy as np
import jax, jax.numpy as jnp
from dataclasses import asdict
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
from repro.core import ring as rg
from repro.core import telemetry as tel
from repro.core.collectives import streamed_psum
from repro.core.path import WidePath
sys.path.insert(0, TESTS)
from test_torch_ring import (ALGOS, CODECS, COMM, LEAVES, STREAMED, RS_DIM, AG_DIM,
                             rank_leaves, streamed_leaves, rs_leaf, ag_leaf)

mesh = jax.make_mesh((W,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))

def glob_of(per_rank):
    return {k: jnp.asarray(np.concatenate([np.reshape(p[k], (-1,) + np.shape(p[k])[1:])
                                           if np.ndim(p[k]) else np.reshape(p[k], (1,))
                                           for p in per_rank], 0))
            for k in per_rank[0]}

def run(body, tree, eager=False):
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod"),
                      axis_names={"pod"}, check_vma=False)
    with jax.set_mesh(mesh):
        return f(tree) if eager else jax.jit(f)(tree)

def scalar_in(fn, shape):
    return lambda x: fn(x.reshape(())).reshape((1,)) if shape == () else fn(x)

glob = glob_of([rank_leaves(r) for r in range(W)])
for algo in ALGOS:
    for c in CODECS:
        def body(t):
            return {k: scalar_in(lambda x: rg.ring_allreduce(
                        x, d if d is not None else 0, "pod", compress=c,
                        bidirectional=algo == "ring2"), shape)(t[k])
                    for k, (shape, d, _) in LEAVES.items()}
        out = run(body, glob)
        np.savez(f"{OUT}/ref_{algo}_{c}.npz", **{k: np.asarray(v) for k, v in out.items()})
eager = run(lambda x: rg.ring_allreduce(x, 0, "pod", compress="int8", bidirectional=True),
            glob["a"], eager=True)
np.save(f"{OUT}/ref_eager_ring2_int8_a.npy", np.asarray(eager))
rs = jnp.asarray(np.concatenate([rs_leaf(r) for r in range(W)], 0))
for c in CODECS:
    out = run(lambda x: rg.ring_reduce_scatter(x, RS_DIM, "pod", compress=c), rs)
    np.save(f"{OUT}/ref_rs_{c}.npy", np.asarray(out))
ag = jnp.asarray(np.concatenate([ag_leaf(r) for r in range(W)], 0))
np.save(f"{OUT}/ref_ag.npy", np.asarray(run(lambda x: rg.ring_all_gather(x, AG_DIM, "pod"), ag)))
sglob = glob_of([streamed_leaves(r) for r in range(W)])
dims = {k: d for k, (_, d, _) in STREAMED.items()}
plans = {}
for algo in ALGOS:
    for c in CODECS:
        path = WidePath(axis="pod", comm=CommConfig(compress=c, algo=algo, **COMM),
                        name="tring")
        def body(t):
            t = {k: (t[k].reshape(()) if STREAMED[k][0] == () else t[k]) for k in t}
            o = streamed_psum(t, path, dims=dims)
            return {k: (o[k].reshape((1,)) if STREAMED[k][0] == () else o[k]) for k in o}
        out = run(body, sglob)
        np.savez(f"{OUT}/ref_streamed_{algo}_{c}.npz",
                 **{k: np.asarray(v) for k, v in out.items()})
        plans[f"{algo}_{c}"] = asdict(tel.get_telemetry().path(path.key).plan)
print("RESULT:" + json.dumps(plans))
"""


def _port_rank(rank: int, world: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core import ring as rg
    from repro_torch.core import telemetry as tel
    from repro_torch.core.collectives import (all_gather_dim, reduce_scatter_dim,
                                              streamed_psum)
    from repro_torch.core.path import WidePath
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(pod=world, device="cpu")
        g = mesh.pod_group
        mine = {k: torch.from_numpy(v) for k, v in rank_leaves(rank).items()}
        for algo in ALGOS:
            for c in CODECS:
                got = {k: rg.ring_allreduce(mine[k], d if d is not None else 0, g,
                                            compress=c, bidirectional=algo == "ring2")
                       for k, (_, d, _) in LEAVES.items()}
                np.savez(f"{out}/port_{algo}_{c}_rank{rank}.npz",
                         **{k: v.numpy() for k, v in got.items()})
        rs = torch.from_numpy(rs_leaf(rank))
        for c in CODECS:
            np.save(f"{out}/port_rs_{c}_rank{rank}.npy",
                    rg.ring_reduce_scatter(rs, RS_DIM, g, compress=c).numpy())
        ag = rg.ring_all_gather(torch.from_numpy(ag_leaf(rank)), AG_DIM, g)
        np.save(f"{out}/port_ag_rank{rank}.npy", ag.numpy())
        ex = torch.from_numpy(exact_leaf(rank))
        inpod = {"rs_ring": rg.ring_reduce_scatter(ex, RS_DIM, g),
                 "rs_inpod": reduce_scatter_dim(ex, RS_DIM, g),
                 "ag_ring": rg.ring_all_gather(ex, RS_DIM, g),
                 "ag_inpod": all_gather_dim(ex, RS_DIM, g)}
        np.savez(f"{out}/port_inpod_rank{rank}.npz", **{k: v.numpy() for k, v in inpod.items()})
        smine = {k: torch.from_numpy(v) for k, v in streamed_leaves(rank).items()}
        dims = {k: d for k, (_, d, _) in STREAMED.items()}
        plans = {}
        for algo in ALGOS:
            for c in CODECS:
                path = WidePath(axis="pod", comm=CommConfig(compress=c, algo=algo, **COMM),
                                name="tring")
                log: list = []
                got = streamed_psum(smine, path, mesh, dims=dims, log=log)
                np.savez(f"{out}/port_streamed_{algo}_{c}_rank{rank}.npz",
                         **{k: v.numpy() for k, v in got.items()})
                plans[f"{algo}_{c}"] = {
                    "plan": tel.get_telemetry().path(path.key).plan.__dict__, "log": log}
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(plans, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    tests = os.path.dirname(os.path.abspath(__file__))
    res = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"tring{world}")
        ref_plans = multidev(f"TESTS = {tests!r}\nOUT = {str(out)!r}\nW = {world}\n"
                             f"STRICT = {STRICT_XLA!r}\n" + _REFERENCE,
                             ndev=world, timeout=600)
        torch.multiprocessing.start_processes(
            _port_rank, args=(world, f"file://{out}/rdv", str(out)), nprocs=world,
            join=True, start_method="spawn")
        port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(world)]
        res[world] = (out, ref_plans, port)
    return res


def _ref_block(a: np.ndarray, shape: tuple, r: int) -> np.ndarray:
    """Rank r's block of the reference's output (its shard_map concatenates
    the ranks' outputs along dim 0; a scalar is one element a rank)."""
    if shape == ():
        return a[r:r + 1].reshape(())
    n = shape[0]
    return a[r * n:(r + 1) * n]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("codec", CODECS)
def test_ring_allreduce_bit_identical_to_reference(runs, world, algo, codec):
    out, _, _ = runs[world]
    ref = np.load(f"{out}/ref_{algo}_{codec}.npz")
    for r in range(world):
        got = np.load(f"{out}/port_{algo}_{codec}_rank{r}.npz")
        for name, (shape, _, _) in LEAVES.items():
            want = _ref_block(ref[name], shape, r)
            assert got[name].dtype == np.float32 and got[name].shape == shape
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{world} {algo} {codec} {name} rank {r}")
            # every rank holds the same sum
            np.testing.assert_array_equal(want, _ref_block(ref[name], shape, 0))
    if codec == "none":          # close to the plain sum (ring order of additions)
        plain = sum(rank_leaves(r)["e"].astype(np.float64) for r in range(world))
        np.testing.assert_allclose(got["e"], plain, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_reference_jitted_strictly_equals_its_op_by_op_run(runs, world):
    out, _, _ = runs[world]
    eager = np.load(f"{out}/ref_eager_ring2_int8_a.npy")
    np.testing.assert_array_equal(eager, np.load(f"{out}/ref_ring2_int8.npz")["a"])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_reduce_scatter_and_all_gather_bit_identical_to_reference(runs, world):
    out, _, _ = runs[world]
    for c in CODECS:
        ref = np.load(f"{out}/ref_rs_{c}.npy")
        n = RS_SHAPE[0]
        for r in range(world):
            got = np.load(f"{out}/port_rs_{c}_rank{r}.npy")
            assert got.shape == (RS_SHAPE[0], RS_SHAPE[1] // world, RS_SHAPE[2])
            np.testing.assert_array_equal(got, ref[r * n:(r + 1) * n], err_msg=f"{c} rank {r}")
    ref = np.load(f"{out}/ref_ag.npy")
    n = AG_SHAPE[0]
    want = np.concatenate([ag_leaf(r) for r in range(world)], AG_DIM)
    for r in range(world):
        got = np.load(f"{out}/port_ag_rank{r}.npy")
        np.testing.assert_array_equal(got, ref[r * n:(r + 1) * n])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_stages_match_the_in_pod_stages(runs, world):
    out, _, _ = runs[world]
    for r in range(world):
        got = np.load(f"{out}/port_inpod_rank{r}.npz")
        np.testing.assert_array_equal(got["rs_ring"], got["rs_inpod"])
        np.testing.assert_array_equal(got["ag_ring"], got["ag_inpod"])
        full = sum(exact_leaf(q) for q in range(world))
        m = RS_SHAPE[RS_DIM] // world
        np.testing.assert_array_equal(got["rs_ring"], full[:, r * m:(r + 1) * m])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("codec", CODECS)
def test_streamed_ring_psum_bit_identical_and_plan_equal(runs, world, algo, codec):
    out, ref_plans, port = runs[world]
    key = f"{algo}_{codec}"
    ref = np.load(f"{out}/ref_streamed_{key}.npz")
    for r in range(world):
        got = np.load(f"{out}/port_streamed_{key}_rank{r}.npz")
        for name, (shape, _, _) in STREAMED.items():
            np.testing.assert_array_equal(got[name], _ref_block(ref[name], shape, r),
                                          err_msg=f"{world} {key} {name} rank {r}")
        assert port[r][key]["plan"] == ref_plans[key], (r, key)
    plan = ref_plans[key]
    assert plan["algo"] == algo
    log = port[0][key]["log"]
    assert len(log) == plan["n_chunks"] > len(STREAMED)
    assert sum(c["payload_bytes"] for c in log) == plan["payload_bytes"]
    assert round(sum(c["wire_bytes"] for c in log)) == plan["wire_bytes"]
    # the ring's wire: 2 (P - 1) / P of the codec's bytes
    factor = {"none": 1.0, "bf16": 0.5, "int8": 0.25}[codec]
    assert plan["wire_bytes"] == round(2 * (world - 1) / world * factor
                                       * plan["payload_bytes"])
    sent = sum(c["sent_bytes"] for c in log)
    if codec != "int8":     # each hop ships one padded segment in the wire dtype
        assert sent >= 2 * (world - 1) / world * factor * plan["payload_bytes"]
