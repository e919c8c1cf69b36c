"""The port's streamed psum on 2 gloo ranks against the JAX package's on 2
fake CPU devices.

The same per-rank numpy leaves go through ``repro.core.collectives.
streamed_psum`` (a shard_map over a ("pod",) mesh of 2 devices, in a
subprocess) and through ``repro_torch.core.collectives.streamed_psum`` (two
spawned ranks of a gloo group, ``file://`` rendezvous in ``tmp_path``).  With
two pods every codec's sum is one IEEE addition per element taken in rank
order (none: the all-reduce; bf16: the gathered bf16 values summed in f32;
int8: the gathered blocks dequantized and summed in f32), so the results
must be **bit-identical**, and the traffic plan noted in telemetry must be
equal field for field.

The reference's shard_map runs outside ``jax.jit``, primitive by primitive,
so that it computes what its source says.  Under ``jit`` XLA's CPU build
fuses the int8 codec: it divides ``amax / 127`` as a product with a rounded
reciprocal (scales one f32 ulp off ``repro.kernels.ref.quant_int8_ref`` for
some blocks) and contracts the dequantize with the sum into fused
multiply-adds, which moves some summed elements by one f32 ulp.  The port follows the source (and the oracle the CUDA kernels are held
to bit for bit).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

CODECS = ("none", "bf16", "int8")
# leaf -> (shape, scatter dim, scale); every leaf crosses in several 64 KiB
# chunks but "c", which is one chunk
LEAVES = {"a": ((96, 300), 0, 3.0), "b": ((4, 130, 64), 1, 1.0),
          "c": ((20000,), None, 1e3), "e": ((5, 7), 1, 0.5)}
COMM = dict(streams=3, chunk_mb=0.0625, pacing=0.5, autotune=False)


def _rank_leaves(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    out = {}
    for name, (shape, _, scale) in LEAVES.items():
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        if name == "b":
            x[0, :3] = 0.0          # all-zero int8 blocks
        out[name] = x
    return out


def _dims() -> dict:
    return {k: d for k, (_, d, _) in LEAVES.items()}


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from dataclasses import asdict
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
from repro.core import telemetry as tel
from repro.core.collectives import streamed_psum
from repro.core.path import WidePath
sys.path.insert(0, TESTS)
from test_torch_train_comm import CODECS, COMM, _dims, _rank_leaves

mesh = jax.make_mesh((2,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
ranks = [_rank_leaves(r) for r in range(2)]
glob = {k: jnp.asarray(np.concatenate([ranks[0][k], ranks[1][k]], 0)) for k in ranks[0]}
res = {}
for c in CODECS:
    path = WidePath(axis="pod", comm=CommConfig(compress=c, **COMM), name="tpsum")
    f = jax.shard_map(lambda t: streamed_psum(t, path, dims=_dims()), mesh=mesh,
                      in_specs=(P("pod"),), out_specs=P("pod"), axis_names={"pod"},
                      check_vma=False)
    with jax.set_mesh(mesh):
        out = f(glob)      # outside jit: op by op, see the module docstring
    np.savez(f"{OUT}/ref_{c}.npz", **{k: np.asarray(v) for k, v in out.items()})
    res[c] = asdict(tel.get_telemetry().path(path.key).plan)
print("RESULT:" + json.dumps(res))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.collectives import streamed_psum
    from repro_torch.core.path import WidePath
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        mesh = make_local_mesh(pod=2, device="cpu")
        mine = {k: torch.from_numpy(v) for k, v in _rank_leaves(rank).items()}
        plans = {}
        for c in CODECS:
            path = WidePath(axis="pod", comm=CommConfig(compress=c, **COMM),
                            name="tpsum")
            log: list = []
            got = streamed_psum(mine, path, mesh, dims=_dims(), log=log)
            np.savez(f"{out}/port_{c}_rank{rank}.npz",
                     **{k: v.numpy() for k, v in got.items()})
            plans[c] = {"plan": tel.get_telemetry().path(path.key).plan.__dict__,
                        "log": log}
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(plans, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tpsum")
    tests = os.path.dirname(os.path.abspath(__file__))
    ref_plans = multidev(f"TESTS = {tests!r}\nOUT = {str(out)!r}\n" + _REFERENCE,
                         ndev=2, timeout=600)
    torch.multiprocessing.start_processes(
        _port_rank, args=(f"file://{out}/rdv", str(out)), nprocs=2, join=True,
        start_method="spawn")
    port = [json.load(open(f"{out}/port_rank{r}.json")) for r in range(2)]
    return out, ref_plans, port


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_psum_bit_identical_to_reference(runs, codec):
    out, _, _ = runs
    ref = np.load(f"{out}/ref_{codec}.npz")
    ports = [np.load(f"{out}/port_{codec}_rank{r}.npz") for r in range(2)]
    for name, (shape, _, _) in LEAVES.items():
        want = ref[name]
        n = shape[0]
        # the reference's two shards both hold the sum
        np.testing.assert_array_equal(want[:n], want[n:])
        for r in range(2):
            got = ports[r][name]
            assert got.dtype == np.float32 and got.shape == shape
            np.testing.assert_array_equal(got, want[:n], err_msg=f"{codec} {name} rank {r}")
    if codec == "none":           # the plain sum, in f32 as both compute it
        a, b = _rank_leaves(0), _rank_leaves(1)
        np.testing.assert_array_equal(ports[0]["a"], a["a"] + b["a"])


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_psum_plan_telemetry_equal(runs, codec):
    _, ref_plans, port = runs
    for r in range(2):
        assert port[r][codec]["plan"] == ref_plans[codec], (r, codec)
    plan = ref_plans[codec]
    log = port[0][codec]["log"]
    # the chunks that crossed are the plan's: count, bytes, streams, wire bytes
    assert len(log) == plan["n_chunks"] > len(LEAVES)
    assert sum(c["payload_bytes"] for c in log) == plan["payload_bytes"]
    assert len({c["stream"] for c in log}) == plan["streams_used"] == 3
    assert round(sum(c["wire_bytes"] for c in log)) == plan["wire_bytes"]
    sent = sum(c["sent_bytes"] for c in log)
    n = plan["payload_bytes"] // 4
    if codec == "none":
        assert sent == 4 * n
    elif codec == "bf16":
        assert sent == 2 * n
    else:   # int8: each chunk padded to whole 256-blocks along its dim, + f32 scales
        names = sorted(LEAVES)
        want = 0
        for c in log:
            shape = LEAVES[names[c["leaf"]]][0]
            rows = int(np.prod(shape)) // shape[c["dim"]]
            padded = -(-c["size"] // 256) * 256
            want += rows * padded + 4 * rows * padded // 256
        assert sent == want
