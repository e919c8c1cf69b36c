"""The port's pod shifts, Forwarder relays, cycles and barrier on 2, 3 and 4
gloo ranks against the JAX package's on 2, 3 and 4 fake CPU devices.

The same per-rank numpy leaves go through ``repro.core.cycle`` (a shard_map
over a ("pod",) mesh of n devices, in one subprocess of 4 devices) and
through ``repro_torch.core.cycle`` (n spawned ranks of a gloo group,
``file://`` rendezvous in a tmp dir): ``pod_shift`` by +1, -1 and 2 on a
single-link path, ``forward`` over a 2-hop path (shifts -1 and 2, the
CosmoGrid tokyo -> espoo route's) both ways, ``pod_shift`` on that
multi-hop path (store-and-forward, the route scaled by the shift),
``relay`` and ``cycle`` on single links, and ``barrier``.  A shift moves
bits, so every output is compared **bit for bit**, and the traffic plans
the packages note in telemetry (``algo="shift"``, per hop under
``{key}/hop{i}:{name}``) must be equal field for field.  Every spawned run
gives gloo a 120 s timeout and is joined with a deadline.
"""
from __future__ import annotations

import json
import os
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import spawn

GLOO_TIMEOUT = timedelta(seconds=120)
WORLDS = (2, 3, 4)
# leaf -> (shape, scatter dim); "a" crosses in several 64 KiB chunks
LEAVES = {"a": ((96, 256), 0), "b": ((5, 130), 1), "s": ((), None)}
COMM = dict(streams=2, chunk_mb=0.0625, autotune=False)
HOPS = (("h0", -1, 3, 0.0625), ("h1", 2, 2, 0.125))   # name, shift, streams, chunk_mb
CASES = ("shift_p1", "shift_m1", "shift_p2", "forward", "forward_rev",
         "route_shift_m1", "relay2", "cycle")


def rank_leaves(rank: int) -> dict:
    rng = np.random.default_rng(900 + rank)
    return {k: np.asarray(rng.standard_normal(shape), dtype=np.float32)
            for k, (shape, _) in LEAVES.items()}


def _dims() -> dict:
    return {k: d for k, (_, d) in LEAVES.items()}


_REF = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import CommConfig
import repro.core
from repro.core import telemetry as tel
# the package re-exports the cycle() function under the module's name
cy = sys.modules["repro.core.cycle"]
from repro.core.path import INTERPOD, WAN_POZNAN_AMS, Hop, WidePath
sys.path.insert(0, TESTS)
from test_torch_cycle import CASES, COMM, HOPS, LEAVES, WORLDS, _dims, rank_leaves

def unscalar(t):
    return {k: (t[k].reshape(()) if LEAVES[k][0] == () else t[k]) for k in t}

def rescalar(t):
    return {k: (t[k].reshape((1,)) if LEAVES[k][0] == () else t[k]) for k in t}

res = {}
for n in WORLDS:
    mesh = jax.make_mesh((n,), ("pod",), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,))
    per = [rank_leaves(r) for r in range(n)]
    glob = {k: jnp.asarray(np.concatenate([np.reshape(p[k], (-1,) + np.shape(p[k])[1:])
                                           if np.ndim(p[k]) else np.reshape(p[k], (1,))
                                           for p in per], 0)) for k in per[0]}
    link = WidePath(axis="pod", comm=CommConfig(**COMM), name=f"cy{n}")
    other = WidePath(axis="pod", comm=CommConfig(streams=3, chunk_mb=0.125,
                                                 autotune=False), name=f"cyb{n}")
    route = WidePath(axis="pod", comm=CommConfig(**COMM), name=f"cyr{n}").with_hops(
        [Hop(name, link=WAN_POZNAN_AMS if i else INTERPOD,
             comm=CommConfig(streams=s, chunk_mb=c, autotune=False), shift=sh)
         for i, (name, sh, s, c) in enumerate(HOPS)])
    fns = {"shift_p1": lambda t: cy.pod_shift(t, link, 1, dims=_dims()),
           "shift_m1": lambda t: cy.pod_shift(t, link, -1, dims=_dims()),
           "shift_p2": lambda t: cy.pod_shift(t, link, 2, dims=_dims()),
           "forward": lambda t: cy.forward(t, route, dims=_dims()),
           "forward_rev": lambda t: cy.forward(t, route, dims=_dims(), reverse=True),
           "route_shift_m1": lambda t: cy.pod_shift(t, route, -1, dims=_dims()),
           "relay2": lambda t: cy.relay(t, link, 2, dims=_dims()),
           "cycle": lambda t: cy.cycle(link, other, t, dims=_dims())}
    for case in CASES:
        tel.get_telemetry().reset()
        f = jax.shard_map(lambda t: rescalar(fns[case](unscalar(t))), mesh=mesh,
                          in_specs=(P("pod"),), out_specs=P("pod"),
                          axis_names={"pod"}, check_vma=False)
        with jax.set_mesh(mesh):
            out = jax.jit(f)(glob)
        np.savez(f"{OUT}/ref_{n}_{case}.npz", **{k: np.asarray(v) for k, v in out.items()})
        res[f"{n}_{case}"] = {k: v["plan"] for k, v in tel.get_telemetry().report().items()}
    b = jax.shard_map(lambda t: cy.barrier(("pod",)).reshape(1), mesh=mesh,
                      in_specs=(P("pod"),), out_specs=P("pod"), axis_names={"pod"},
                      check_vma=False)
    with jax.set_mesh(mesh):
        res[f"{n}_barrier"] = np.asarray(jax.jit(b)(glob["s"])).tolist()
print("RESULT:" + json.dumps(res))
"""


def _port_rank(rank: int, n: int, init: str, out: str) -> None:
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.path import INTERPOD, WAN_POZNAN_AMS, Hop, WidePath
    from repro_torch.launch.mesh import make_local_mesh
    cy = sys.modules["repro_torch.core.cycle"]   # the package re-exports cycle()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=n, device="cpu", timeout=GLOO_TIMEOUT)
        mine = {k: torch.from_numpy(v) for k, v in rank_leaves(rank).items()}
        link = WidePath(axis="pod", comm=CommConfig(**COMM), name=f"cy{n}")
        other = WidePath(axis="pod", comm=CommConfig(streams=3, chunk_mb=0.125,
                                                     autotune=False), name=f"cyb{n}")
        route = WidePath(axis="pod", comm=CommConfig(**COMM), name=f"cyr{n}").with_hops(
            [Hop(name, link=WAN_POZNAN_AMS if i else INTERPOD,
                 comm=CommConfig(streams=s, chunk_mb=c, autotune=False), shift=sh)
             for i, (name, sh, s, c) in enumerate(HOPS)])
        d = _dims()
        fns = {"shift_p1": lambda t: cy.pod_shift(t, link, mesh, 1, dims=d),
               "shift_m1": lambda t: cy.pod_shift(t, link, mesh, -1, dims=d),
               "shift_p2": lambda t: cy.pod_shift(t, link, mesh, 2, dims=d),
               "forward": lambda t: cy.forward(t, route, mesh, dims=d),
               "forward_rev": lambda t: cy.forward(t, route, mesh, dims=d, reverse=True),
               "route_shift_m1": lambda t: cy.pod_shift(t, route, mesh, -1, dims=d),
               "relay2": lambda t: cy.relay(t, link, mesh, 2, dims=d),
               "cycle": lambda t: cy.cycle(link, other, t, mesh, dims=d)}
        res = {}
        for case in CASES:
            tel.get_telemetry().reset()
            got = fns[case](mine)
            np.savez(f"{out}/port_{n}_{case}_rank{rank}.npz",
                     **{k: v.numpy() for k, v in got.items()})
            res[case] = {k: v["plan"] for k, v in tel.get_telemetry().report().items()}
        res["barrier"] = float(cy.barrier(mesh, ("pod",)))
        with open(f"{out}/port_{n}_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tcycle")
    tests = os.path.dirname(os.path.abspath(__file__))
    head = f"TESTS = {tests!r}\nOUT = {str(out)!r}\n"
    ref = multidev(head + _REF, ndev=4, timeout=600)
    port = {}
    for n in WORLDS:
        spawn(_port_rank, n, (n, f"file://{out}/rdv{n}", str(out)))
        port[n] = [json.load(open(f"{out}/port_{n}_rank{r}.json")) for r in range(n)]
    return out, ref, port


def _block(a: np.ndarray, shape: tuple, r: int) -> np.ndarray:
    if shape == ():
        return a[r:r + 1].reshape(())
    return a[r * shape[0]:(r + 1) * shape[0]]


# the pod each case delivers from, as a function of (rank, world)
SOURCE = {"shift_p1": lambda r, n: (r - 1) % n, "shift_m1": lambda r, n: (r + 1) % n,
          "shift_p2": lambda r, n: (r - 2) % n, "forward": lambda r, n: (r - 1) % n,
          "forward_rev": lambda r, n: (r + 1) % n,
          "route_shift_m1": lambda r, n: (r + 1) % n,
          "relay2": lambda r, n: (r - 2) % n, "cycle": lambda r, n: (r - 2) % n}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_shift_bit_identical_to_reference(runs, n, case):
    out, _, _ = runs
    want = np.load(f"{out}/ref_{n}_{case}.npz")
    for r in range(n):
        got = np.load(f"{out}/port_{n}_{case}_rank{r}.npz")
        src = rank_leaves(SOURCE[case](r, n))
        for name, (shape, _) in LEAVES.items():
            np.testing.assert_array_equal(got[name], _block(want[name], shape, r),
                                          err_msg=f"{case} n={n} {name} rank {r}")
            # and it is exactly what the source pod sent
            np.testing.assert_array_equal(got[name], src[name])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_shift_plans_equal_reference(runs, n, case):
    _, ref, port = runs
    want = ref[f"{n}_{case}"]
    assert want, case
    assert all(p["algo"] == "shift" for p in want.values())
    for r in range(n):
        assert port[n][r][case] == want, (case, n, r)


def test_route_plans_are_per_hop(runs):
    """``forward`` notes one plan a hop, each chunked with its hop's knobs."""
    _, ref, _ = runs
    plans = ref["4_forward"]
    keys = sorted(plans)
    assert keys == ["cyr4:poz-ams/hop0:h0", "cyr4:poz-ams/hop1:h1"]
    assert plans[keys[0]]["streams_configured"] == 3
    assert plans[keys[1]]["chunk_bytes"] == 1 << 17


@pytest.mark.parametrize("n", WORLDS)
def test_barrier_counts_the_ranks(runs, n):
    _, ref, port = runs
    assert ref[f"{n}_barrier"] == [float(n)] * n
    assert [port[n][r]["barrier"] for r in range(n)] == [float(n)] * n


def test_one_pod_returns_the_tree():
    from repro_torch.configs import CommConfig
    from repro_torch.core.path import WidePath
    from repro_torch.launch.mesh import make_local_mesh
    import repro_torch.core
    cy = sys.modules["repro_torch.core.cycle"]
    tree = {"a": torch.ones(3)}
    path = WidePath(axis="pod", comm=CommConfig())
    mesh = make_local_mesh(device="cpu")
    assert cy.pod_shift(tree, path, mesh, 1) is tree
    assert cy.forward(tree, path, None) is tree
    assert float(cy.barrier(mesh)) == 1.0
