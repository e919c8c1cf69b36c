"""The port's expert-parallel MoE layer (``models/moe_ep.py``) and its
expert-sharded fallback against the JAX package's ``moe_ffn`` on a
("data" 1, "model" 2) mesh of 2 fake CPU devices, on the CPU.

The reference runs ``moe_ffn`` under ``jax.set_mesh`` with the experts laid
out over "model" (``P("model")``), where it dispatches to ``moe_ffn_ep``
when the sequence splits over the 2 devices and to its GSPMD scatter path
otherwise; ``jax.value_and_grad`` of ``sum(y * w) + c * aux`` gives the
gradients.  The port runs ``moe_ffn`` on 2 spawned gloo ranks of
``make_local_mesh(model=2)``, each with its 2 of the 4 experts, the same
numpy inputs, and ``torch.autograd`` of the same loss.

Cases, all f32: the expert-parallel layer (B 2, S 8, d 16, f 24, top-2 of
4 experts) at capacity factor 1.0, where each rank's *local* capacity
``round(cf * k * T_local / E)`` = 4 drops tokens (counted on the port's
side, and the layer's output differs from the unsharded one's: the
reference's does too); the fallback at S 3 (does not split over 2 ranks),
forward and gradients, and at S 1 (decode), forward.

Held within 1e-5 relative (atol 1e-6): y, aux, and the gradients of x, the
router (summed over the model ranks: each rank routes only its tokens) and
each rank's experts against the same experts of the reference's.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import GLOO_TIMEOUT, spawn

B, D, F, E, K = 2, 16, 24, 4, 2
CF = 1.0
CASES = {"ep": 8, "fallback": 3, "decode": 1}
C_AUX = 0.37
RTOL, ATOL = 1e-5, 1e-6

_REFERENCE = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_local_mesh
from repro.models.moe import moe_ffn

cfg = MoEConfig(num_experts=E, top_k=K, capacity_factor=CF)
mesh = make_local_mesh(data=1, model=2)
out = {}
for name, S in CASES.items():
    a = np.load(f"{OUT}/inputs_{name}.npz")
    p = {k: jnp.asarray(a[k]) for k in ("router", "gate", "up", "down")}
    x, w = jnp.asarray(a["x"]), jnp.asarray(a["w"])

    def loss(p, x):
        y, aux = moe_ffn(p, x, cfg)
        return jnp.sum(y * w) + C_AUX * aux, (y, aux)

    with jax.set_mesh(mesh):
        ex = NamedSharding(mesh, P("model"))
        rep = NamedSharding(mesh, P())
        p = {k: jax.device_put(v, ex if k != "router" else rep) for k, v in p.items()}
        x = jax.device_put(x, rep)
        (l, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
    res = {"y": np.asarray(y), "aux": np.asarray(aux), "gx": np.asarray(gx)}
    res.update({"g_" + k: np.asarray(v) for k, v in gp.items()})
    np.savez(f"{OUT}/ref_{name}.npz", **res)
print("RESULT:" + json.dumps({"ok": True}))
"""


def _inputs(S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f32(B, S, D), "w": f32(B, S, D), "router": f32(D, E),
            "gate": f32(E, D, F) * 0.3, "up": f32(E, D, F) * 0.3,
            "down": f32(E, F, D) * 0.3}


def _port_rank(rank: int, init: str, out: str) -> None:
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import TensorParallel
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(model=2, device="cpu", timeout=GLOO_TIMEOUT)
        tp = TensorParallel.of(mesh)
        cfg = MoEConfig(num_experts=E, top_k=K, capacity_factor=CF)
        El = E // 2
        res = {}
        for name, S in CASES.items():
            a = np.load(f"{out}/inputs_{name}.npz")
            p = {k: torch.tensor(a[k][rank * El:(rank + 1) * El] if k != "router"
                                 else a[k], requires_grad=True)
                 for k in ("router", "gate", "up", "down")}
            x = torch.tensor(a["x"], requires_grad=True)
            y, aux = moe_lib.moe_ffn(p, x, cfg, tp=tp)
            (torch.sum(y * torch.tensor(a["w"])) + C_AUX * aux).backward()
            got = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
                   "gx": x.grad.numpy()}
            got.update({"g_" + k: v.grad.numpy() for k, v in p.items()})
            np.savez(f"{out}/port_{name}_rank{rank}.npz", **got)
            # the tokens this rank's local capacity drops on the EP path
            if name == "ep":
                xs = a["x"][:, rank * S // 2:(rank + 1) * S // 2].reshape(-1, D)
                logits = torch.tensor(xs) @ torch.tensor(a["router"])
                _, _, ids = moe_lib.route(logits.float(), K)
                C = moe_lib.capacity(cfg, xs.shape[0])
                res["dropped"] = int((~moe_lib.slots(ids, E, C)[1]).sum())
        with open(f"{out}/port_rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("moeep")
    for i, (name, S) in enumerate(CASES.items()):
        np.savez(out / f"inputs_{name}.npz", **_inputs(S, i))
    head = (f"OUT = {str(out)!r}\nCASES = {CASES!r}\nE, K, CF = {E}, {K}, {CF}\n"
            f"C_AUX = {C_AUX}\n")
    multidev(head + _REFERENCE, ndev=2, timeout=300)
    spawn(_port_rank, 2, (f"file://{out}/rdv", str(out)))
    info = [json.load(open(out / f"port_rank{r}.json")) for r in range(2)]
    return out, info


def _check(out, name: str, keys) -> None:
    ref = np.load(out / f"ref_{name}.npz")
    El = E // 2
    for r in range(2):
        got = np.load(out / f"port_{name}_rank{r}.npz")
        for k in keys:
            want = ref[k]
            if k in ("g_gate", "g_up", "g_down"):
                want = want[r * El:(r + 1) * El]
            np.testing.assert_allclose(got[k], want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} rank {r} {k}")


GRADS = ("gx", "g_router", "g_gate", "g_up", "g_down")


def test_moe_ep_local_capacity_drops_tokens(runs):
    _, info = runs
    assert sum(i["dropped"] for i in info) > 0, info


def test_moe_ep_forward_and_aux_match_reference(runs):
    out, _ = runs
    _check(out, "ep", ("y", "aux"))


def test_moe_ep_gradients_match_reference(runs):
    """x's, each rank's experts' and the router's: the router is used on
    each rank's tokens only, and its gradient is summed over the model
    ranks as the reference's GSPMD sums it."""
    out, _ = runs
    _check(out, "ep", GRADS)


def test_moe_fallback_matches_reference(runs):
    """S 3 does not split over 2 ranks: the scatter path over every token,
    each rank's experts, the outputs gathered before the combine."""
    out, _ = runs
    _check(out, "fallback", ("y", "aux") + GRADS)


def test_moe_decode_fallback_matches_reference(runs):
    out, _ = runs
    _check(out, "decode", ("y", "aux"))
