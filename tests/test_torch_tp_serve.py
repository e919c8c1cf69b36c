"""The port's serving over a model axis against the JAX package's, on the
CPU: ``Server.generate`` and the prefill on 1 pod x 1 data rank x 2 model
ranks.

The reference builds ``Server(rc, mesh)`` and ``build_serve_step(rc, mesh,
"prefill")`` on ``make_local_mesh(data=1, model=2)`` over 2 fake CPU devices
(GSPMD shards the parameters by ``tree_specs`` and the cache's K/V heads by
``cache_spec``); the port runs ``Server(rc, params, mesh=mesh)`` and
``build_serve_step(rc, "prefill", mesh=mesh)`` on 2 spawned gloo ranks of
``make_local_mesh(model=2)``, each taking its TP blocks of the reference's
whole parameters.  Smoke llama3.2-3b (dense, tied embedding) and
phi3.5-moe-42b-a6.6b (its prefill through ``moe_ep``: 16 prompt tokens
split over the 2 ranks; its decode through the expert-sharded fallback),
both with 2 K/V heads so that they divide over the 2 ranks as at published
width (the smoke configs' 1 would need the reference's seq-sharded cache,
which the port queues), the reference's initial parameters cast to f32.

Each side prefills 2 prompts of 16 tokens, lands the prefill's cache in a
32-token decode cache and generates 8 greedy tokens from the prompts' last
logits with ``Server.generate``; the decode logits come from the decode
bundle stepped the same way from a second landed cache.  Held: the prefill
logits within 1e-4 relative (f32; atol 1e-5), the decode logits within
2e-4 absolute (each decoded token's K/V is rounded into the cache's bf16,
and an f32 rounding difference that flips that rounding moves the logits
by up to 6e-5 here), both model ranks' bit-identical, and the generated
tokens equal to the reference's.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import GLOO_TIMEOUT, spawn
from test_torch_train_step import _load_state

ARCHS = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b")
KV_HEADS = 2
B, S, MAXLEN, NEW = 2, 16, 32, 8
RTOL, ATOL = 1e-4, 1e-5
DECODE_ATOL = 2e-4

_REFERENCE = r"""
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, smoke_config, RunConfig, ShapeConfig
from repro.launch.mesh import make_local_mesh
from repro.models.param import tree_init
from repro.runtime.serve_loop import Server
from repro.runtime.step import build_serve_step

mesh = make_local_mesh(data=1, model=2)
out = {}
for arch in ARCHS:
    cfg = dataclasses.replace(smoke_config(get_config(arch)), num_kv_heads=KV_HEADS)
    rc_p = RunConfig(model=cfg, shape=ShapeConfig("p", S, B, "prefill"))
    rc_d = RunConfig(model=cfg, shape=ShapeConfig("d", MAXLEN, B, "decode"))
    prompts = np.load(f"{OUT}/prompts_{arch}.npy")
    with jax.set_mesh(mesh):
        pb = build_serve_step(rc_p, mesh, "prefill")
        params = jax.tree.map(lambda a: a.astype(jnp.float32), tree_init(pb.param_defs, 0))
        flat = {jax.tree_util.keystr(p): np.asarray(a)
                for p, a in jax.tree_util.tree_leaves_with_path(params)}
        np.savez(f"{OUT}/params_{arch}.npz", **flat)
        server = Server(rc_d, mesh, params=params)
        logits, cache = pb.fn(server.params, {"tokens": jnp.asarray(prompts, jnp.int32)})

        def landed():
            full = {}
            for k, v in cache.items():
                pd = server.bundle.cache_defs[k]
                z = np.zeros(pd.shape, jnp.dtype(pd.dtype))      # the cache's bf16
                z[:, :, :S] = np.asarray(v).astype(z.dtype)
                full[k] = z
            return jax.device_put(full, server._sh(server.bundle.state_specs["cache"]))

        tok0 = np.asarray(jnp.argmax(logits[:, -1:, :], axis=-1)).astype(np.int32)
        res = server.generate(tok0, max_new=NEW, prefill_pos=S, cache=landed())
        c2, t, dec = landed(), jnp.asarray(tok0), []
        for i in range(NEW):
            l, c2 = server.bundle.fn(server.params, c2, jnp.int32(S + i), t)
            dec.append(np.asarray(l))
            t = jnp.argmax(l[:, -1:, :], axis=-1).astype(jnp.int32)
    np.savez(f"{OUT}/ref_{arch}.npz", prefill=np.asarray(logits), decode=np.stack(dec),
             tokens=res.tokens)
print("RESULT:" + json.dumps({"ok": True}))
"""


def _port_rank(rank: int, init: str, out: str) -> None:
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeConfig, get_config, smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.param import params_from_jax
    from repro_torch.runtime import Server, build_serve_step, land_prefill
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(model=2, device="cpu", timeout=GLOO_TIMEOUT)
        for arch in ARCHS:
            cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                      num_kv_heads=KV_HEADS)
            rc_p = RunConfig(model=cfg, shape=ShapeConfig("p", S, B, "prefill"))
            rc_d = RunConfig(model=cfg, shape=ShapeConfig("d", MAXLEN, B, "decode"))
            params = params_from_jax(_load_state(f"{out}/params_{arch}.npz"), "cpu")
            server = Server(rc_d, params=params, mesh=mesh)
            pb = build_serve_step(rc_p, "prefill", mesh=mesh)
            prompts = torch.as_tensor(np.load(f"{out}/prompts_{arch}.npy")).long()
            logits, cache = pb.fn(server.params, {"tokens": prompts})
            landed = lambda: land_prefill(server.init_cache(), cache)
            tok0 = torch.argmax(logits[:, -1:, :], dim=-1)
            res = server.generate(tok0.numpy(), max_new=NEW, prefill_pos=S,
                                  cache=landed())
            c2, t, dec = landed(), tok0, []
            for i in range(NEW):
                lg, c2 = server.bundle.fn(server.params, c2, S + i, t)
                dec.append(lg.numpy())
                t = torch.argmax(lg[:, -1:, :], dim=-1)
            np.savez(f"{out}/port_{arch}_rank{rank}.npz", prefill=logits.numpy(),
                     decode=np.stack(dec), tokens=res.tokens,
                     cache_k=cache["k"].numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(multidev, tmp_path_factory):
    out = tmp_path_factory.mktemp("tpserve")
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        np.save(out / f"prompts_{arch}.npy",
                rng.integers(0, 256, size=(B, S)).astype(np.int32))
    head = (f"OUT = {str(out)!r}\nARCHS = {ARCHS!r}\nKV_HEADS = {KV_HEADS}\n"
            f"B, S, MAXLEN, NEW = {B}, {S}, {MAXLEN}, {NEW}\n")
    multidev(head + _REFERENCE, ndev=2, timeout=600)
    spawn(_port_rank, 2, (f"file://{out}/rdv", str(out)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_logits_match_reference(runs, arch):
    ref = np.load(runs / f"ref_{arch}.npz")
    got = [np.load(runs / f"port_{arch}_rank{r}.npz") for r in range(2)]
    for key in ("prefill", "decode"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
        np.testing.assert_allclose(got[0][key], ref[key], rtol=RTOL,
                                   atol=ATOL if key == "prefill" else DECODE_ATOL,
                                   err_msg=f"{arch} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_server_generate_matches_reference(runs, arch):
    ref = np.load(runs / f"ref_{arch}.npz")
    for r in range(2):
        got = np.load(runs / f"port_{arch}_rank{r}.npz")
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_tp_cache_holds_each_ranks_kv_heads(runs):
    """The prefill's K/V leaves carry one of the 2 K/V heads a rank."""
    for arch in ARCHS:
        for r in range(2):
            k = np.load(runs / f"port_{arch}_rank{r}.npz")["cache_k"]
            assert k.shape[3] == KV_HEADS // 2, (arch, k.shape)
