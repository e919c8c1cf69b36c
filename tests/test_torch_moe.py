"""The port's MoE family (phi3.5-moe-42b-a6.6b) against the JAX package's,
on the CPU, at smoke size (4 layers, 4 experts top-2, d_model 128).

``models/moe.py``'s scatter path alone: router, top-k with the reference's
tie order, renormalised gates, the Switch aux loss, capacity with Python's
round, the exclusive per-expert slots in token-major order, the overflow
drop, dispatch, the batched expert SwiGLU and the combine; with forced
router ties and with drops.  Then the whole model: logits and the loss with
its ``0.01 * aux / num_layers``, prefill's logits and KV, 8 decode steps,
``Server.generate``, and the serving engine's tokens, in f32 and in bf16.

Tolerances (``tests/test_torch_ssm.py``'s, whose helpers are used): f32
parameters within 5e-3, bf16 one layer within 5e-2 (the dense model's
bound); greedy tokens equal up to a near tie of the reference.  Routing is
discrete: two router logits of a token within rounding of each other could
send it to another expert in the other package; the forced ties are exact
in both packages, so the tie order is what decides them.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CommConfig as JCommConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.core.path import WAN_LONDON_POZNAN as J_WAN_LP
from repro.core.path import WidePath as JWidePath
from repro.launch.mesh import make_local_mesh
from repro.models import moe as JMoE
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch.configs import CommConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.core.path import WAN_LONDON_POZNAN, WidePath
from repro_torch.models import moe as PMoE
from repro_torch.runtime import ServingEngine
from test_serving import _requests
from test_torch_ssm import (LENS, TOL, as_np, check_decode_steps,
                            check_prefill_state, check_server_generate, close,
                            pair)

ARCH = "phi3.5-moe-42b-a6.6b"


def _layer(jp, pp, i: int = 1):
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["ffn"]),
            {k: v[i] for k, v in pp["blocks"]["ffn"].items()})


def _x(S: int, d: int, seed: int = 3, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, S, d)) * 0.5


def _moe_pair(lj, lp, x, cfg, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jaux = JMoE.moe_ffn(lj, jnp.asarray(x, jdt), cfg)
    py, paux = PMoE.moe_ffn(lp, torch.as_tensor(x).to(tdt), cfg)
    return (jy, jaux), (py, paux)


def _slots_np(ids: np.ndarray, E: int, C: int):
    """The reference's slot rule written out: each (token, choice) in
    token-major, choice-minor order takes its expert's next slot."""
    count = np.zeros(E, np.int64)
    pos = []
    for e in ids.reshape(-1):
        pos.append(count[e])
        count[e] += 1
    pos = np.asarray(pos)
    return pos, pos < C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENS)
def test_moe_layer_matches_reference(dtype, S):
    jm, pm, jp, pp = pair(ARCH, dtype)
    lj, lp = _layer(jp, pp)
    (jy, jaux), (py, paux) = _moe_pair(lj, lp, _x(S, pm.cfg.d_model), pm.cfg.moe, dtype)
    assert py.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert paux.dtype == torch.float32 and paux.dim() == 0
    close(py, jy, TOL[dtype], "y")
    close(paux, jaux, TOL[dtype], "aux")


def test_top_k_breaks_ties_as_the_reference():
    """Probabilities with many exact ties: the port's ids are
    ``jax.lax.top_k``'s (the lower expert index first)."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, size=(64, 16)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, jids = jax.lax.top_k(probs, 2)
    _, gates, ids = PMoE.route(torch.as_tensor(logits), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_router_ties_match_reference(dtype):
    """Experts 1 and 2 given the same router column, and expert 3 the same
    as expert 0: every token's router logits tie in pairs, exactly, in both
    packages; the layer must pick as the reference does."""
    jm, pm, jp, pp = pair(ARCH, dtype)
    lj, lp = _layer(jp, pp)
    r = np.asarray(lj["router"]).copy()
    r[:, 2], r[:, 3] = r[:, 1], r[:, 0]
    lj = dict(lj, router=jnp.asarray(r, lj["router"].dtype))
    lp = dict(lp, router=torch.as_tensor(np.asarray(r, np.float32)).to(lp["router"].dtype))
    x = _x(LENS[0], pm.cfg.d_model, seed=9)
    xt = torch.as_tensor(x).to(lp["router"].dtype)
    logits = (xt.reshape(-1, x.shape[-1]) @ lp["router"]).float()
    assert torch.equal(logits[:, 1], logits[:, 2]) and torch.equal(logits[:, 0], logits[:, 3])
    _, _, ids = PMoE.route(logits, 2)
    assert bool((ids[:, 0] < ids[:, 1]).all())      # each pair in index order
    (jy, jaux), (py, paux) = _moe_pair(lj, lp, x, pm.cfg.moe, dtype)
    close(py, jy, TOL[dtype], "y")
    close(paux, jaux, TOL[dtype], "aux")


def test_overflow_drops_match_reference():
    """capacity_factor 0.5: C = round(0.5 * 2 * 40 / 4) = 10 slots for 80
    assignments, so tokens overflow; the drops are the reference's slot
    rule's, and the layer's output the reference's."""
    jm, pm, jp, pp = pair(ARCH, "float32")
    cfg = replace(pm.cfg.moe, capacity_factor=0.5)
    lj, lp = _layer(jp, pp)
    x = _x(20, pm.cfg.d_model, seed=4)
    T = x.shape[0] * x.shape[1]
    C = PMoE.capacity(cfg, T)
    assert C == int(max(1, round(0.5 * 2 * T / 4))) == 10
    xt = torch.as_tensor(x).float().reshape(T, -1)
    _, _, ids = PMoE.route((xt @ lp["router"]).float(), 2)
    pos, keep = PMoE.slots(ids, 4, C)
    want_pos, want_keep = _slots_np(ids.numpy(), 4, C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < int((~keep).sum()) < T * 2 - C
    (jy, jaux), (py, paux) = _moe_pair(lj, lp, x, cfg, "float32")
    close(py, jy, TOL["float32"], "y")
    close(paux, jaux, TOL["float32"], "aux")
    # a token whose both choices were dropped gets zeros, in both packages
    gone = (~keep).reshape(T, 2).all(axis=1).numpy()
    if gone.any():
        assert not as_np(py).reshape(T, -1)[gone].any()


def test_expert_parallel_path_waits_for_tensor_parallelism():
    """The expert-parallel path (``moe_ep``) is taken where the reference
    takes it: a model axis of more than one rank that tiles the experts and
    the sequence; one rank keeps the scatter path, and so do decode and a
    sequence that does not split (tests/test_torch_moe_ep.py holds both
    paths against the reference on 2 ranks)."""
    from repro_torch.models import moe_ep
    assert not moe_ep.ep_applicable(4, 8, 1)
    assert moe_ep.ep_applicable(4, 8, 2)
    assert not moe_ep.ep_applicable(4, 1, 2)      # decode
    assert not moe_ep.ep_applicable(4, 3, 2)      # the sequence does not split
    assert not moe_ep.ep_applicable(6, 8, 4)      # the experts do not tile


@pytest.mark.parametrize("S", LENS)
def test_logits_and_loss_with_aux_match_reference(S):
    check_logits_and_loss_moe(S)


def check_logits_and_loss_moe(S: int) -> None:
    """Logits, and the loss with its aux term: loss = ce + 0.01 * aux / L."""
    jm, pm, jp, pp = pair(ARCH, "float32")
    toks = np.random.default_rng(11).integers(1, jm.cfg.vocab_size, (2, S + 1))
    jl = jm.logits(jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)})
    pl = pm.logits(pp, {"tokens": torch.as_tensor(toks[:, :S])})
    close(pl, jl, TOL["float32"], "logits")
    jloss, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    ploss, pmet = pm.loss(pp, {"tokens": torch.as_tensor(toks)})
    close(ploss, jloss, TOL["float32"], "loss")
    close(pmet["aux_loss"], jmet["aux_loss"], TOL["float32"], "aux")
    assert float(pmet["aux_loss"]) > 0
    torch.testing.assert_close(
        ploss, pmet["ce_loss"] + 0.01 * pmet["aux_loss"] / pm.cfg.num_layers)


def test_loss_is_differentiable():
    """The aux term reaches the router through autograd."""
    _, pm, _, pp = pair(ARCH, "float32")
    params = {k: v for k, v in pp.items()}
    router = pp["blocks"]["ffn"]["router"].clone().requires_grad_(True)
    params["blocks"] = dict(pp["blocks"], ffn=dict(pp["blocks"]["ffn"], router=router))
    toks = torch.as_tensor(np.random.default_rng(1).integers(1, 256, (2, 17)))
    loss, _ = pm.loss(params, {"tokens": toks})
    loss.backward()
    assert router.grad is not None and bool(router.grad.abs().sum() > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_kv_match_reference(dtype):
    check_prefill_state(ARCH, dtype, LENS[0])


def test_decode_steps_match_reference():
    check_decode_steps(ARCH, 20, 40)


def test_server_generate_matches_reference():
    check_server_generate(ARCH, 20, 40)


def _recording_margins(eng) -> dict:
    """Wrap the reference engine's decode step: rid -> {token index: the
    top-1 minus top-2 logit of the batched decode step that chose it}."""
    margins: dict = {}
    fn = eng.server.bundle.fn

    def step(params, cache, pos, tok):
        logits, cache = fn(params, cache, pos, tok)
        top = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)
        for slot, rid in eng._decoding.items():
            margins.setdefault(rid, {})[len(eng._outputs[rid])] = float(
                top[slot, -1] - top[slot, -2])
        return logits, cache
    eng.server.bundle.fn = step
    return margins


# (mode, dtype): the ids without a dtype are the f32 cases
ENGINE_CASES = [("mono", "float32"), ("disagg-int8", "float32"),
                ("mono", "bfloat16"), ("disagg-int8", "bfloat16")]


@pytest.mark.parametrize("mode,dtype", ENGINE_CASES,
                         ids=["mono", "disagg-int8", "mono-bf16", "disagg-int8-bf16"])
def test_engine_serves_moe_like_reference(mode, dtype):
    """The reference's 5-request trace through both engines: the same
    timeline, and each request's tokens equal up to its first departure,
    where the reference's margin (top-1 minus top-2 logit of the step that
    chose the token: the prompt's prefill for token 0, else the batched
    decode step) must be a near tie, within twice the dtype's logit
    tolerance (``TOL``: 1e-2 in f32, 0.1 in bf16).  In bf16 the two
    packages' logits differ by up to ~0.07 at every step (bf16 rounding at
    other places), and a router logit as near a tie can send one of the 3
    slots' tokens to another expert or past the capacity of 2 a step,
    which moves another slot's logits by O(1) (ROADMAP.md §C 17); past the
    first departure the greedy decodes may rightly part."""
    jm, pm, jp, pp = pair(ARCH, dtype)
    shape = ("d", 64, 3, "decode")
    jrc = JRunConfig(model=jm.cfg, shape=JShapeConfig(*shape), comm=JCommConfig(),
                     train=JTrainConfig())
    rc = RunConfig(model=pm.cfg, shape=ShapeConfig(*shape), comm=CommConfig(),
                   train=TrainConfig())
    kw, jkw = {}, {}
    if mode != "mono":
        comm = dict(streams=4, chunk_mb=0.001, compress="int8")
        jkw = dict(mode="disagg", path=JWidePath(axis="pod", comm=JCommConfig(**comm),
                                                 link=J_WAN_LP, name="kvship"))
        kw = dict(mode="disagg", path=WidePath(axis="pod", comm=CommConfig(**comm),
                                               link=WAN_LONDON_POZNAN, name="kvship"))
    reqs = _requests(jm.cfg)
    ref = JServingEngine(jrc, make_local_mesh(), params=jp, **jkw)
    margins = _recording_margins(ref)
    port = ServingEngine(rc, params=pp, device="cpu", **kw)
    for eng in (ref, port):
        for prompt, mnew in reqs:
            assert eng.submit(prompt, mnew) is not None
        assert eng.run_to_completion()["completed"] == len(reqs)
    assert port.batcher.timeline() == ref.batcher.timeline()
    for rid, (prompt, mnew) in enumerate(reqs):
        r, p = ref.results[rid], port.results[rid]
        assert len(r) == len(p) == mnew
        diff = np.flatnonzero(r != p)
        if diff.size:
            t = int(diff[0])
            if t == 0:
                logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)})
                top = np.sort(np.asarray(logits[0, -1], np.float32))
                m = float(top[-1] - top[-2])
            else:
                m = margins[rid][t]
            assert m <= 2 * TOL[dtype], (rid, t, m)
