"""The port's training pieces against the JAX package's, on the CPU: the
differentiable layers, the optimizer and schedule, the int8 gradient codec,
and the whole model's loss and gradients.

Inputs are numpy draws from fixed seeds handed to both packages; gradients
come from ``jax.grad`` on one side and ``torch.autograd`` on the other, for
the same scalar (the output times a fixed random cotangent).

Tolerances, each with its reason:

* f32: 1e-5 relative to the largest entry (the same f32 arithmetic, sums
  taken in another order);
* bf16: 2e-2 relative to the largest entry (activations and cotangents are
  rounded to bf16, 2^-9 relative, at places that differ between XLA and
  PyTorch);
* the int8 codec, the AdamW update and the schedule: exact or within one
  f32 ulp, as each test says.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, smoke_config
from repro.core import compress as jcomp
from repro.kernels import ops as jops
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models.param import tree_init as jax_tree_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim import lr_at as j_lr_at
from repro_torch.configs import TrainConfig
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import smoke_config as pt_smoke_config
from repro_torch.core import compress as pcomp
from repro_torch.core.tree import flatten
from repro_torch.kernels import ops
from repro_torch.models import build_model as pt_build_model
from repro_torch.models import layers as players
from repro_torch.models.param import params_from_jax, state_from_jax
from repro_torch.optim import adamw_update, global_norm, init_opt_state, lr_at

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _draw(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return np.asarray(np.random.default_rng(seed).standard_normal(shape) * scale,
                      dtype=np.float32)


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = DT[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol: float, what: str = "") -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    top = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= tol * top, f"{what}: max err {err} > {tol} * {top}"


# ---------------------------------------------------------------------------
# rms_norm: the custom_vjp and its Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32")])
def test_rms_norm_value_and_grads_match_reference(dtype, wdtype):
    x_np, w_np, g_np = _draw(1, (3, 7, 96)), _draw(2, (96,)) + 1.0, _draw(3, (3, 7, 96))
    jx, px = _pair(x_np, dtype)
    jw, pw = _pair(w_np, wdtype)
    jg = jnp.asarray(g_np)

    def jloss(x, w):
        return jnp.sum(jlayers.rms_norm(x, w, 1e-5).astype(jnp.float32) * jg)

    jy = jlayers.rms_norm(jx, jw, 1e-5)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jx, jw)
    px.requires_grad_(True)
    pw.requires_grad_(True)
    py = players.rms_norm(px, pw, 1e-5)
    (py.float() * torch.from_numpy(g_np)).sum().backward()
    # dx in the input's dtype, dw in w's, as the reference's _rms_bwd
    assert py.dtype == px.dtype and px.grad.dtype == px.dtype
    assert pw.grad.dtype == pw.dtype
    assert str(jdx.dtype) == dtype and str(jdw.dtype) == wdtype
    _close(py, jy, TOL[dtype], "y")
    _close(px.grad, jdx, TOL[dtype], "dx")
    _close(pw.grad, jdw, TOL[dtype], "dw")


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,dtype", [(32, 8, "float32"),
                                           (30, 8, "float32"),     # ragged last chunk
                                           (30, 8, "bfloat16"),
                                           (12, 512, "float32")])  # one chunk
def test_chunked_ce_loss_value_and_grads_match_reference(S, chunk, dtype):
    B, d, V = 2, 32, 50
    x_np, h_np = _draw(4, (B, S, d)), _draw(5, (d, V), 0.3)
    labels = np.random.default_rng(6).integers(0, V, size=(B, S))
    jx, px = _pair(x_np, dtype)
    jh, ph = _pair(h_np, dtype)

    def jloss(x, h):
        return jlayers.chunked_ce_loss(x, h, jnp.asarray(labels), chunk=chunk)

    (jl, jc), = [jloss(jx, jh)]
    jdx, jdh = jax.grad(lambda x, h: jloss(x, h)[0], argnums=(0, 1))(jx, jh)
    px.requires_grad_(True)
    ph.requires_grad_(True)
    pl, pc = players.chunked_ce_loss(px, ph, torch.from_numpy(labels), chunk=chunk)
    pl.backward()
    assert pl.dtype == torch.float32 and float(pc) == float(jc) == B * S
    # the head's cotangent stays in the activations' dtype (bf16 stays bf16)
    assert ph.grad.dtype == ph.dtype and px.grad.dtype == px.dtype
    _close(pl, jl, TOL[dtype], "loss")
    _close(px.grad, jdx, TOL[dtype], "dx")
    _close(ph.grad, jdh, TOL[dtype], "dhead")


# ---------------------------------------------------------------------------
# attention gradients: the plain path, against jax.grad of causal_blocked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,H,KH,D,window,dtype", [
    (24, 24, 4, 2, 16, None, "float32"),
    (24, 24, 4, 2, 16, 7, "float32"),        # windowed
    (10, 24, 6, 2, 32, 9, "float32"),        # query suffix + window
    (24, 24, 4, 4, 16, None, "bfloat16")])
def test_flash_attention_grads_match_reference(Sq, Sk, H, KH, D, window, dtype):
    q_np, k_np, v_np = _draw(7, (2, Sq, H, D)), _draw(8, (2, Sk, KH, D)), _draw(9, (2, Sk, KH, D))
    g_np = _draw(10, (2, Sq, H, D))
    (jq, pq), (jk, pk), (jv, pv) = (_pair(a, dtype) for a in (q_np, k_np, v_np))

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, causal=True, window=window,
                                 impl="causal_blocked")
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g_np))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for t in (pq, pk, pv):
        t.requires_grad_(True)
    o = ops.flash_attention(pq, pk, pv, causal=True, window=window)
    (o.float() * torch.from_numpy(g_np)).sum().backward()
    for name, got, want in zip(("dq", "dk", "dv"), (pq.grad, pk.grad, pv.grad), jgrads):
        assert got.dtype == DT[dtype][1]
        _close(got, want, TOL[dtype], name)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def _opt_trees(seed: int):
    shapes = {"a": (4, 33), "b": {"c": (17,), "d": (2, 3, 5)}}
    rng = np.random.default_rng(seed)

    def mk(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"a": mk(shapes["a"]), "b": {"c": mk((17,)), "d": mk((2, 3, 5))}}
    g = {"a": mk(shapes["a"], 3.0), "b": {"c": mk((17,), 3.0), "d": mk((2, 3, 5), 3.0)}}
    return p, g


@pytest.mark.parametrize("pdtype,clip", [("float32", 1.0), ("bfloat16", 1.0),
                                         ("float32", 0.0)])
def test_adamw_update_matches_reference(pdtype, clip):
    p_np, g_np = _opt_trees(11)
    kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=clip, beta1=0.9, beta2=0.95,
              eps=1e-8)
    jtc, ptc = JTrainConfig(**kw), TrainConfig(**kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(DT[pdtype][0]), p_np)
    jg = jax.tree.map(jnp.asarray, g_np)
    jopt = j_init_opt_state(jp)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    pg = params_from_jax(g_np, "cpu")
    popt = init_opt_state(pp)
    for step in range(3):          # the moments carry over
        lr = jnp.float32(2e-3)
        jp, jopt, jst = j_adamw_update(jg, jopt, jp, jtc, lr)
        pp, popt, pst = adamw_update(pg, popt, pp, ptc, torch.tensor(2e-3))
        assert int(popt["step"]) == int(jopt["step"]) == step + 1
        np.testing.assert_allclose(_np(pst["grad_norm"]), _np(jst["grad_norm"]),
                                   rtol=1e-6)
        jl, pl = jax.tree.leaves(jp), flatten(pp)[0]
        for a, b in zip(jl, pl):
            assert b.dtype == DT[pdtype][1]
            # the same f32 sequence of operations; pow and sqrt may round
            # their last bit differently in XLA and PyTorch
            np.testing.assert_allclose(_np(b), _np(a), rtol=2e-6 if pdtype == "float32" else 0,
                                       atol=1e-7 if pdtype == "float32" else 0)
        for key in ("m", "v"):
            for a, b in zip(jax.tree.leaves(jopt[key]), flatten(popt[key])[0]):
                np.testing.assert_allclose(_np(b), _np(a), rtol=2e-6, atol=1e-12)


def test_global_norm_and_queued_options():
    _, g_np = _opt_trees(12)
    pg = params_from_jax(g_np, "cpu")
    want = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                       for a in jax.tree.leaves(g_np)))
    np.testing.assert_allclose(float(global_norm(pg)), want, rtol=1e-6)
    # the bucketed update is ported (tests/test_torch_buckets.py); a plan
    # without the stacked flags it was built with is refused
    with pytest.raises(ValueError, match="stacked"):
        adamw_update(pg, init_opt_state(pg), pg, TrainConfig(), torch.tensor(1e-3),
                     buckets=object())


@pytest.mark.parametrize("warmup,total", [(1, 10), (10, 100), (0, 5)])
def test_lr_at_matches_reference(warmup, total):
    tc = dict(lr=3e-4, warmup_steps=warmup, total_steps=total, min_lr_ratio=0.1)
    for step in range(0, total + 3):
        want = float(j_lr_at(jnp.int32(step), JTrainConfig(**tc)))
        got = float(lr_at(step, TrainConfig(**tc)))
        np.testing.assert_allclose(got, want, rtol=2 ** -22)


# ---------------------------------------------------------------------------
# the int8 gradient codec, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dim", [((5, 300), 0), ((4, 130, 6), 1), ((1000,), 0),
                                       ((), 0), ((3, 256), 1)])
def test_quant_chunk_and_dequant_sum_bit_exact(shape, dim):
    xs = [_draw(20 + r, shape, 5.0) for r in range(2)]
    jq = [jcomp.quant_chunk(jnp.asarray(x), dim) for x in xs]
    pq = [pcomp.quant_chunk(torch.from_numpy(x), dim) for x in xs]
    for (a, sa, _), (b, sb, _) in zip(jq, pq):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(sb.numpy(), np.asarray(sa))
    want = jcomp.dequant_sum(jnp.stack([q for q, _, _ in jq]),
                             jnp.stack([s for _, s, _ in jq]), jq[0][2])
    got = pcomp.dequant_sum(torch.stack([q for q, _, _ in pq]),
                            torch.stack([s for _, s, _ in pq]), pq[0][2])
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = pcomp.dequant_chunk(*pq[0])
    np.testing.assert_array_equal(one.numpy(), np.asarray(jcomp.dequant_chunk(*jq[0])))


# ---------------------------------------------------------------------------
# the whole model: loss and one step's gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_smoke():
    cfg = smoke_config(get_config("llama3.2-3b"))
    jm = jax_build_model(cfg)
    pm = pt_build_model(pt_smoke_config(pt_get_config("llama3.2-3b")))
    return jm, pm, jax_tree_init(jm.param_defs(), 0)


@pytest.mark.parametrize("dtype,remat", [("float32", False), ("float32", True),
                                         ("bfloat16", False)])
def test_model_loss_and_grads_match_reference(llama_smoke, dtype, remat):
    import dataclasses
    jm, pm, jparams = llama_smoke
    pm = pt_build_model(dataclasses.replace(pm.cfg, remat=remat))
    jp = jax.tree.map(lambda a: a.astype(DT[dtype][0]), jparams)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(13).integers(0, 256, size=(2, 25))
    jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    jg = jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)})[0])(jp)
    leaves, td = flatten(pp)
    for t in leaves:
        t.requires_grad_(True)
    pl, pmet = pm.loss(pp, {"tokens": torch.as_tensor(tokens)})
    pl.backward()
    assert float(pmet["tokens"]) == float(jmet["tokens"]) == 2 * 24
    _close(pl, jl, 1e-5 if dtype == "float32" else 1e-2, "loss")
    tol = 1e-4 if dtype == "float32" else 5e-2
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jg), leaves):
        assert got.grad.dtype == got.dtype
        _close(got.grad, want, tol, jax.tree_util.keystr(path))


def test_state_from_jax_keeps_layout_dtypes_and_step():
    jstate = {"params": {"w": jnp.ones((2, 3), jnp.bfloat16), "b": {"c": jnp.zeros(4)}},
              "opt": {"m": {"w": jnp.full((2, 3), 0.5), "b": {"c": jnp.ones(4)}},
                      "v": {"w": jnp.full((2, 3), 0.25), "b": {"c": jnp.ones(4)}},
                      "step": jnp.int32(7)}}
    st = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert st["params"]["w"].dtype == torch.bfloat16
    assert st["opt"]["m"]["w"].dtype == torch.float32
    assert st["opt"]["step"].dtype == torch.int32 and int(st["opt"]["step"]) == 7
    assert float(st["opt"]["v"]["w"][1, 2]) == 0.25
