"""The port's Mamba2 family (mamba2-780m) against the JAX package's, on the
CPU, at smoke size (4 layers, d_model 128, SSD heads of 32, state 16, chunk
16).

Both packages take the JAX package's own parameter tree (``tree_init(defs,
0)``; the port through ``params_from_jax``, leaf by leaf with its dtype) and
the same numpy tokens.  Checked: logits and the loss of the whole model at a
length that is a multiple of the chunk and one that is not; prefill's logits
and its state tree (leaves, shapes, dtypes, values); 8 decode steps,
teacher-forced, from the prefill's state landed in a ``cache_defs`` cache;
``Server.generate``'s greedy tokens; the reference's prefill-vs-decode
parity within the port; and, in bf16, each block function on the same
inputs.  ``tests/test_torch_hybrid.py`` runs the same checks on zamba2 and
imports the helpers from here.

Tolerances, each with its reason:

* float32 parameters (the whole model): 5e-3, the reference's own bound for
  prefill against decode (``tests/test_models_smoke.py``).  Both sides
  compute in f32; sums run in other orders.
* bfloat16 parameters: 5e-2, the dense model's bound
  (``tests/test_torch_model.py``), on one block at a time given the same
  input.  The whole model is not held to it in bf16: XLA's bf16 logistic
  (inside ``jax.nn.silu``) differs from a correctly rounded one in about a
  third of its outputs, a one-ulp difference at every such place, and the
  SSD recurrence carries it from layer to layer (the reference keeps its own
  prefill-vs-decode check in f32 for this reason).
* bf16 leaves of the f32 model's state (the hybrid's K/V, the prefill's
  conv inputs): one bf16 ulp (2^-7 relative) on top of 5e-3, as both sides
  round an f32 value to bf16 and one that sits near a rounding tie may go to
  either neighbour after sums taken in other orders.
* greedy tokens: equal up to the first step where the reference's top-1 /
  top-2 logit margin is within twice the tolerance; past such a near tie
  the two greedy decodes may rightly part.
"""
from __future__ import annotations

import functools
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
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.launch.mesh import make_local_mesh
from repro.models import build_model as j_build_model
from repro.models import mamba2 as JM
from repro.models.param import PD as JPD
from repro.models.param import tree_init as j_tree_init
from repro.runtime.serve_loop import Server as JServer
from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.models import build_model
from repro_torch.models import mamba2 as PM
from repro_torch.models.param import params_from_jax, tree_init
from repro_torch.runtime import Server, land_prefill

TOL = {"float32": 5e-3, "bfloat16": 5e-2}
DECODE_STEPS = 8
GEN_TOKENS = 8
B = 2
LENS = (20, 32)          # the smoke chunk is 16: 20 pads the last chunk


@functools.lru_cache(maxsize=None)
def pair(arch: str, dtype: str, layers=None):
    """(JAX model, port model, JAX params, port params) at smoke size;
    `layers` overrides the depth.  float32 casts every leaf; bfloat16 keeps
    the reference's tree as it is (``A``, ``dt_bias`` f32)."""
    jcfg, pcfg = j_smoke_config(j_get_config(arch)), smoke_config(get_config(arch))
    if layers is not None:
        jcfg, pcfg = replace(jcfg, num_layers=layers), replace(pcfg, num_layers=layers)
    jm, pm = j_build_model(jcfg), build_model(pcfg)
    jp = j_tree_init(jm.param_defs(), 0)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jm, pm, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab: int, n: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, vocab, size=(B, n))


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


BF16_ULP = 2.0 ** -7


def close(got, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol,
                               err_msg=what)


def close_leaf(got, want, what: str) -> None:
    """A state or cache leaf of the f32 model: 5e-3, plus one bf16 ulp for a
    leaf stored in bf16."""
    rtol = TOL["float32"] + (BF16_ULP if str(want.dtype) == "bfloat16" else 0.0)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL["float32"],
                               rtol=rtol, err_msg=what)


def j_land(jcache: dict, state: dict) -> dict:
    """The reference's landing of a prefill state into a decode cache (what
    the port's ``land_prefill`` does in place)."""
    out = dict(jcache)
    for n, leaf in state.items():
        idx = tuple(slice(0, s) for s in leaf.shape)
        out[n] = jcache[n].at[idx].set(leaf.astype(jcache[n].dtype))
    return out


def check_logits_and_loss(arch: str, S: int, layers=None) -> None:
    jm, pm, jp, pp = pair(arch, "float32", layers)
    toks = tokens(jm.cfg.vocab_size, S + 1)
    jl = jm.logits(jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)})
    pl = pm.logits(pp, {"tokens": torch.as_tensor(toks[:, :S])})
    assert tuple(pl.shape) == tuple(jl.shape) == (B, S, jm.cfg.vocab_size)
    close(pl, jl, TOL["float32"], "logits")
    jloss, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    ploss, pmet = pm.loss(pp, {"tokens": torch.as_tensor(toks)})
    close(ploss, jloss, TOL["float32"], "loss")
    assert float(pmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    assert float(pmet["tokens"]) == float(jmet["tokens"]) == B * S


def check_prefill_state(arch: str, dtype: str, S: int, layers=None) -> None:
    """Prefill's logits and state tree: the reference's leaves, shapes and
    dtypes; values in f32 (bf16: see the module docstring)."""
    jm, pm, jp, pp = pair(arch, dtype, layers)
    toks = tokens(jm.cfg.vocab_size, S)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        pl, pst = pm.prefill(pp, {"tokens": torch.as_tensor(toks)})
    assert tuple(pl.shape) == tuple(jl.shape) == (B, 1, jm.cfg.vocab_size)
    assert pl.dtype == torch.float32
    assert sorted(pst) == sorted(jst)
    for n in jst:
        assert tuple(pst[n].shape) == tuple(jst[n].shape), n
        assert str(pst[n].dtype).removeprefix("torch.") == str(jst[n].dtype), n
    if dtype == "float32":
        close(pl, jl, TOL[dtype], "prefill logits")
        for n in jst:
            close_leaf(pst[n], jst[n], n)


def check_decode_steps(arch: str, S: int, max_len: int, layers=None) -> None:
    """The prefill's state landed in a cache of ``cache_defs(B, max_len)``,
    then DECODE_STEPS teacher-forced decode steps: logits at every step and
    the cache after the last, leaf by leaf; the cache keeps its dtypes."""
    jm, pm, jp, pp = pair(arch, "float32", layers)
    toks = tokens(jm.cfg.vocab_size, S + DECODE_STEPS)
    _, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)})
    jcache = j_land(j_tree_init(jm.cache_defs(B, max_len), 0), jst)
    pcache = tree_init(pm.cache_defs(B, max_len), 0, device="cpu")
    dtypes = {n: v.dtype for n, v in pcache.items()}
    assert {n: str(v.dtype) for n, v in jcache.items()} == \
        {n: str(d).removeprefix("torch.") for n, d in dtypes.items()}
    jstep = jax.jit(jm.decode_step)
    with torch.inference_mode():
        _, pst = pm.prefill(pp, {"tokens": torch.as_tensor(toks[:, :S])})
        land_prefill(pcache, pst)
        for i in range(DECODE_STEPS):
            tok = toks[:, S + i:S + i + 1]
            jl, jcache = jstep(jp, jcache, jnp.int32(S + i), jnp.asarray(tok, jnp.int32))
            pl, pcache = pm.decode_step(pp, pcache, S + i, torch.as_tensor(tok))
            close(pl, jl, TOL["float32"], f"decode step {i}")
    assert {n: v.dtype for n, v in pcache.items()} == dtypes
    for n in jcache:
        close_leaf(pcache[n], jcache[n], n)


def _ref_margins(jm, jp, jcache, first, S: int, ref_tokens: np.ndarray) -> np.ndarray:
    """(B, steps) top-1 minus top-2 logit of the reference's own greedy
    decode: step t's logits decide token t + 1 (token 0 is `first`)."""
    jstep = jax.jit(jm.decode_step)
    tok = jnp.asarray(first, jnp.int32)
    out = []
    for t in range(ref_tokens.shape[1]):
        logits, jcache = jstep(jp, jcache, jnp.int32(S + t), tok)
        top = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)
        out.append(top[:, -1] - top[:, -2])
        tok = jnp.asarray(ref_tokens[:, t:t + 1], jnp.int32)
    return np.stack(out, axis=1)


def check_server_generate(arch: str, S: int, max_len: int, layers=None) -> None:
    """Prefill, land, then each package's ``Server.generate`` decodes
    GEN_TOKENS greedily from the prefill's argmax."""
    jm, pm, jp, pp = pair(arch, "float32", layers)
    toks = tokens(jm.cfg.vocab_size, S, seed=5)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    first = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    jrc = JRunConfig(model=jm.cfg, shape=JShapeConfig("d", max_len, B, "decode"),
                     comm=JCommConfig(), train=JTrainConfig())
    rc = RunConfig(model=pm.cfg, shape=ShapeConfig("d", max_len, B, "decode"),
                   comm=CommConfig(), train=TrainConfig())
    jserver = JServer(jrc, make_local_mesh(), params=jp)
    jcache = j_land(jserver.init_cache(), jst)
    ref = jserver.generate(first, max_new=GEN_TOKENS, prefill_pos=S, cache=jcache)
    server = Server(rc, params=pp, device="cpu")
    with torch.inference_mode():
        pl, pst = server.bundle.model.prefill(pp, {"tokens": torch.as_tensor(toks)})
        assert np.array_equal(torch.argmax(pl[:, -1], dim=-1).numpy()[:, None], first)
        cache = land_prefill(server.init_cache(), pst)
    got = server.generate(first, max_new=GEN_TOKENS, prefill_pos=S, cache=cache)
    assert got.tokens.shape == ref.tokens.shape == (B, GEN_TOKENS)
    margins = _ref_margins(jm, jp, j_land(j_tree_init(jm.cache_defs(B, max_len), 0), jst),
                           first, S, ref.tokens)
    for row in range(B):
        diff = np.flatnonzero(got.tokens[row] != ref.tokens[row])
        if diff.size:
            t = int(diff[0])
            m = float(margins[row, t])
            assert m <= 2 * TOL["float32"], (
                f"row {row} parts from the reference at token {t} where the "
                f"reference's margin is {m}")


def check_prefill_matches_decode(arch: str, layers=None) -> None:
    """Within the port: prefill's last logits equal a token-by-token decode
    of the same prompt from an empty cache, the cache in f32 (the
    reference's own check, ``tests/test_models_smoke.py``, at its bound)."""
    _, pm, _, pp = pair(arch, "float32", layers)
    toks = torch.as_tensor(tokens(pm.cfg.vocab_size, 8)[:1])
    with torch.inference_mode():
        pl, _ = pm.prefill(pp, {"tokens": toks})
        cache = {n: v.float() for n, v in
                 tree_init(pm.cache_defs(1, 8), 0, device="cpu").items()}
        for i in range(8):
            dl, cache = pm.decode_step(pp, cache, i, toks[:, i:i + 1])
    close(pl[:, -1], dl[:, -1], TOL["float32"])
    assert int(pl[0, -1].argmax()) == int(dl[0, -1].argmax())


# -- mamba2-780m --------------------------------------------------------------

ARCH = "mamba2-780m"


@pytest.mark.parametrize("S", LENS)
def test_logits_and_loss_match_reference(S):
    check_logits_and_loss(ARCH, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENS)
def test_prefill_logits_and_state_match_reference(dtype, S):
    check_prefill_state(ARCH, dtype, S)


def test_decode_steps_match_reference():
    check_decode_steps(ARCH, 20, 40)


def test_server_generate_matches_reference():
    check_server_generate(ARCH, 20, 40)


def test_prefill_matches_token_by_token_decode():
    check_prefill_matches_decode(ARCH)


def _layer(tree: dict, i: int = 1) -> dict:
    return {k: v[i] for k, v in tree.items()}


@pytest.mark.parametrize("S", LENS)
def test_block_functions_match_reference_in_bf16(S):
    """mamba_forward and _final_state on one bf16 block and the same input."""
    jm, pm, jp, pp = pair(ARCH, "bfloat16")
    x = np.random.default_rng(3).standard_normal((B, S, jm.cfg.d_model)) * 0.5
    xj, xp = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    lj = jax.tree.map(lambda a: a[1], jp["blocks"])
    lp = _layer(pp["blocks"])
    close(PM.mamba_forward(lp, xp, pm.cfg), JM.mamba_forward(lj, xj, jm.cfg),
          TOL["bfloat16"], "mamba_forward")
    jst, pst = JM._final_state(lj, xj, jm.cfg), PM._final_state(lp, xp, pm.cfg)
    for n in jst:
        assert str(pst[n].dtype).removeprefix("torch.") == str(jst[n].dtype), n
    close(pst["conv"], jst["conv"], TOL["bfloat16"], "conv state")
    # the state sums S bf16 products: its bound scales with the largest entry
    scale = float(np.abs(as_np(jst["ssm"])).max())
    close(pst["ssm"] / scale, jst["ssm"] / scale, TOL["bfloat16"], "ssm state")


def test_mamba_decode_matches_reference_in_bf16():
    """One recurrent step of one bf16 block from the same f32 state: the
    window promotes to f32 as the reference's concatenation does."""
    jm, pm, jp, pp = pair(ARCH, "bfloat16")
    rng = np.random.default_rng(4)
    defs = pm.cache_defs(B, 1)
    st = {n: rng.standard_normal(d.shape[1:]).astype(np.float32) * 0.3
          for n, d in defs.items()}
    x = rng.standard_normal((B, 1, pm.cfg.d_model)) * 0.5
    jo, jnew = JM.mamba_decode(jax.tree.map(lambda a: a[1], jp["blocks"]),
                               {n: jnp.asarray(v) for n, v in st.items()},
                               jnp.asarray(x, jnp.bfloat16), jm.cfg)
    po, pnew = PM.mamba_decode(_layer(pp["blocks"]),
                               {n: torch.as_tensor(v) for n, v in st.items()},
                               torch.as_tensor(x).bfloat16(), pm.cfg)
    assert po.dtype == torch.bfloat16 and str(jo.dtype) == "bfloat16"
    close(po, jo, TOL["bfloat16"], "out")
    for n in jnew:
        assert pnew[n].dtype == torch.float32 and str(jnew[n].dtype) == "float32"
        close(pnew[n], jnew[n], TOL["bfloat16"], n)


def test_ssd_chunk_padding_matches_reference():
    """The chunked scan alone at lengths around the chunk (pad 0, 1, Q-1)
    and with more than one chunk, f32; and the state it leaves against the
    reference's sum over the prompt (``_final_state``'s, in numpy)."""
    rng = np.random.default_rng(6)
    H, P, N, Q = 3, 4, 5, 8
    for S in (8, 9, 15, 24, 25):
        xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
        A = -rng.uniform(1, 16, H).astype(np.float32)
        Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
        want = JM._ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), Q)
        got, state = PM._ssd_chunked(*(torch.as_tensor(a) for a in (xh, dt, A, Bm, Cm)),
                                     Q)
        close(got, want, 1e-5, f"S={S}")
        dA = dt.astype(np.float64) * A
        suffix = np.cumsum(dA[:, ::-1], axis=1)[:, ::-1] - dA       # sum_{j>s} dA_j
        want_state = np.einsum("bshp,bsn->bhpn",
                               xh * (dt * np.exp(suffix))[..., None], Bm)
        close(state, want_state, 1e-5, f"state S={S}")


def test_init_draws_ssm_a_and_arange():
    """``ssm_a``: -uniform(1, 16) in f32 inside a bf16 tree; ``arange``: 1..n
    along the last dim, as the reference's inits."""
    from repro_torch.models.param import PD, init_one
    pm = build_model(smoke_config(get_config(ARCH)))
    p = tree_init(pm.param_defs(), 0, device="cpu")
    A = p["blocks"]["A"]
    assert A.dtype == torch.float32 and p["blocks"]["dt_bias"].dtype == torch.float32
    assert p["blocks"]["w_x"].dtype == torch.bfloat16
    assert bool(((A <= -1.0) & (A >= -16.0)).all()) and float(A.std()) > 1.0
    g = torch.Generator().manual_seed(0)
    r = init_one(PD((2, 3, 4), ("layers", None, None), init="arange"), g, "cpu")
    want = np.asarray(j_tree_init({"r": JPD((2, 3, 4), ("layers", None, None),
                                           init="arange")}, 0)["r"], np.float32)
    np.testing.assert_array_equal(r.float().numpy(), want)
    assert r.is_contiguous()


def test_params_from_jax_keeps_the_f32_leaves():
    jm, pm, jp, pp = pair(ARCH, "bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    assert len(leaves) == len(jax.tree.leaves(pm.param_defs(),
                                              is_leaf=lambda x: hasattr(x, "axes")))
    for path, a in leaves:
        t = pp
        for k in path:
            t = t[k.key]
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), path
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_serve_bundles_carry_the_model_state():
    """build_serve_step: the decode bundle's cache_defs are the model's
    (``ssm``/``conv``), the prefill bundle returns the state tree."""
    from repro_torch.runtime import build_serve_step
    rc = RunConfig(model=smoke_config(get_config(ARCH)),
                   shape=ShapeConfig("d", 32, B, "decode"), comm=CommConfig(),
                   train=TrainConfig())
    dec = build_serve_step(rc, "decode", device="cpu")
    assert sorted(dec.cache_defs) == ["conv", "ssm"]
    assert dec.cache_defs == dec.model.cache_defs(B, 32)
    pre = build_serve_step(rc, "prefill", device="cpu")
    p = tree_init(pre.param_defs, 0, device="cpu")
    logits, st = pre.fn(p, {"tokens": torch.ones((B, 5), dtype=torch.long)})
    assert sorted(st) == ["conv", "ssm"] and tuple(logits.shape) == (B, 1, 256)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_serving_engine_refuses_state_models(arch):
    """The reference's engine lands ``pcache["k"]``/``["v"]`` and fails on
    these families at the first request (``KeyError``); the port's refuses
    them at construction, naming the family (ROADMAP.md §C 16)."""
    from repro.runtime.serving import ServingEngine as JServingEngine
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.runtime import ServingEngine
    jcfg = j_smoke_config(j_get_config(arch))
    jrc = JRunConfig(model=jcfg, shape=JShapeConfig("d", 32, B, "decode"),
                     comm=JCommConfig(), train=JTrainConfig())
    ref = JServingEngine(jrc, make_local_mesh())
    assert ref.submit(np.arange(1, 6), 2) is not None
    with pytest.raises(KeyError, match="'k'"):
        ref.run_to_completion()
    rc = RunConfig(model=smoke_config(get_config(arch)),
                   shape=ShapeConfig("d", 32, B, "decode"), comm=CommConfig(),
                   train=TrainConfig())
    family = get_config(arch).family
    with pytest.raises(ValueError, match=f"of the '{family}' family"):
        ServingEngine(rc, device="cpu")
    with pytest.raises(SystemExit, match="use --engine fixed"):
        serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--engine", "mono"])
