"""The port's dense transformer against the JAX package's, on the CPU.

Both packages take the JAX package's own parameter tree (``tree_init(defs,
0)``; the port through ``params_from_jax``) and the same numpy tokens.
Checked: prefill logits and KV cache, then decode logits teacher-forced for
4 steps with ``(B,)`` positions, two rows at different depths.

Tolerances, each with its reason:

* float32 parameters on both sides: 5e-3.  The arithmetic is f32, but the
  decode cache is bf16 on both sides (``cache_defs``), so cached k/v are
  rounded to bf16 (relative 2^-9) and the two packages may round a value
  that sits near a bf16 tie to different neighbours after f32 sums taken in
  different orders.
* bfloat16 parameters: 5e-2.  Every matmul output and activation is rounded
  to bf16 (relative 2^-9 per rounding) at places that differ between XLA and
  PyTorch, and the rounding compounds over 4 layers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models import build_model as jax_build_model
from repro.models.param import tree_init as jax_tree_init
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import smoke_config as pt_smoke_config
from repro_torch.models import build_model as pt_build_model
from repro_torch.models.param import params_from_jax, tree_init

TOL = {"float32": 5e-3, "bfloat16": 5e-2}
DECODE_STEPS = 4
# (arch, dtype, prompt lengths of two rows at different depths, cache length):
# llama3.2-3b is the served model; h2o-danube-3-4b's smoke window of 64 makes
# prefill keep the last 64 positions in ring order and decode write a ring
# buffer; qwen1.5-0.5b adds q/k/v biases.
CASES = [("llama3.2-3b", "float32", (12, 9), 32),
         ("llama3.2-3b", "bfloat16", (12, 9), 32),
         ("h2o-danube-3-4b", "float32", (80, 70), 96),
         ("qwen1.5-0.5b", "float32", (12, 9), 32)]


def _models(arch: str):
    jm = jax_build_model(smoke_config(get_config(arch)))
    pm = pt_build_model(pt_smoke_config(pt_get_config(arch)))
    return jm, pm, jax_tree_init(jm.param_defs(), 0)


@pytest.fixture(scope="module")
def models():
    return _models("llama3.2-3b")


def _params(jparams, dtype: str):
    jp = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jparams)
    np_tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(np_tree, "cpu")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _tokens(vocab: int, lens):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, vocab, size=n) for n in lens]
    forced = rng.integers(1, vocab, size=(len(lens), DECODE_STEPS))
    return prompts, forced


@pytest.mark.parametrize("arch,dtype,lens,max_len", CASES)
def test_prefill_and_decode_match_reference(arch, dtype, lens, max_len):
    jm, pm, jparams = _models(arch)
    jp, pp = _params(jparams, dtype)
    tol = TOL[dtype]
    prompts, forced = _tokens(jm.cfg.vocab_size, lens)
    B = len(prompts)

    jcache = jax_tree_init(jm.cache_defs(B, max_len), 0)
    pcache = tree_init(pm.cache_defs(B, max_len), 0, device="cpu")
    assert all(str(v.dtype) == "bfloat16" for v in jcache.values())
    assert all(v.dtype == torch.bfloat16 for v in pcache.values())
    with torch.inference_mode():
        for row, prompt in enumerate(prompts):
            jl, jkv = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None], jnp.int32)})
            pl, pkv = pm.prefill(pp, {"tokens": torch.as_tensor(prompt[None])})
            assert tuple(pl.shape) == tuple(jl.shape) == (1, 1, jm.cfg.vocab_size)
            np.testing.assert_allclose(_np(pl), _np(jl), atol=tol, rtol=tol)
            for n in ("k", "v"):
                assert tuple(pkv[n].shape) == tuple(jkv[n].shape)
                np.testing.assert_allclose(_np(pkv[n]), _np(jkv[n]),
                                           atol=tol, rtol=tol)
                W = pkv[n].shape[2]          # min(S, window): ring order
                jcache[n] = jcache[n].at[:, row, :W].set(
                    jkv[n][:, 0].astype(jcache[n].dtype))
                pcache[n][:, row, :W].copy_(pkv[n][:, 0])

        jstep = jax.jit(jm.decode_step)
        pos = np.array(lens)
        for i in range(DECODE_STEPS):
            tok = forced[:, i:i + 1]
            jl, jcache = jstep(jp, jcache, jnp.asarray(pos + i, jnp.int32),
                               jnp.asarray(tok, jnp.int32))
            pl, pcache = pm.decode_step(pp, pcache, torch.as_tensor(pos + i),
                                        torch.as_tensor(tok))
            np.testing.assert_allclose(_np(pl), _np(jl), atol=tol, rtol=tol,
                                       err_msg=f"decode step {i}")
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(pcache[n]), _np(jcache[n]),
                                       atol=tol, rtol=tol)


def test_scalar_pos_decode_equals_vector_pos(models):
    """A scalar position is the (B,) case with every row at one depth."""
    _, pm, jparams = models
    _, pp = _params(jparams, "float32")
    tok = torch.as_tensor([[3], [7]])
    outs = []
    with torch.inference_mode():
        for pos in (5, torch.as_tensor([5, 5])):
            cache = tree_init(pm.cache_defs(2, 16), 0, device="cpu")
            logits, cache = pm.decode_step(pp, cache, pos, tok)
            outs.append((logits, cache["k"].clone()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


def test_params_from_jax_keeps_names_layout_and_values(models):
    _, pm, jparams = models
    np_tree = jax.tree.map(np.asarray, jparams)
    pp = params_from_jax(np_tree, "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(np_tree)
    assert len(jleaves) == len(jax.tree.leaves(pm.param_defs(),
                                               is_leaf=lambda x: hasattr(x, "axes")))
    for path, a in jleaves:
        t = pp
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-780m",
                                  "whisper-medium", "pixtral-12b"])
def test_unported_families_raise_naming_the_roadmap(arch):
    cfg = pt_smoke_config(pt_get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model = pt_build_model(cfg)
        model.prefill(tree_init(model.param_defs(), 0, device="cpu"),
                      {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_tree_init_is_seeded_and_on_the_device(models):
    _, pm, _ = models
    a = tree_init(pm.param_defs(), 3, device="cpu")
    b = tree_init(pm.param_defs(), 3, device="cpu")
    c = tree_init(pm.param_defs(), 4, device="cpu")
    assert a["embed"].device.type == "cpu" and a["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["blocks"]["ln1"], torch.ones_like(a["blocks"]["ln1"]))


@pytest.mark.parametrize("pos_kind", ["scalar", "sequence", "per_row"])
def test_apply_rope_matches_reference(pos_kind):
    from repro.models import layers as JL
    from repro_torch.models import layers as PL
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = {"scalar": np.array(7), "sequence": np.arange(5) + 3,
           "per_row": np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])}[pos_kind]
    jpos = jnp.full((1,), int(pos)) if pos_kind == "scalar" else jnp.asarray(pos)
    want = JL.apply_rope(jnp.asarray(x), jpos, 500_000.0)
    got = PL.apply_rope(torch.from_numpy(x), torch.as_tensor(pos), 500_000.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_layers_attention_matches_reference(models):
    """The full-sequence attention layer (projections, RoPE, flash, wo),
    float32 parameters: sums in another order only, 1e-5."""
    from repro.models import layers as JL
    from repro_torch.models import layers as PL
    from repro_torch.models.transformer import layer_params
    jm, pm, jparams = models
    jp, pp = _params(jparams, "float32")
    jlp = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    plp = layer_params(pp["blocks"], 1)["attn"]
    x = np.random.default_rng(13).standard_normal((2, 9, jm.cfg.d_model)).astype(np.float32)
    want = JL.attention(jlp, jnp.asarray(x), jm.dims, positions=jnp.arange(9))
    got = PL.attention(plp, torch.from_numpy(x), pm.dims, positions=torch.arange(9))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
