"""The port's Zamba2-style hybrid (zamba2-1.2b) against the JAX package's, on
the CPU, at smoke size (4 layers, the shared attention+MLP block after every
2nd), and at 5 layers (2 sites and one trailing mamba layer, as zamba2-1.2b's
38 layers leave 2 after its 6 sites).

The checks and tolerances are ``tests/test_torch_ssm.py``'s (its helpers are
used here): f32 parameters for the whole model within 5e-3, bf16 one block at
a time within 5e-2, greedy tokens equal up to a near tie of the reference.
Also: the shared block is one copy in both trees, prefill's K/V have the
prompt's length, and decoding past it needs the landed ``max_len`` cache.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssm import (B, LENS, TOL, check_decode_steps,
                            check_logits_and_loss, check_prefill_matches_decode,
                            check_prefill_state, check_server_generate, close,
                            pair)

ARCH = "zamba2-1.2b"
DEPTHS = {"4-layers": None, "5-layers-trailing": 5}


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("S", LENS)
def test_logits_and_loss_match_reference(S, depth):
    check_logits_and_loss(ARCH, S, DEPTHS[depth])


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_state_match_reference(dtype, depth):
    check_prefill_state(ARCH, dtype, LENS[0], DEPTHS[depth])


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_decode_steps_match_reference(depth):
    check_decode_steps(ARCH, 20, 40, DEPTHS[depth])


def test_server_generate_matches_reference():
    check_server_generate(ARCH, 20, 40, DEPTHS["5-layers-trailing"])


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_prefill_matches_token_by_token_decode(depth):
    check_prefill_matches_decode(ARCH, DEPTHS[depth])


def test_sites_and_trailing_layers():
    """n_sites = num_layers // attn_every; the shared block after layers 1
    and 3 of 5 (``i % 2 == 1``), layer 4 trailing; the cache's K/V per site."""
    jm, pm, _, pp = pair(ARCH, "float32", 5)
    assert pm.n_sites == jm.n_sites == 2
    assert [i for i in range(5) if pm._is_site(i)] == [1, 3]
    defs = pm.cache_defs(B, 40)
    assert defs["shared_k"].shape == (2, B, 40, pm.cfg.num_kv_heads,
                                      pm.cfg.resolved_head_dim)
    assert defs["ssm"].shape[0] == defs["conv"].shape[0] == 5


def test_shared_block_is_one_copy():
    """The conversion carries the one weight-tied block as it is: unstacked,
    the same leaves and shapes as the reference's, nowhere repeated."""
    jm, pm, jp, pp = pair(ARCH, "bfloat16")
    jshared = jax.tree_util.tree_leaves_with_path(jp["shared"])
    assert len(jshared) == len(jax.tree.leaves(pm.param_defs()["shared"],
                                               is_leaf=lambda x: hasattr(x, "axes")))
    for path, a in jshared:
        t = pp["shared"]
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == a.shape and t.dim() <= 2
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    assert pp["head"].shape == (pm.cfg.d_model, pm.cfg.vocab_size)   # untied


def test_prefill_kv_has_the_prompt_length_and_lands_into_max_len():
    """Prefill's K/V are (sites, B, S, KH, Dh); decoding past S from them
    directly would write at the clamp S-1, so the caller lands them into
    the first S positions of a ``cache_defs(B, max_len)`` cache first (in
    f32 here, so that the decode matches prefill at the f32 bound)."""
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import land_prefill
    _, pm, _, pp = pair(ARCH, "float32")
    S, max_len = 6, 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, 256, (B, S + 3)))
    with torch.inference_mode():
        _, st = pm.prefill(pp, {"tokens": toks[:, :S]})
        assert st["shared_k"].shape[2] == S
        cache = {n: v.float() for n, v in
                 tree_init(pm.cache_defs(B, max_len), 0, device="cpu").items()}
        land_prefill(cache, st)
        assert torch.equal(cache["shared_k"][:, :, :S], st["shared_k"])
        assert not cache["shared_k"][:, :, S:].any()
        # three tokens past S: the landed cache against a full prefill
        for i in range(3):
            dl, cache = pm.decode_step(pp, cache, S + i, toks[:, S + i:S + i + 1])
        full, _ = pm.prefill(pp, {"tokens": toks})
    close(dl, full, TOL["float32"])
    with pytest.raises(ValueError, match="does not fit"):
        land_prefill(tree_init(pm.cache_defs(B, S - 1), 0, device="cpu"), st)


def test_shared_block_matches_reference_in_bf16():
    """The shared attention+MLP block (flash's plain version here) on the
    same bf16 input."""
    jm, pm, jp, pp = pair(ARCH, "bfloat16")
    x = np.random.default_rng(8).standard_normal((B, LENS[0], jm.cfg.d_model)) * 0.5
    got = pm._shared_apply(pp["shared"], torch.as_tensor(x).bfloat16(),
                           torch.arange(LENS[0]))
    want = jm._shared_apply(jp["shared"], jnp.asarray(x, jnp.bfloat16),
                            jnp.arange(LENS[0]))
    close(got, want, TOL["bfloat16"])
