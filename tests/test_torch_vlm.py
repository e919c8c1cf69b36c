"""The port's vision-prefix family (pixtral-12b) against the JAX package's,
on the CPU, at smoke size (4 layers, d_model 128, 4 query heads over 1 kv
head of 32, 16 patch embeddings before the tokens, an untied head).

The checks and tolerances are ``tests/test_torch_audio.py``'s (whose
helpers are used), with the patch prefix in place of the encoder: its
positions take RoPE positions and prefill K/V, decode starts after it, and
``loss``/``logits`` drop it.  Prefill against decode runs a prefill of the
prefix and all but the last 4 prompt tokens (decode takes no patches).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import CommConfig as JCommConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.launch.mesh import make_local_mesh
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.models import batch_concrete
from repro_torch.runtime import ServingEngine
from test_serving import _requests
from test_torch_audio import (B, S, check_block_bf16, check_decode_steps,
                              check_launcher, check_logits_and_loss,
                              check_param_defs, check_prefill_cache,
                              check_prefill_matches_decode,
                              check_server_generate, pair, pbatch, stubs,
                              tokens)

ARCH = "pixtral-12b"


def test_param_defs_and_params_from_jax():
    check_param_defs(ARCH)
    _, pm, _, _ = pair(ARCH, "bfloat16")
    defs = pm.param_defs()
    assert "head" in defs and "encoder" not in defs and "xattn" not in defs["blocks"]


def test_logits_and_loss_match_reference():
    check_logits_and_loss(ARCH)


def test_logits_drop_the_prefix_and_attend_to_it():
    """Logits are the tokens' positions only, and every one of them sees the
    patches (a causal prefix): new patches move every token's logits."""
    _, pm, _, pp = pair(ARCH, "float32")
    toks = tokens(pm.cfg.vocab_size, S)
    a = pm.logits(pp, pbatch(toks, stubs(pm.cfg, seed=3)))
    b = pm.logits(pp, pbatch(toks, stubs(pm.cfg, seed=4)))
    assert tuple(a.shape) == (B, S, pm.cfg.vocab_size)
    assert bool((a - b).abs().amax(dim=-1).gt(1e-4).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(dtype):
    check_prefill_cache(ARCH, dtype)


@pytest.mark.parametrize("pos", ["scalar", "vector"])
def test_decode_steps_match_reference(pos):
    check_decode_steps(ARCH, pos == "vector")


def test_prefill_matches_decode_after_the_prefix():
    check_prefill_matches_decode(ARCH, 4)


def test_server_generate_matches_reference():
    check_server_generate(ARCH)


def test_block_matches_reference_in_bf16():
    check_block_bf16(ARCH)


def test_batch_concrete_is_seeded_with_the_family_inputs():
    cfg = smoke_config(get_config(ARCH))
    a = batch_concrete(cfg, "prefill", 2, 8, seed=1, device="cpu")
    b = batch_concrete(cfg, "prefill", 2, 8, seed=2, device="cpu")
    assert sorted(a) == ["patch_embeds", "tokens"]
    assert tuple(a["patch_embeds"].shape) == (2, cfg.vision_tokens, cfg.d_model)
    assert a["patch_embeds"].dtype == torch.bfloat16
    assert not torch.equal(a["patch_embeds"], b["patch_embeds"])


def test_serving_engine_refuses_the_vlm_family():
    """The reference's engine prefills ``{"tokens"}`` alone and fails on the
    missing patch embeddings; the port's refuses the family at construction
    (ROADMAP.md §C 18)."""
    jm, pm, jp, pp = pair(ARCH, "float32")
    shape = ("d", 64, 2, "decode")
    jrc = JRunConfig(model=jm.cfg, shape=JShapeConfig(*shape), comm=JCommConfig(),
                     train=JTrainConfig())
    rc = RunConfig(model=pm.cfg, shape=ShapeConfig(*shape), comm=CommConfig(),
                   train=TrainConfig())
    ref = JServingEngine(jrc, make_local_mesh(), params=jp)
    prompt, mnew = _requests(jm.cfg)[0]
    assert ref.submit(prompt, mnew) is not None
    with pytest.raises(KeyError, match="patch_embeds"):
        ref.run_to_completion()
    with pytest.raises(ValueError, match="'vlm' family"):
        ServingEngine(rc, params=pp, device="cpu")


def test_launcher_serves_fixed_and_refuses_the_engines():
    check_launcher(ARCH)
