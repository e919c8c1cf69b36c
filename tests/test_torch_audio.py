"""The port's encoder-decoder family (whisper-medium) against the JAX
package's, on the CPU, at smoke size (2 encoder and 4 decoder layers,
d_model 128, 4/4 heads of 32, 24 source frames, sinusoidal positions).

Both packages take the JAX package's own parameter tree (``tree_init(defs,
0)``; the port through ``params_from_jax``, leaf by leaf with its dtype) and
the same numpy tokens and stub inputs (``source_frames`` here, pixtral's
``patch_embeds`` in ``tests/test_torch_vlm.py``, which imports the helpers
from this file).  Checked: ``sinusoidal_positions``; cross-attention
(non-causal, Sq != Sk, Sk not a multiple of the kernel's 64-key tile, MHA
and GQA); the ``param_defs`` trees and ``params_from_jax``; ``loss`` and
``logits``; prefill's logits and every cache leaf (``xk``/``xv`` too); decode
steps from the landed cache with a scalar and with a (B,) ``pos``; prefill
against token-by-token decode within the port; ``Server.generate``'s tokens;
each block in bf16; the encoder's ``gather`` hook; the serving engine's
refusal and the launcher.

Tolerances, each with its reason:

* float32 parameters: 5e-3, as the dense model's tests
  (``tests/test_torch_model.py``) and the reference's own bound for
  prefill against decode (``tests/test_models_smoke.py``).  Both sides
  compute in f32; sums run in other orders; the decode cache is bf16 on
  both sides, so leaves stored in bf16 get one bf16 ulp on top
  (``tests/test_torch_ssm.py``'s ``close_leaf``).
* bfloat16 parameters: 5e-2, the dense model's bf16 bound, one block (an
  encoder block, a decoder block with its cross-attention) at a time on the
  same input: every product rounds to bf16 at places that differ between
  XLA and PyTorch.
* ``sinusoidal_positions``: 2e-4 absolute.  The angle is position × an f32
  frequency from ``exp``; at position 1500 one ulp of the angle is 1.2e-4,
  and the two libraries' ``exp`` may differ by an ulp.
* greedy tokens: equal up to the first step where the reference's top-1 /
  top-2 margin is within twice the f32 tolerance.
"""
from __future__ import annotations

import functools
import io
from contextlib import redirect_stdout
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
from repro.models import layers as JL
from repro.models.param import PD as JPD
from repro.models.param import tree_init as j_tree_init
from repro.runtime.serve_loop import Server as JServer
from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.models import batch_concrete, build_model
from repro_torch.models import layers as PL
from repro_torch.models.param import params_from_jax, state_from_jax, tree_init
from repro_torch.models.transformer import layer_params
from repro_torch.runtime import Server, ServingEngine, land_prefill
from test_torch_ssm import close, close_leaf

ARCH = "whisper-medium"
TOL = {"float32": 5e-3, "bfloat16": 5e-2}
SIN_ATOL = 2e-4
B = 2
S = 12                  # prompt tokens
MAX_LEN = 48            # decode cache
DECODE_STEPS = 6
GEN_TOKENS = 8


@functools.lru_cache(maxsize=None)
def pair(arch: str, dtype: str, **over):
    """(JAX model, port model, JAX params, port params) at smoke size, with
    config fields `over` replaced.  float32 casts every leaf; bfloat16 keeps
    the reference's tree as it is."""
    jcfg = replace(j_smoke_config(j_get_config(arch)), **over)
    pcfg = replace(smoke_config(get_config(arch)), **over)
    jm, pm = j_build_model(jcfg), build_model(pcfg)
    jp = j_tree_init(jm.param_defs(), 0)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jm, pm, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab: int, n: int, seed: int = 11, rows: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, vocab, size=(rows, n))


def stubs(cfg, seed: int = 3, rows: int = B) -> dict:
    """The family's stub inputs, f32 numpy (standard normal)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vision_tokens:
        out["patch_embeds"] = rng.standard_normal((rows, cfg.vision_tokens, cfg.d_model))
    if cfg.encoder_layers:
        out["source_frames"] = rng.standard_normal((rows, cfg.source_len, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def jbatch(toks: np.ndarray, st: dict, dtype: str = "float32") -> dict:
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return {"tokens": jnp.asarray(toks, jnp.int32),
            **{k: jnp.asarray(v, jdt) for k, v in st.items()}}


def pbatch(toks: np.ndarray, st: dict, dtype: str = "float32") -> dict:
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return {"tokens": torch.as_tensor(toks),
            **{k: torch.as_tensor(v).to(tdt) for k, v in st.items()}}


def n_prefix(cfg) -> int:
    return cfg.vision_tokens


def j_land_rows(jcache: dict, states: list) -> dict:
    """The reference's landing of per-row (B = 1) prefill states into rows
    of a decode cache."""
    out = dict(jcache)
    for row, st in enumerate(states):
        for n, leaf in st.items():
            idx = (slice(None), row) + tuple(slice(0, s) for s in leaf.shape[2:])
            out[n] = out[n].at[idx].set(leaf[:, 0].astype(out[n].dtype))
    return out


def p_land_rows(pcache: dict, states: list) -> dict:
    for row, st in enumerate(states):
        for n, leaf in st.items():
            idx = (slice(None), row) + tuple(slice(0, s) for s in leaf.shape[2:])
            pcache[n][idx].copy_(leaf[:, 0])
    return pcache


# -- checks shared with tests/test_torch_vlm.py --------------------------------

def check_param_defs(arch: str) -> None:
    """The same tree of parameter definitions: names, shapes, logical axes,
    inits, scales and dtypes; and ``params_from_jax`` carries every leaf with
    its dtype and values."""
    jm, pm, _, _ = pair(arch, "bfloat16")
    jdefs = jax.tree_util.tree_flatten_with_path(
        jm.param_defs(), is_leaf=lambda x: isinstance(x, JPD))[0]
    pdefs = pm.param_defs()
    assert len(jdefs) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda pd: 0, pdefs, is_leaf=lambda x: hasattr(x, "axes"))))
    jp = j_tree_init(jm.param_defs(), 0)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for path, jpd in jdefs:
        keys = [k.key for k in path]
        ppd, leaf, jleaf = pdefs, pp, jp
        for k in keys:
            ppd, leaf, jleaf = ppd[k], leaf[k], jleaf[k]
        where = "/".join(keys)
        assert (ppd.shape, ppd.axes, ppd.init, ppd.scale, ppd.dtype) == \
            (jpd.shape, jpd.axes, jpd.init, jpd.scale, jpd.dtype), where
        assert str(leaf.dtype).removeprefix("torch.") == str(jleaf.dtype), where
        assert tuple(leaf.shape) == jpd.shape, where
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(jleaf, np.float32), err_msg=where)
    # the port's own init draws the same tree, leaf by leaf with its dtype
    init = tree_init(pdefs, 0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), init) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), pp)


def check_logits_and_loss(arch: str) -> None:
    jm, pm, jp, pp = pair(arch, "float32")
    toks, st = tokens(jm.cfg.vocab_size, S + 1), stubs(jm.cfg)
    jl = jm.logits(jp, jbatch(toks[:, :S], st))
    pl = pm.logits(pp, pbatch(toks[:, :S], st))
    assert tuple(pl.shape) == tuple(jl.shape) == (B, S, jm.cfg.vocab_size)
    close(pl, jl, TOL["float32"], "logits")
    jloss, jmet = jm.loss(jp, jbatch(toks, st))
    ploss, pmet = pm.loss(pp, pbatch(toks, st))
    close(ploss, jloss, TOL["float32"], "loss")
    # the patch positions carry no loss
    assert float(pmet["tokens"]) == float(jmet["tokens"]) == B * S


def check_prefill_cache(arch: str, dtype: str) -> None:
    """Prefill's logits (in bf16 too: at smoke depth the whole model stays
    within the bf16 bound) and every cache leaf: names, shapes, dtypes;
    the leaves' values in f32."""
    jm, pm, jp, pp = pair(arch, dtype)
    toks, st = tokens(jm.cfg.vocab_size, S), stubs(jm.cfg)
    jl, jst = jm.prefill(jp, jbatch(toks, st, dtype))
    with torch.inference_mode():
        pl, pst = pm.prefill(pp, pbatch(toks, st, dtype))
    assert tuple(pl.shape) == tuple(jl.shape) == (B, 1, jm.cfg.vocab_size)
    assert pl.dtype == torch.float32
    assert sorted(pst) == sorted(jst)
    for n in jst:
        assert tuple(pst[n].shape) == tuple(jst[n].shape), n
        assert str(pst[n].dtype).removeprefix("torch.") == str(jst[n].dtype), n
    assert pst["k"].shape[2] == n_prefix(jm.cfg) + S
    close(pl, jl, TOL[dtype], "prefill logits")
    if dtype == "float32":
        for n in jst:
            close_leaf(pst[n], jst[n], n)


def check_decode_steps(arch: str, vector: bool) -> None:
    """Each row prefilled alone (its own stub inputs; with a (B,) `pos` the
    rows' prompts have different lengths), landed into its row of a
    ``cache_defs(B, MAX_LEN)`` cache, then DECODE_STEPS teacher-forced
    decode steps: logits at every step, the cache after the last."""
    jm, pm, jp, pp = pair(arch, "float32")
    cfg = jm.cfg
    lens = (S, S - 3) if vector else (S, S)
    toks = tokens(cfg.vocab_size, S + DECODE_STEPS)
    st = stubs(cfg)
    jstates, pstates = [], []
    with torch.inference_mode():
        for row, n in enumerate(lens):
            r = {k: v[row:row + 1] for k, v in st.items()}
            jstates.append(jm.prefill(jp, jbatch(toks[row:row + 1, :n], r))[1])
            pstates.append(pm.prefill(pp, pbatch(toks[row:row + 1, :n], r))[1])
    jcache = j_land_rows(j_tree_init(jm.cache_defs(B, MAX_LEN), 0), jstates)
    pcache = p_land_rows(tree_init(pm.cache_defs(B, MAX_LEN), 0, device="cpu"), pstates)
    dtypes = {n: v.dtype for n, v in pcache.items()}
    assert {n: str(v.dtype) for n, v in jcache.items()} == \
        {n: str(d).removeprefix("torch.") for n, d in dtypes.items()}
    jstep = jax.jit(jm.decode_step)
    base = np.asarray(lens) + n_prefix(cfg)
    with torch.inference_mode():
        for i in range(DECODE_STEPS):
            tok = np.stack([toks[r, lens[r] + i:lens[r] + i + 1] for r in range(B)])
            if vector:
                jpos, ppos = jnp.asarray(base + i, jnp.int32), torch.as_tensor(base + i)
            else:
                jpos, ppos = jnp.int32(base[0] + i), int(base[0] + i)
            jl, jcache = jstep(jp, jcache, jpos, jnp.asarray(tok, jnp.int32))
            pl, pcache = pm.decode_step(pp, pcache, ppos, torch.as_tensor(tok))
            close(pl, jl, TOL["float32"], f"decode step {i}")
    assert {n: v.dtype for n, v in pcache.items()} == dtypes
    for n in jcache:
        close_leaf(pcache[n], jcache[n], n)


def check_server_generate(arch: str) -> None:
    """Prefill, land, then each package's ``Server.generate`` decodes
    GEN_TOKENS greedily from the prefill's argmax at position
    n_prefix + S."""
    jm, pm, jp, pp = pair(arch, "float32")
    cfg = jm.cfg
    toks, st = tokens(cfg.vocab_size, S, seed=5), stubs(cfg, seed=6)
    pos = n_prefix(cfg) + S
    jl, jst = jm.prefill(jp, jbatch(toks, st))
    first = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    jrc = JRunConfig(model=cfg, shape=JShapeConfig("d", MAX_LEN, B, "decode"),
                     comm=JCommConfig(), train=JTrainConfig())
    rc = RunConfig(model=pm.cfg, shape=ShapeConfig("d", MAX_LEN, B, "decode"),
                   comm=CommConfig(), train=TrainConfig())
    jserver = JServer(jrc, make_local_mesh(), params=jp)
    jcache = jserver.init_cache()
    for n, leaf in jst.items():
        idx = tuple(slice(0, s) for s in leaf.shape)
        jcache[n] = jcache[n].at[idx].set(leaf.astype(jcache[n].dtype))
    ref = jserver.generate(first, max_new=GEN_TOKENS, prefill_pos=pos, cache=jcache)
    server = Server(rc, params=pp, device="cpu")
    with torch.inference_mode():
        pl, pst = server.bundle.model.prefill(pp, pbatch(toks, st))
        assert np.array_equal(torch.argmax(pl[:, -1], dim=-1).numpy()[:, None], first)
        cache = land_prefill(server.init_cache(), pst)
    got = server.generate(first, max_new=GEN_TOKENS, prefill_pos=pos, cache=cache)
    assert got.tokens.shape == ref.tokens.shape == (B, GEN_TOKENS)
    # the reference's own margins along its greedy path
    jstep = jax.jit(jm.decode_step)
    jc = j_land_rows(j_tree_init(jm.cache_defs(B, MAX_LEN), 0),
                     [{n: v[:, r:r + 1] for n, v in jst.items()} for r in range(B)])
    tok, margins = jnp.asarray(first, jnp.int32), []
    for t in range(GEN_TOKENS):
        logits, jc = jstep(jp, jc, jnp.int32(pos + t), tok)
        top = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)
        margins.append(top[:, -1] - top[:, -2])
        tok = jnp.asarray(ref.tokens[:, t:t + 1], jnp.int32)
    margins = np.stack(margins, axis=1)
    for row in range(B):
        diff = np.flatnonzero(got.tokens[row] != ref.tokens[row])
        if diff.size:
            t = int(diff[0])
            assert margins[row, t] <= 2 * TOL["float32"], (row, t, margins[row, t])


def check_block_bf16(arch: str) -> None:
    """One decoder block (with its cross-attention for the audio family) on
    the same bf16 input, and for the audio family the encoder: within the
    bf16 bound."""
    over = {"encoder_layers": 1} if j_get_config(arch).encoder_layers else {}
    jm, pm, jp, pp = pair(arch, "bfloat16", **over)
    cfg = jm.cfg
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, 10, cfg.d_model)).astype(np.float32)
    jx, px = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)
    jenc = penc = None
    if cfg.encoder_layers:
        toks, st = tokens(cfg.vocab_size, 4), stubs(cfg)
        jenc = jm._encode(jp, jbatch(toks, st, "bfloat16"), None)
        penc = pm._encode(pp, pbatch(toks, st, "bfloat16"))
        assert penc.dtype == torch.bfloat16
        close(penc, jenc, TOL["bfloat16"], "encoder (1 layer)")
    jlp = jax.tree.map(lambda a: a[1], jp["blocks"])
    plp = layer_params(pp["blocks"], 1)
    jy, _ = jm._block(jlp, jx, jnp.arange(10), jenc)
    with torch.inference_mode():
        py, _ = pm._block(plp, px, torch.arange(10), penc)
    assert py.dtype == torch.bfloat16
    close(py, jy, TOL["bfloat16"], "decoder block")


def check_prefill_matches_decode(arch: str, k: int) -> None:
    """Within the port, in f32 with an f32 cache: the last logits of one
    prefill of the whole input equal those of a prefill of all but the last
    `k` prompt tokens (every stub input included) followed by `k`
    ``decode_step``s (the reference's own check, at its bound); k = S
    decodes every token from an empty cache, with the encoder's ``xk``/``xv``
    taken from the prefill, as ``tests/test_models_smoke.py`` does."""
    _, pm, _, pp = pair(arch, "float32")
    cfg = pm.cfg
    toks = torch.as_tensor(tokens(cfg.vocab_size, S)[:1])
    st = {n: torch.as_tensor(v) for n, v in stubs(cfg, rows=1).items()}
    head = S - k
    with torch.inference_mode():
        pl, full = pm.prefill(pp, {"tokens": toks, **st})
        cache = {n: v.float() for n, v in
                 tree_init(pm.cache_defs(1, n_prefix(cfg) + S), 0, device="cpu").items()}
        if head:
            land_prefill(cache, pm.prefill(pp, {"tokens": toks[:, :head], **st})[1])
        elif "xk" in cache:
            cache["xk"].copy_(full["xk"])
            cache["xv"].copy_(full["xv"])
        for i in range(head, S):
            dl, cache = pm.decode_step(pp, cache, n_prefix(cfg) + i, toks[:, i:i + 1])
    close(pl[:, -1], dl[:, -1], TOL["float32"])
    assert int(pl[0, -1].argmax()) == int(dl[0, -1].argmax())


def check_launcher(arch: str) -> None:
    """``launch.serve --engine fixed --smoke --device cpu`` runs; the
    serving tier's engines exit naming the family."""
    from repro_torch.launch import serve
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--tokens", "3",
                    "--batch", "2", "--cache-len", "32"])
    out = buf.getvalue()
    assert f"[serve] {arch} B=2 cache=32 generated 3 tokens" in out, out
    family = get_config(arch).family
    for engine in ("mono", "disagg"):
        with pytest.raises(SystemExit, match=f"'{family}' family"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--engine", engine])


# -- whisper-medium -----------------------------------------------------------

@pytest.mark.parametrize("d", [128, 1024, 7])
def test_sinusoidal_positions_match_reference(d):
    pos = np.array([0, 1, 2, 17, 255, 448, 1499])
    want = JL.sinusoidal_positions(jnp.asarray(pos), d)
    got = PL.sinusoidal_positions(torch.as_tensor(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SIN_ATOL, rtol=0)


# (arch for the dims, Sq, Sk): whisper's MHA and pixtral's GQA (4 over 1) with
# RoPE on q and on the keys' own positions; Sk 100 and 65 leave a ragged last
# 64-key tile, Sk 24 is whisper's smoke source, Sq < Sk and Sq > Sk
CROSS = [("whisper-medium", 9, 100), ("whisper-medium", 70, 65),
         ("whisper-medium", 12, 24), ("pixtral-12b", 9, 100), ("pixtral-12b", 3, 65)]


@pytest.mark.parametrize("arch,Sq,Sk", CROSS)
def test_cross_attention_matches_reference(arch, Sq, Sk):
    """``attention(kv_x=...)``: k/v from kv_x, no bias, not causal; against
    the reference's CPU path, f32, sums in another order only: 1e-5."""
    jm, pm, jp, pp = pair(arch, "float32")
    key = "xattn" if "xattn" in jp["blocks"] else "attn"
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"][key])
    plp = layer_params(pp["blocks"], 0)[key]
    rng = np.random.default_rng(Sq * 1000 + Sk)
    x = rng.standard_normal((B, Sq, jm.cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((B, Sk, jm.cfg.d_model)).astype(np.float32)
    kw_j = dict(kv_x=jnp.asarray(kv))
    kw_p = dict(kv_x=torch.as_tensor(kv))
    if jm.cfg.rope_theta:
        kw_j.update(positions=jnp.arange(Sq) + 5, kv_positions=jnp.arange(Sk))
        kw_p.update(positions=torch.arange(Sq) + 5, kv_positions=torch.arange(Sk))
    want = JL.attention(jlp, jnp.asarray(x), jm.dims, **kw_j)
    got = PL.attention(plp, torch.as_tensor(x), pm.dims, **kw_p)
    assert tuple(got.shape) == (B, Sq, jm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_param_defs_and_params_from_jax():
    check_param_defs(ARCH)
    _, pm, _, _ = pair(ARCH, "bfloat16")
    defs = pm.param_defs()
    assert sorted(defs["encoder"]) == ["attn", "ffn", "ln1", "ln2", "ln_f"]
    assert {"xattn", "lnx"} <= set(defs["blocks"]) and "head" not in defs


def test_state_from_jax_carries_the_encoder():
    """The train state's parameters and moments keep the encoder and
    cross-attention leaves with their dtypes; the step is a 0-d int32."""
    _, _, jp, _ = pair(ARCH, "bfloat16")
    np_p = jax.tree.map(np.asarray, jp)
    st = state_from_jax({"params": np_p, "opt": {"m": np_p, "v": np_p, "step": 3}}, "cpu")
    for part in (st["params"], st["opt"]["m"], st["opt"]["v"]):
        assert part["encoder"]["attn"]["wq"].dtype == torch.bfloat16
        assert tuple(part["blocks"]["xattn"]["wk"].shape) == jp["blocks"]["xattn"]["wk"].shape
        assert part["blocks"]["lnx"].dtype == torch.bfloat16
    assert st["opt"]["step"].dtype == torch.int32 and int(st["opt"]["step"]) == 3


def test_logits_and_loss_match_reference():
    check_logits_and_loss(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(dtype):
    check_prefill_cache(ARCH, dtype)


@pytest.mark.parametrize("pos", ["scalar", "vector"])
def test_decode_steps_match_reference(pos):
    check_decode_steps(ARCH, pos == "vector")


def test_scalar_pos_decode_equals_vector_pos():
    """The sinusoidal position of a scalar `pos` broadcast over the batch
    equals a (B,) vector with every row at that depth."""
    _, pm, _, pp = pair(ARCH, "float32")
    tok = torch.as_tensor([[3], [7]])
    outs = []
    with torch.inference_mode():
        for pos in (5, torch.as_tensor([5, 5])):
            cache = tree_init(pm.cache_defs(2, 16), 0, device="cpu")
            cache["xk"].normal_(generator=torch.Generator().manual_seed(1))
            cache["xv"].normal_(generator=torch.Generator().manual_seed(2))
            logits, cache = pm.decode_step(pp, cache, pos, tok)
            outs.append((logits, cache["k"].clone()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


def test_prefill_matches_token_by_token_decode():
    check_prefill_matches_decode(ARCH, S)


def test_server_generate_matches_reference():
    check_server_generate(ARCH)


def test_blocks_match_reference_in_bf16():
    check_block_bf16(ARCH)


def test_encoder_gathers_each_layer_inside_the_stack():
    """The ``gather`` hook maps every encoder and decoder layer's stored
    parameters, once a layer, and leaves the result unchanged (identity)."""
    jm, pm, _, pp = pair(ARCH, "float32")
    seen = []

    def gather(lp):
        seen.append(sorted(lp))
        return lp
    toks, st = tokens(pm.cfg.vocab_size, S + 1), stubs(pm.cfg)
    a, _ = pm.loss(pp, pbatch(toks, st))
    b, _ = pm.loss(pp, pbatch(toks, st), gather=gather)
    assert torch.equal(a, b)
    enc = [s for s in seen if "xattn" not in s]
    assert len(enc) == pm.cfg.encoder_layers and len(seen) - len(enc) == pm.cfg.num_layers


def test_encoder_checkpoints_only_under_autograd(monkeypatch):
    """With ``remat`` (the published configs) each encoder layer runs under
    ``torch.utils.checkpoint`` where autograd records, and directly in
    inference (prefill): the same outputs either way."""
    from repro_torch.models import transformer as T
    _, pm, _, pp = pair(ARCH, "float32", remat=True)
    calls = []
    real = T.checkpoint

    def counting(*a, **k):
        calls.append(a[0].__name__)
        return real(*a, **k)
    monkeypatch.setattr(T, "checkpoint", counting)
    batch = pbatch(tokens(pm.cfg.vocab_size, S), stubs(pm.cfg))
    with torch.inference_mode():
        inf = pm._encode(pp, batch)
    assert calls == []
    out = pm._encode(pp, batch)
    assert calls == ["_encoder_block"] * pm.cfg.encoder_layers
    torch.testing.assert_close(out, inf, rtol=0, atol=0)


def test_batch_concrete_is_seeded_with_the_family_inputs():
    cfg = smoke_config(get_config(ARCH))
    a = batch_concrete(cfg, "prefill", 2, 8, seed=1, device="cpu")
    b = batch_concrete(cfg, "prefill", 2, 8, seed=1, device="cpu")
    assert sorted(a) == ["source_frames", "tokens"]
    assert tuple(a["source_frames"].shape) == (2, cfg.source_len, cfg.d_model)
    assert a["source_frames"].dtype == torch.bfloat16
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tuple(batch_concrete(cfg, "train", 2, 8, device="cpu")["tokens"].shape) == (2, 9)
    assert sorted(batch_concrete(cfg, "decode", 2, 1, device="cpu")) == ["tokens"]
    _, pm, _, pp = pair(ARCH, "bfloat16")
    logits = pm.logits(pp, a)
    assert tuple(logits.shape) == (2, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_serving_engine_refuses_encoder_models_as_the_reference():
    """The reference's engine is decoder-only; so is the port's."""
    from repro.runtime.serving import ServingEngine as JServingEngine
    jm, pm, jp, pp = pair(ARCH, "float32")
    shape = ("d", 64, 2, "decode")
    jrc = JRunConfig(model=jm.cfg, shape=JShapeConfig(*shape), comm=JCommConfig(),
                     train=JTrainConfig())
    rc = RunConfig(model=pm.cfg, shape=ShapeConfig(*shape), comm=CommConfig(),
                   train=TrainConfig())
    with pytest.raises(ValueError, match="decoder-only"):
        JServingEngine(jrc, make_local_mesh(), params=jp)
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(rc, params=pp, device="cpu")


def test_launcher_serves_fixed_and_refuses_the_engines():
    check_launcher(ARCH)


def test_cache_defs_hold_the_source_cross_kv():
    _, pm, _, _ = pair(ARCH, "float32")
    defs = pm.cache_defs(3, 40)
    c = pm.cfg
    assert sorted(defs) == ["k", "v", "xk", "xv"]
    assert defs["xk"].shape == (c.num_layers, 3, c.source_len, c.num_kv_heads,
                                c.resolved_head_dim) == defs["xv"].shape
    assert defs["k"].shape[2] == 40
