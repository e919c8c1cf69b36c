"""Zamba2-style hybrid: a Mamba2 backbone with one weight-shared
attention+MLP block applied after every `attn_every`-th mamba block.

The shared block's parameters are one copy (not stacked); the layer loop
applies it after layer i when ``i % attn_every == attn_every - 1``.  Its KV
caches are per site (the block re-reads different depths), stacked on a
leading sites dim.  ``num_layers % attn_every`` trailing mamba layers follow
the last site (zamba2-1.2b: 38 layers, 6 sites, 2 trailing).  Prefill's
shared attention is the flash kernel on the card; the head is untied.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.param import PD
from repro_torch.models.transformer import layer_params, unstack_layers


class HybridLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dims = L.AttnDims(
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
            window=None,
        )
        self.n_sites = cfg.num_layers // cfg.attn_every

    def param_defs(self) -> dict:
        c = self.cfg
        d, f = c.d_model, c.d_ff
        Dh = c.resolved_head_dim
        nq, nkv = c.num_heads * Dh, c.num_kv_heads * Dh
        shared = {
            "attn": {
                "wq": PD((d, nq), ("d_model", "heads")),
                "wk": PD((d, nkv), ("d_model", "kv_heads")),
                "wv": PD((d, nkv), ("d_model", "kv_heads")),
                "wo": PD((nq, d), ("heads", "d_model"), scale=nq ** -0.5),
            },
            "ffn": {
                "gate": PD((d, f), ("d_model", "ff")),
                "up": PD((d, f), ("d_model", "ff")),
                "down": PD((f, d), ("ff", "d_model"), scale=f ** -0.5),
            },
            "ln1": PD((d,), ("d_model",), init="ones"),
            "ln2": PD((d,), ("d_model",), init="ones"),
        }
        return {
            "blocks": M.mamba_block_defs(c, c.num_layers),
            "shared": shared,
            "embed": PD((c.vocab_size, d), ("vocab", "d_model"), scale=0.02),
            "head": PD((d, c.vocab_size), ("d_model", "vocab")),
            "ln_f": PD((d,), ("d_model",), init="ones"),
        }

    def _is_site(self, i: int) -> bool:
        return i % self.cfg.attn_every == self.cfg.attn_every - 1

    def _shared_apply(self, sp: dict, x: torch.Tensor, positions) -> torch.Tensor:
        c = self.cfg
        h = L.rms_norm(x, sp["ln1"], c.norm_eps)
        x = x + L.attention(sp["attn"], h, self.dims, positions=positions)
        h = L.rms_norm(x, sp["ln2"], c.norm_eps)
        return x + L.swiglu(sp["ffn"], h)

    def _body(self, lp, x, i: int, sp, positions, gather):
        x = M.mamba_forward(gather(lp) if gather is not None else lp, x, self.cfg)
        return self._shared_apply(sp, x, positions) if self._is_site(i) else x

    def hidden_states(self, params, batch, *, gather=None):
        """Full-sequence forward to the final-norm hidden states: (x, aux 0,
        no prefix), as the JAX package's."""
        c = self.cfg
        x = params["embed"][batch["tokens"]]
        positions = torch.arange(x.shape[1], device=x.device)
        sp = params["shared"]
        for i, lp in enumerate(unstack_layers(params["blocks"], c.num_layers)):
            if c.remat:
                x = checkpoint(self._body, lp, x, i, sp, positions, gather,
                               use_reentrant=False)
            else:
                x = self._body(lp, x, i, sp, positions, gather)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return x, torch.zeros((), dtype=torch.float32, device=x.device), 0

    def loss(self, params, batch, *, gather=None):
        tokens = batch["tokens"]
        x, aux, _ = self.hidden_states(params, {**batch, "tokens": tokens[:, :-1]},
                                       gather=gather)
        sum_loss, count = L.chunked_ce_loss(x, params["head"], tokens[:, 1:])
        loss = sum_loss / torch.clamp(count, min=1.0)
        return loss, {"ce_loss": loss, "aux_loss": aux, "tokens": count}

    def logits(self, params, batch, *, gather=None):
        x, _, _ = self.hidden_states(params, batch, gather=gather)
        return (x @ params["head"]).float()

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def cache_defs(self, batch_size: int, max_len: int) -> dict:
        c = self.cfg
        Dh = c.resolved_head_dim
        defs = M.mamba_state_defs(c, c.num_layers, batch_size)
        kv = ("sites", "batch", "seq", "kv_heads", None)
        defs["shared_k"] = PD((self.n_sites, batch_size, max_len, c.num_kv_heads, Dh),
                              kv, init="zeros")
        defs["shared_v"] = PD((self.n_sites, batch_size, max_len, c.num_kv_heads, Dh),
                              kv, init="zeros")
        return defs

    def _shared_decode(self, sp: dict, x: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos) -> torch.Tensor:
        """The shared block on one token (B, 1, d) against one site's K/V
        cache (B, W, KH, Dh), the new k/v written in place."""
        c = self.cfg
        h = L.rms_norm(x, sp["ln1"], c.norm_eps)
        a, _, _ = L.decode_attention(sp["attn"], h, self.dims, k_cache=k_cache,
                                     v_cache=v_cache, pos=pos, ring=False)
        x = x + a
        h = L.rms_norm(x, sp["ln2"], c.norm_eps)
        return x + L.swiglu(sp["ffn"], h)

    def decode_step(self, params, cache, pos, tokens):
        """One-token decode. tokens: (B, 1); pos: an int or a (B,) tensor (the
        shared block's cache depth).  Writes the new mamba states and the
        sites' new k/v into `cache` in place; returns (logits (B, 1, V) f32,
        cache)."""
        c = self.cfg
        x = params["embed"][tokens]
        sp = params["shared"]
        site = 0
        for i in range(c.num_layers):
            x, new = M.mamba_decode(layer_params(params["blocks"], i),
                                    {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                                    x, c)
            cache["ssm"][i].copy_(new["ssm"])
            cache["conv"][i].copy_(new["conv"])
            if self._is_site(i):
                x = self._shared_decode(sp, x, cache["shared_k"][site],
                                        cache["shared_v"][site], pos)
                site += 1
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return (x @ params["head"]).float(), cache

    def prefill(self, params, batch):
        """Full-prompt pass producing the mamba states and the sites' K/V.
        Returns (logits (B, 1, V) f32, {"ssm", "conv": per layer, as
        :meth:`MambaLM.prefill`'s; "shared_k", "shared_v": (sites, B, S, KH,
        Dh), the prompt's length, not a cache's})."""
        c = self.cfg
        x = params["embed"][batch["tokens"]]
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        sp = params["shared"]
        ssm, conv, ks, vs = [], [], [], []
        for i in range(c.num_layers):
            x, st = M.mamba_forward(layer_params(params["blocks"], i), x, c,
                                    with_state=True)
            ssm.append(st["ssm"])
            conv.append(st["conv"])
            if self._is_site(i):
                h = L.rms_norm(x, sp["ln1"], c.norm_eps)
                q, k, v = L._project_qkv(sp["attn"], h, self.dims, positions)
                o = ops.flash_attention(q, k, v, causal=True)
                x = x + o.reshape(B, S, -1) @ sp["attn"]["wo"]
                h = L.rms_norm(x, sp["ln2"], c.norm_eps)
                x = x + L.swiglu(sp["ffn"], h)
                ks.append(k)
                vs.append(v)
        x = L.rms_norm(x[:, -1:], params["ln_f"], c.norm_eps)
        logits = (x @ params["head"]).float()
        return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                        "shared_k": torch.stack(ks), "shared_v": torch.stack(vs)}
