"""Decoder-only transformer LM, dense family, forward only (prefill and
cached decode).

Parameters keep the JAX package's stacked ``(layers, ...)`` layout and names;
the layers are a Python loop over that stack (the JAX package scans it).
The MoE, vision-stub and encoder-decoder branches of the JAX model are not
ported yet and raise :class:`NotImplementedError` naming the ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.param import PD

QUEUED = "ROADMAP.md queue A, 'the other model families'"


def _queued(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet ({QUEUED})")


def layer_params(blocks: dict, i: int) -> dict:
    """Layer `i`'s parameters: views into the stacked tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


class Transformer:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dims = L.AttnDims(
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
            window=cfg.sliding_window,
        )

    # ------------------------------------------------------------------
    # parameter definitions
    # ------------------------------------------------------------------

    def _attn_defs(self, n_layers: int) -> dict:
        c = self.cfg
        Dh = c.resolved_head_dim
        nq, nkv = c.num_heads * Dh, c.num_kv_heads * Dh
        d = c.d_model
        defs = {
            "wq": PD((n_layers, d, nq), ("layers", "d_model", "heads")),
            "wk": PD((n_layers, d, nkv), ("layers", "d_model", "kv_heads")),
            "wv": PD((n_layers, d, nkv), ("layers", "d_model", "kv_heads")),
            "wo": PD((n_layers, nq, d), ("layers", "heads", "d_model"),
                     scale=(nq ** -0.5) / (2 * c.num_layers) ** 0.5),
        }
        if c.qkv_bias:
            defs["bq"] = PD((n_layers, nq), ("layers", "heads"), init="zeros")
            defs["bk"] = PD((n_layers, nkv), ("layers", "kv_heads"), init="zeros")
            defs["bv"] = PD((n_layers, nkv), ("layers", "kv_heads"), init="zeros")
        return defs

    def _ffn_defs(self, n_layers: int) -> dict:
        c = self.cfg
        d, f = c.d_model, c.d_ff
        if c.moe is not None:
            raise _queued(f"the MoE FFN of {c.name!r}")
        return {
            "gate": PD((n_layers, d, f), ("layers", "d_model", "ff")),
            "up": PD((n_layers, d, f), ("layers", "d_model", "ff")),
            "down": PD((n_layers, f, d), ("layers", "ff", "d_model"),
                       scale=(f ** -0.5) / (2 * c.num_layers) ** 0.5),
        }

    def param_defs(self) -> dict:
        c = self.cfg
        if c.encoder_layers:
            raise _queued(f"the encoder of {c.name!r}")
        d, V, nL = c.d_model, c.vocab_size, c.num_layers
        blocks = {
            "attn": self._attn_defs(nL),
            "ffn": self._ffn_defs(nL),
            "ln1": PD((nL, d), ("layers", "d_model"), init="ones"),
            "ln2": PD((nL, d), ("layers", "d_model"), init="ones"),
        }
        defs = {
            "blocks": blocks,
            "embed": PD((V, d), ("vocab", "d_model"), scale=0.02),
            "ln_f": PD((d,), ("d_model",), init="ones"),
        }
        if not c.tie_embeddings:
            defs["head"] = PD((d, V), ("d_model", "vocab"))
        return defs

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def _check_dense(self) -> None:
        c = self.cfg
        if c.moe is not None:
            raise _queued(f"the MoE FFN of {c.name!r}")
        if c.encoder_layers:
            raise _queued(f"the encoder of {c.name!r}")
        if c.vision_tokens:
            raise _queued(f"the vision-stub inputs of {c.name!r}")
        if not c.rope_theta:
            raise _queued(f"the sinusoidal positions of {c.name!r}")

    def _head(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def cache_width(self, max_len: int) -> int:
        c = self.cfg
        if c.sliding_window is not None:
            return min(max_len, c.sliding_window)
        return max_len

    def cache_defs(self, batch_size: int, max_len: int) -> dict:
        c = self.cfg
        if c.encoder_layers:
            raise _queued(f"the cross-attention cache of {c.name!r}")
        Dh = c.resolved_head_dim
        W = self.cache_width(max_len)
        nL = c.num_layers
        kv = ("layers", "batch", "seq", "kv_heads", None)
        return {
            "k": PD((nL, batch_size, W, c.num_kv_heads, Dh), kv, init="zeros"),
            "v": PD((nL, batch_size, W, c.num_kv_heads, Dh), kv, init="zeros"),
        }

    def decode_step(self, params: dict, cache: dict, pos,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One-token decode. tokens: (B, 1); pos: an int (tokens already in
        cache), or a (B,) int tensor when continuous batching has each slot
        at its own depth.  Writes the new token's k/v into `cache` in place;
        returns (logits (B,1,V) f32, cache)."""
        c = self.cfg
        self._check_dense()
        x = params["embed"][tokens]
        ring = c.sliding_window is not None
        blocks = params["blocks"]
        for i in range(c.num_layers):
            lp = layer_params(blocks, i)
            h = L.rms_norm(x, lp["ln1"], c.norm_eps)
            a, _, _ = L.decode_attention(lp["attn"], h, self.dims,
                                         k_cache=cache["k"][i],
                                         v_cache=cache["v"][i], pos=pos,
                                         ring=ring)
            x = x + a
            h = L.rms_norm(x, lp["ln2"], c.norm_eps)
            x = x + L.swiglu(lp["ffn"], h)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        logits = (x @ self._head(params)).float()
        return logits, cache

    def prefill(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Run the full prompt, build the KV cache, return last-token logits.

        batch["tokens"]: (B, S).  Returns (logits (B,1,V) f32,
        {"k", "v": (layers, B, W, KH, Dh)})."""
        c = self.cfg
        self._check_dense()
        tokens = batch["tokens"]
        x = params["embed"][tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        W = self.cache_width(S)
        blocks = params["blocks"]
        ks, vs = [], []
        for i in range(c.num_layers):
            lp = layer_params(blocks, i)
            h = L.rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = L._project_qkv(lp["attn"], h, self.dims, positions)
            attn_out = self._prefill_attn(q, k, v)
            x = x + attn_out.reshape(B, S, -1) @ lp["attn"]["wo"]
            h = L.rms_norm(x, lp["ln2"], c.norm_eps)
            x = x + L.swiglu(lp["ffn"], h)
            ks.append(self._to_ring(k, W, S))
            vs.append(self._to_ring(v, W, S))
        x = L.rms_norm(x[:, -1:, :], params["ln_f"], c.norm_eps)
        logits = (x @ self._head(params)).float()
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _prefill_attn(self, q, k, v):
        return ops.flash_attention(q, k, v, causal=self.dims.causal,
                                   window=self.dims.window)

    def _to_ring(self, k: torch.Tensor, W: int, S: int) -> torch.Tensor:
        """Arrange the last W positions into ring-buffer slot order."""
        if W >= S:
            return k
        lastW = k[:, S - W:]
        return torch.roll(lastW, shifts=S % W, dims=1)
