"""Decoder-only and encoder-decoder transformer LM: the dense, moe, vlm
(stub patch-embedding inputs) and audio (stub frame-embedding inputs,
encoder-decoder) families; the training forward and loss (differentiable),
prefill and cached decode.

Parameters keep the JAX package's stacked ``(layers, ...)`` layout and names;
the layers are a Python loop over that stack (the JAX package scans it).
With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(recomputed in the backward, the JAX package's ``jax.checkpoint``).  The
``gather`` hook of :meth:`Transformer.hidden_states` and
:meth:`Transformer.loss` (ZeRO-3's all-gather at use) is applied to each
layer's parameters inside that checkpoint, so the recompute gathers the
layer again and the gathered layer is not kept between the passes; the
encoder's layers take it the same way.
With ``flush_segments`` (the bucketed backward flush, ``core/buckets.py``)
the stack is split at bucket boundaries and each segment's stacked
parameters pass through its bucket's flush hook before they are unstacked
into layers, so the hook's backward runs once every layer of the segment has
returned its gradient.
The MoE family's FFN is ``models/moe.py``'s scatter path, its aux loss summed
over the layers and added to the loss as the JAX package adds it.

With `tp` (a :class:`repro_torch.models.layers.TensorParallel`, the mesh's
model axis) the parameters are this rank's TP shards
(``models/param.py`` ``tp_dim``) and the blocks run Megatron-style: each
rank's attention on its H/tp query and KH/tp K/V heads (the JAX package's
``heads`` attention mode) and its MLP on its ff columns, their input
wrapped in ``tp_copy`` and their output summed over the model group by
``tp_reduce``; the MoE FFN is expert-parallel (``models/moe.py``); the
embedding, a tied head and the cross-entropy are vocab-parallel when the
vocab divides by the group (else the table is whole on every rank), and
the logits of ``logits``, ``prefill`` and ``decode_step`` are gathered
whole on every rank.  The decode cache holds the rank's K/V heads.  The
audio and vlm families and the other attention modes are queued.
The vlm family prepends ``batch["patch_embeds"]`` (B, vision_tokens, d) to
the token embeddings: RoPE positions run over the prefix, the prefill cache
holds its K/V, and ``loss``/``logits`` drop its positions.  The audio family
(``rope_theta`` 0) adds sinusoidal positions to the tokens and encodes
``batch["source_frames"]`` (B, source_len, d) with a non-causal encoder; each
decoder block cross-attends to its output, whose per-layer K/V prefill keeps
in the cache as ``xk``/``xv`` for decode.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import (TP_ITEM, queued, tp_copy, tp_gather,
                                          tp_reduce)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.param import PD

def layer_params(blocks: dict, i: int) -> dict:
    """Layer `i`'s parameters: views into the stacked tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def split_layers(blocks: dict, bounds: list) -> list[dict]:
    """The stacked parameters cut into the layer ranges `bounds` ([(lo, hi),
    ...] tiling the stack in order), by ``torch.split`` of each tensor: in
    the backward the segments' gradients are joined by one concatenation."""
    sizes = [hi - lo for lo, hi in bounds]
    out: list[dict] = [{} for _ in bounds]
    for k, v in blocks.items():
        parts = (split_layers(v, bounds) if isinstance(v, dict)
                 else torch.split(v, sizes, 0))
        for i, part in enumerate(parts):
            out[i][k] = part
    return out


def unstack_layers(blocks: dict, n: int) -> list[dict]:
    """Every layer's parameters at once, by ``torch.unbind`` of each stacked
    tensor: in the backward the per-layer gradients are stacked once, not
    added into a zero tensor of the whole stack per layer."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in blocks.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def attn_shard_mode(num_kv_heads: int, tp: int) -> str:
    """The JAX package's ``attn_shard_mode`` for the port: ``heads`` when the
    K/V heads divide over the model ranks.  Its ``batch`` and ``seq`` modes
    are queued and raise."""
    if num_kv_heads % tp == 0:
        return "heads"
    raise queued(f"attention over {tp} model ranks with {num_kv_heads} K/V "
                 f"heads (the 'batch' and 'seq' shard modes)", TP_ITEM)


class Transformer:
    def __init__(self, cfg: ModelConfig, tp: "L.TensorParallel | None" = None):
        self.cfg = cfg
        self.dims = L.AttnDims(
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
            window=cfg.sliding_window,
        )
        self.tp = tp
        self.ldims = self.dims            # this rank's heads
        self.vocab_tp = None              # the tp of a vocab-parallel table
        if tp is not None:
            if cfg.family not in ("dense", "moe"):
                raise queued(f"the {cfg.family} family over {tp.size} model "
                             f"ranks", TP_ITEM)
            attn_shard_mode(cfg.num_kv_heads, tp.size)
            self.ldims = self.dims._replace(num_heads=cfg.num_heads // tp.size,
                                            num_kv_heads=cfg.num_kv_heads // tp.size)
            if cfg.vocab_size % tp.size == 0:
                self.vocab_tp = tp

    def _col(self, x: torch.Tensor) -> torch.Tensor:
        """The input of rank-local (column-parallel) work."""
        return x if self.tp is None else tp_copy(x, self.tp.group)

    def _row(self, x: torch.Tensor) -> torch.Tensor:
        """The output of rank-local (row-parallel) work, summed over ranks."""
        return x if self.tp is None else tp_reduce(x, self.tp.group)

    def _full_logits(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        """f32 logits over the whole vocab on every rank."""
        if self.vocab_tp is None:
            return (x @ self._head(params)).float()
        out = (self._col(x) @ self._head(params)).float()
        return tp_gather(out, -1, self.tp.group)

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
            E = c.moe.num_experts
            return {
                "router": PD((n_layers, d, E), ("layers", "d_model", None)),
                "gate": PD((n_layers, E, d, f), ("layers", "experts", "d_model", None)),
                "up": PD((n_layers, E, d, f), ("layers", "experts", "d_model", None)),
                "down": PD((n_layers, E, f, d), ("layers", "experts", None, "d_model"),
                           scale=(f ** -0.5) / (2 * c.num_layers) ** 0.5),
            }
        return {
            "gate": PD((n_layers, d, f), ("layers", "d_model", "ff")),
            "up": PD((n_layers, d, f), ("layers", "d_model", "ff")),
            "down": PD((n_layers, f, d), ("layers", "ff", "d_model"),
                       scale=(f ** -0.5) / (2 * c.num_layers) ** 0.5),
        }

    def param_defs(self) -> dict:
        c = self.cfg
        d, V, nL = c.d_model, c.vocab_size, c.num_layers
        blocks = {
            "attn": self._attn_defs(nL),
            "ffn": self._ffn_defs(nL),
            "ln1": PD((nL, d), ("layers", "d_model"), init="ones"),
            "ln2": PD((nL, d), ("layers", "d_model"), init="ones"),
        }
        if c.encoder_layers:
            blocks["xattn"] = self._attn_defs(nL)
            blocks["lnx"] = PD((nL, d), ("layers", "d_model"), init="ones")
        defs = {
            "blocks": blocks,
            "embed": PD((V, d), ("vocab", "d_model"), scale=0.02),
            "ln_f": PD((d,), ("d_model",), init="ones"),
        }
        if not c.tie_embeddings:
            defs["head"] = PD((d, V), ("d_model", "vocab"))
        if c.encoder_layers:
            eL = c.encoder_layers
            defs["encoder"] = {
                "attn": self._attn_defs(eL),
                "ffn": {
                    "gate": PD((eL, d, c.d_ff), ("layers", "d_model", "ff")),
                    "up": PD((eL, d, c.d_ff), ("layers", "d_model", "ff")),
                    "down": PD((eL, c.d_ff, d), ("layers", "ff", "d_model")),
                },
                "ln1": PD((eL, d), ("layers", "d_model"), init="ones"),
                "ln2": PD((eL, d), ("layers", "d_model"), init="ones"),
                "ln_f": PD((d,), ("d_model",), init="ones"),
            }
        return defs

    # ------------------------------------------------------------------
    # training forward and loss
    # ------------------------------------------------------------------

    def _ffn(self, p: dict, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The block's FFN on `h`: (y, aux), aux None off the MoE family."""
        if self.cfg.moe is not None:
            return moe_lib.moe_ffn(p, h, self.cfg.moe, tp=self.tp)
        return self._row(L.swiglu(p, self._col(h))), None

    def _block(self, lp: dict, x: torch.Tensor, positions: torch.Tensor,
               enc_out) -> tuple[torch.Tensor, torch.Tensor | None]:
        c = self.cfg
        h = L.rms_norm(x, lp["ln1"], c.norm_eps)
        x = x + self._row(L.attention(lp["attn"], self._col(h), self.ldims,
                                      positions=positions))
        if enc_out is not None:
            h = L.rms_norm(x, lp["lnx"], c.norm_eps)
            x = x + L.attention(lp["xattn"], h, self.dims, kv_x=enc_out)
        h = L.rms_norm(x, lp["ln2"], c.norm_eps)
        y, aux = self._ffn(lp["ffn"], h)
        return x + y, aux

    def _apply_block(self, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                     enc_out, gather) -> tuple[torch.Tensor, torch.Tensor | None]:
        return self._block(gather(lp) if gather is not None else lp, x,
                           positions, enc_out)

    def _layers(self, blocks: dict, flush_segments) -> list[dict]:
        if flush_segments is None:
            return unstack_layers(blocks, self.cfg.num_layers)
        bounds, hooks = flush_segments
        layers: list[dict] = []
        for (lo, hi), hook, seg in zip(bounds, hooks, split_layers(blocks, bounds)):
            layers += unstack_layers(hook(seg), hi - lo)
        return layers

    def _embed_inputs(self, params: dict, batch: dict):
        """Token (+ stub modality) embedding: (x, positions, n_prefix).  The
        vlm family's patch embeddings come first, cast to the embedding's
        dtype; the audio family adds sinusoidal positions."""
        c = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], self.vocab_tp)
        n_prefix = 0
        if c.vision_tokens:
            patches = batch["patch_embeds"].to(x.dtype)            # (B, n_vis, d)
            x = torch.cat([patches, x], dim=1)
            n_prefix = patches.shape[1]
        positions = torch.arange(x.shape[1], device=x.device)
        if not c.rope_theta:      # sinusoidal absolute positions (whisper)
            x = x + L.sinusoidal_positions(positions, c.d_model).to(x.dtype)[None]
        return x, positions, n_prefix

    def _encoder_block(self, lp: dict, x: torch.Tensor, gather) -> torch.Tensor:
        c = self.cfg
        if gather is not None:
            lp = gather(lp)
        dims = self.dims._replace(causal=False, window=None)
        h = L.rms_norm(x, lp["ln1"], c.norm_eps)
        x = x + L.attention(lp["attn"], h, dims)
        h = L.rms_norm(x, lp["ln2"], c.norm_eps)
        return x + L.swiglu(lp["ffn"], h)

    def _encode(self, params: dict, batch: dict, gather=None):
        """The audio family's encoder over ``batch["source_frames"]`` (cast
        to the parameters' dtype) with sinusoidal positions: non-causal
        self-attention without a window, `gather` applied to each layer
        inside its checkpoint, then the final norm.  None without one.
        The checkpoint runs only where autograd records (training): in
        prefill it would save nothing, and its first call imports
        ``torch._dynamo``, seconds of host time on the first request."""
        c = self.cfg
        if not c.encoder_layers:
            return None
        enc = params["encoder"]
        src = batch["source_frames"].to(enc["ln_f"].dtype)        # (B, src_len, d)
        pos = torch.arange(src.shape[1], device=src.device)
        x = src + L.sinusoidal_positions(pos, c.d_model).to(src.dtype)[None]
        blocks = {k: enc[k] for k in ("attn", "ffn", "ln1", "ln2")}
        remat = c.remat and torch.is_grad_enabled()
        for lp in unstack_layers(blocks, c.encoder_layers):
            if remat:
                x = checkpoint(self._encoder_block, lp, x, gather, use_reentrant=False)
            else:
                x = self._encoder_block(lp, x, gather)
        return L.rms_norm(x, enc["ln_f"], c.norm_eps)

    def hidden_states(self, params: dict, batch: dict, *, gather=None,
                      flush_segments=None):
        """Full-sequence forward to the final-norm hidden states.  Returns
        (x, aux_loss, n_prefix), as the JAX package's does (aux the MoE
        layers' sum, 0 elsewhere; n_prefix the vlm family's patch
        positions at the front of x).  `gather(lp)` maps one layer's stored
        parameters (ZeRO shards) to those it computes with.
        `flush_segments` = (layer bounds tiling the stack in order, one flush
        hook per bound) splits the stack at gradient-bucket boundaries; the
        forward computes the same numbers."""
        c = self.cfg
        enc_out = self._encode(params, batch, gather)
        x, positions, n_prefix = self._embed_inputs(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self._layers(params["blocks"], flush_segments):
            if c.remat:
                x, a = checkpoint(self._apply_block, lp, x, positions, enc_out,
                                  gather, use_reentrant=False)
            else:
                x, a = self._apply_block(lp, x, positions, enc_out, gather)
            if a is not None:
                aux = aux + a
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return x, aux, n_prefix

    def loss(self, params: dict, batch: dict, *, gather=None,
             flush_segments=None) -> tuple[torch.Tensor, dict]:
        """batch["tokens"]: (B, S+1), teacher forcing, and the family's stub
        inputs.  Returns (mean_local_loss, metrics); the patch positions
        carry no loss.  `gather`, `flush_segments`: as in
        :meth:`hidden_states`."""
        tokens = batch["tokens"]
        inputs = {**batch, "tokens": tokens[:, :-1]}
        labels = tokens[:, 1:]
        x, aux, n_prefix = self.hidden_states(params, inputs, gather=gather,
                                              flush_segments=flush_segments)
        if n_prefix:
            x = x[:, n_prefix:]
        sum_loss, count = L.chunked_ce_loss(x, self._head(params), labels,
                                            tp=self.vocab_tp)
        loss = sum_loss / torch.clamp(count, min=1.0)
        metrics = {"ce_loss": loss, "aux_loss": aux, "tokens": count}
        if self.cfg.moe is not None:
            loss = loss + 0.01 * aux / self.cfg.num_layers
        return loss, metrics

    def logits(self, params: dict, batch: dict, *, gather=None) -> torch.Tensor:
        """(B, S, V) f32 logits of every token position (the patch
        positions dropped)."""
        x, _, n_prefix = self.hidden_states(params, batch, gather=gather)
        if n_prefix:
            x = x[:, n_prefix:]
        return self._full_logits(x, params)

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
        Dh = c.resolved_head_dim
        W = self.cache_width(max_len)
        nL = c.num_layers
        KH = self.ldims.num_kv_heads      # this rank's K/V heads
        kv = ("layers", "batch", "seq", "kv_heads", None)
        defs = {
            "k": PD((nL, batch_size, W, KH, Dh), kv, init="zeros"),
            "v": PD((nL, batch_size, W, KH, Dh), kv, init="zeros"),
        }
        if c.encoder_layers:
            src = c.source_len
            defs["xk"] = PD((nL, batch_size, src, c.num_kv_heads, Dh), kv, init="zeros")
            defs["xv"] = PD((nL, batch_size, src, c.num_kv_heads, Dh), kv, init="zeros")
        return defs

    def decode_step(self, params: dict, cache: dict, pos,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One-token decode. tokens: (B, 1); pos: an int (tokens already in
        cache), or a (B,) int tensor when continuous batching has each slot
        at its own depth.  Writes the new token's k/v into `cache` in place;
        the audio family cross-attends to the cache's ``xk``/``xv``.
        Returns (logits (B,1,V) f32, cache)."""
        c = self.cfg
        x = L.embed_lookup(params["embed"], tokens, self.vocab_tp)
        if not c.rope_theta:
            pos_t = torch.as_tensor(pos, device=x.device)
            if pos_t.dim() >= 1:
                sin = L.sinusoidal_positions(pos_t.reshape(-1), c.d_model)[:, None, :]
            else:
                sin = L.sinusoidal_positions(pos_t.reshape(1), c.d_model)[None]
            x = x + sin.to(x.dtype)
        ring = c.sliding_window is not None
        blocks = params["blocks"]
        for i in range(c.num_layers):
            lp = layer_params(blocks, i)
            h = L.rms_norm(x, lp["ln1"], c.norm_eps)
            a, _, _ = L.decode_attention(lp["attn"], self._col(h), self.ldims,
                                         k_cache=cache["k"][i],
                                         v_cache=cache["v"][i], pos=pos,
                                         ring=ring)
            x = x + self._row(a)
            if c.encoder_layers:
                h = L.rms_norm(x, lp["lnx"], c.norm_eps)
                x = x + self._cross_decode(lp["xattn"], h, cache["xk"][i],
                                           cache["xv"][i])
            h = L.rms_norm(x, lp["ln2"], c.norm_eps)
            x = x + self._ffn(lp["ffn"], h)[0]
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return self._full_logits(x, params), cache

    def _cross_decode(self, p: dict, x: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor) -> torch.Tensor:
        """One token's cross-attention to the encoder's cached K/V (B, src,
        KH, Dh): plain f32 products and softmax, as in the JAX package."""
        dims = self.dims
        B = x.shape[0]
        H, KH, Dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
        q = (x @ p["wq"]).reshape(B, 1, KH, H // KH, Dh).float() * Dh ** -0.5
        s = torch.einsum("bqkgd,bskd->bkgqs", q, xk.float())
        o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), xv.float())
        return o.reshape(B, 1, H * Dh).to(x.dtype) @ p["wo"]

    def prefill(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Run the full prompt, build the KV cache, return last-token logits.

        batch["tokens"]: (B, S), and the family's stub inputs.  Returns
        (logits (B,1,V) f32, {"k", "v": (layers, B, W, KH, Dh)}) with W the
        cache width of the n_prefix + S positions; the audio family adds
        {"xk", "xv": (layers, B, source_len, KH, Dh)}, each layer's
        cross-attention K/V of the encoder output."""
        c = self.cfg
        enc_out = self._encode(params, batch)
        x, positions, _ = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        W = self.cache_width(S)
        blocks = params["blocks"]
        ks, vs, xks, xvs = [], [], [], []
        for i in range(c.num_layers):
            lp = layer_params(blocks, i)
            h = L.rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = L._project_qkv(lp["attn"], self._col(h), self.ldims, positions)
            attn_out = self._prefill_attn(q, k, v)
            x = x + self._row(attn_out.reshape(B, S, -1) @ lp["attn"]["wo"])
            if enc_out is not None:
                h = L.rms_norm(x, lp["lnx"], c.norm_eps)
                a, xk, xv = self._cross_prefill(lp["xattn"], h, enc_out)
                x = x + a
                xks.append(xk)
                xvs.append(xv)
            h = L.rms_norm(x, lp["ln2"], c.norm_eps)
            x = x + self._ffn(lp["ffn"], h)[0]
            ks.append(self._to_ring(k, W, S))
            vs.append(self._to_ring(v, W, S))
        x = L.rms_norm(x[:, -1:, :], params["ln_f"], c.norm_eps)
        logits = self._full_logits(x, params)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if enc_out is not None:
            cache.update(xk=torch.stack(xks), xv=torch.stack(xvs))
        return logits, cache

    def _cross_prefill(self, p: dict, h: torch.Tensor, enc_out: torch.Tensor):
        """Cross-attention of the prompt to the encoder output: (out, xk,
        xv).  The JAX package's ``attention(kv_x=enc_out)`` (no RoPE: the
        audio family has none) with its K/V projected once, for both the
        flash kernel (non-causal) and the cache."""
        dims = self.dims
        B, S, _ = h.shape
        H, KH, Dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
        q = (h @ p["wq"]).reshape(B, S, H, Dh)
        xk = (enc_out @ p["wk"]).reshape(B, -1, KH, Dh)
        xv = (enc_out @ p["wv"]).reshape(B, -1, KH, Dh)
        o = ops.flash_attention(q, xk, xv, causal=False, window=None)
        return o.reshape(B, S, H * Dh) @ p["wo"], xk, xv

    def _prefill_attn(self, q, k, v):
        return ops.flash_attention(q, k, v, causal=self.dims.causal,
                                   window=self.dims.window)

    def _to_ring(self, k: torch.Tensor, W: int, S: int) -> torch.Tensor:
        """Arrange the last W positions into ring-buffer slot order."""
        if W >= S:
            return k
        lastW = k[:, S - W:]
        return torch.roll(lastW, shifts=S % W, dims=1)
