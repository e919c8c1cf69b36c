"""Mamba2 / SSD (state-space duality) blocks and the attention-free LM
(mamba2-780m).

Prefill and the training forward use the chunked SSD algorithm
(arXiv:2405.21060): quadratic attention *within* chunks of length Q, a linear
state recurrence *across* chunks (a Python loop over the S/Q chunk states;
the JAX package scans it).  Decode uses the O(1) recurrent update.  B/C are
group-shared (ngroups = 1) and broadcast over the heads.

Parameters keep the JAX package's stacked ``(layers, ...)`` layout and names;
``A`` and ``dt_bias`` are f32 inside a bf16 tree.  ``ln`` and ``ln_f`` go
through :func:`layers.rms_norm` (the rmsnorm kernel on the card); the causal
conv, the SSD scan and :func:`gated_rmsnorm` are plain torch, as they are
plain JAX in the reference.  Decode writes the new states into the cache in
place (the JAX package returns updated copies).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import PD
from repro_torch.models.transformer import layer_params, unstack_layers


def mamba_block_defs(cfg: ModelConfig, n_layers: int) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    H = d_in // s.head_dim
    gN = s.ngroups * s.state_dim
    lay = ("layers",)
    return {
        "w_z": PD((n_layers, d, d_in), lay + ("d_model", "d_inner")),
        "w_x": PD((n_layers, d, d_in), lay + ("d_model", "d_inner")),
        "w_B": PD((n_layers, d, gN), lay + ("d_model", None)),
        "w_C": PD((n_layers, d, gN), lay + ("d_model", None)),
        "w_dt": PD((n_layers, d, H), lay + ("d_model", "ssm_heads")),
        "conv_x": PD((n_layers, s.conv_width, d_in), lay + ("conv", "d_inner"),
                     scale=s.conv_width ** -0.5),
        "conv_B": PD((n_layers, s.conv_width, gN), lay + ("conv", None),
                     scale=s.conv_width ** -0.5),
        "conv_C": PD((n_layers, s.conv_width, gN), lay + ("conv", None),
                     scale=s.conv_width ** -0.5),
        "conv_x_b": PD((n_layers, d_in), lay + ("d_inner",), init="zeros"),
        "conv_B_b": PD((n_layers, gN), lay + (None,), init="zeros"),
        "conv_C_b": PD((n_layers, gN), lay + (None,), init="zeros"),
        "A": PD((n_layers, H), lay + ("ssm_heads",), init="ssm_a", dtype="float32"),
        "dt_bias": PD((n_layers, H), lay + ("ssm_heads",), init="zeros", dtype="float32"),
        "norm": PD((n_layers, d_in), lay + ("d_inner",), init="ones"),
        "w_out": PD((n_layers, d_in, d), lay + ("d_inner", "d_model"),
                    scale=(d_in ** -0.5) / (2 * max(cfg.num_layers, 1)) ** 0.5),
        "ln": PD((n_layers, d), lay + ("d_model",), init="ones"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (W, C); b: (C,)."""
    W, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(W):
        shift = W - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * w[i]
    return out + b


def _ssd_chunked(xh, dt, A, Bm, Cm, Q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs; dt: (B, S, H) softplus'd; A: (H,) negative;
    Bm/Cm: (B, S, N) (ngroups = 1, broadcast over heads).  Returns (y
    (B, S, H, P) in xh's dtype, the f32 state (B, H, P, N) after the last
    position: the padding adds nothing to it, its dt being 0).  The
    (B, nc, Q, Q, H) f32 intra-chunk weights are freed as soon as they are
    used."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q
    out_dtype = xh.dtype
    xh = xh.reshape(Bsz, nc, Q, H, P)
    dt = dt.reshape(Bsz, nc, Q, H).float()
    Bm = Bm.reshape(Bsz, nc, Q, N).float()
    Cm = Cm.reshape(Bsz, nc, Q, N).float()

    dA = dt * A[None, None, None, :]                      # (B,nc,Q,H) negative
    dA_cs = torch.cumsum(dA, dim=2)                       # inclusive cumsum
    seg_sum = dA_cs[:, :, -1, :]                          # (B,nc,H)

    # intra-chunk (quadratic within chunk): y_i += sum_{j<=i} C_i.B_j *
    #   exp(dAcs_i - dAcs_j) * dt_j * x_j
    scores = torch.einsum("bcqn,bckn->bcqk", Cm, Bm)      # (B,nc,Q,Q)
    ii = torch.arange(Q, device=xh.device)
    causal = ii[:, None] >= ii[None, :]
    # mask in the log domain BEFORE exp, as the reference does
    logdecay = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    w = torch.exp(logdecay.masked_fill(~causal[None, None, :, :, None], -1e30))
    del logdecay
    w = w * scores[..., None]
    del scores
    xdt = xh.float() * dt[..., None]                      # (B,nc,Q,H,P)
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, xdt)
    del w

    # chunk states: S_c = sum_j B_j (x_j dt_j) exp(seg_sum - dAcs_j)
    decay_to_end = torch.exp(seg_sum[:, :, None, :] - dA_cs)          # (B,nc,Q,H)
    state_c = torch.einsum("bcqn,bcqhp->bchpn", Bm,
                           xdt * decay_to_end[..., None])
    del xdt, decay_to_end

    # inter-chunk recurrence: h_c = exp(seg_sum_{c-1}) h_{c-1} + S_{c-1};
    # the state BEFORE each chunk
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    prefix = []
    for c in range(nc):
        prefix.append(h)
        h = h * torch.exp(seg_sum[:, c])[:, :, None, None] + state_c[:, c]
    h_prefix = torch.stack(prefix, dim=1)                 # (B,nc,H,P,N)

    # y_inter_i = C_i . (exp(dAcs_i) * h_prefix)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cm, h_prefix)
    y = y + y_inter * torch.exp(dA_cs)[..., None]
    return y.reshape(Bsz, Sp, H, P)[:, :S].to(out_dtype), h


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(y * silu(z)) * w over the channel dim."""
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


def mamba_forward(lp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  with_state: bool = False):
    """One mamba2 block (pre-norm residual included). x: (B, S, d).  With
    `with_state`, (x, the recurrent state the block leaves: ``ssm`` f32
    (B, H, P, N), ``conv`` the last W-1 pre-activation conv inputs in x's
    dtype), from the same pass."""
    s = cfg.ssm
    B_, S, d = x.shape
    d_in = s.expand * d
    H = d_in // s.head_dim
    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    z = h @ lp["w_z"]
    xs = h @ lp["w_x"]
    Bm = h @ lp["w_B"]
    Cm = h @ lp["w_C"]
    dt = (h @ lp["w_dt"]).float()
    if with_state:
        conv = torch.cat([xs, Bm, Cm], dim=-1)[:, -(s.conv_width - 1):]
    xs = F.silu(_causal_conv(xs, lp["conv_x"], lp["conv_x_b"]))
    Bm = F.silu(_causal_conv(Bm, lp["conv_B"], lp["conv_B_b"]))
    Cm = F.silu(_causal_conv(Cm, lp["conv_C"], lp["conv_C_b"]))
    dt = F.softplus(dt + lp["dt_bias"])
    xh = xs.reshape(B_, S, H, s.head_dim)
    y, ssm = _ssd_chunked(xh, dt, lp["A"], Bm, Cm, s.chunk)
    y = gated_rmsnorm(y.reshape(B_, S, d_in), z, lp["norm"], cfg.norm_eps)
    out = x + y @ lp["w_out"]
    return (out, {"ssm": ssm, "conv": conv}) if with_state else out


# ---------------------------------------------------------------------------
# decode (recurrent form)
# ---------------------------------------------------------------------------

def mamba_state_defs(cfg: ModelConfig, n_layers: int, batch: int) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    gN = s.ngroups * s.state_dim
    conv_ch = d_in + 2 * gN
    return {
        "ssm": PD((n_layers, batch, H, s.head_dim, s.state_dim),
                  ("layers", "batch", "ssm_heads", None, None), init="zeros",
                  dtype="float32"),
        "conv": PD((n_layers, batch, s.conv_width - 1, conv_ch),
                   ("layers", "batch", None, "conv_ch"), init="zeros",
                   dtype="float32"),
    }


def mamba_decode(lp: dict, state: dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, dict]:
    """One-token recurrent update. x: (B, 1, d); state: {"ssm", "conv"}, one
    layer's.  Returns (x, {"ssm", "conv"}) as new tensors; the dtypes follow
    the reference's promotions (the window takes the state's dtype)."""
    s = cfg.ssm
    B_, _, d = x.shape
    d_in = s.expand * d
    H = d_in // s.head_dim
    gN = s.ngroups * s.state_dim
    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)[:, 0]      # (B, d)
    z = h @ lp["w_z"]
    xs = h @ lp["w_x"]
    Bm = h @ lp["w_B"]
    Cm = h @ lp["w_C"]
    dt = F.softplus((h @ lp["w_dt"]).float() + lp["dt_bias"])

    # conv ring: state["conv"] holds the last (W-1) pre-activation inputs
    cur = torch.cat([xs, Bm, Cm], dim=-1)                # (B, conv_ch)
    hist = state["conv"]                                  # (B, W-1, conv_ch)
    wdt = torch.promote_types(hist.dtype, cur.dtype)
    wfull = torch.cat([lp["conv_x"], lp["conv_B"], lp["conv_C"]], dim=-1)
    bfull = torch.cat([lp["conv_x_b"], lp["conv_B_b"], lp["conv_C_b"]], dim=-1)
    window = torch.cat([hist.to(wdt), cur[:, None].to(wdt)], dim=1)  # (B, W, conv_ch)
    odt = torch.promote_types(wdt, wfull.dtype)
    conv_out = (torch.einsum("bwc,wc->bc", window.to(odt), wfull.to(odt))
                + bfull.to(odt))
    conv_out = F.silu(conv_out)
    new_conv = window[:, 1:]
    xs_c = conv_out[:, :d_in]
    Bm_c = conv_out[:, d_in:d_in + gN]
    Cm_c = conv_out[:, d_in + gN:]

    xh = xs_c.reshape(B_, H, s.head_dim).float()
    dA = torch.exp(dt * lp["A"][None])                   # (B, H)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], Bm_c.float())
    ssm = state["ssm"] * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm, Cm_c.float())
    y = y.reshape(B_, d_in).to(x.dtype)
    y = gated_rmsnorm(y, z, lp["norm"], cfg.norm_eps)
    out = x + (y @ lp["w_out"])[:, None]
    return out, {"ssm": ssm, "conv": new_conv}


def _final_state(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> dict:
    """Final (ssm, conv) state after processing x through one block: ``ssm``
    f32 (B, H, P, N), ``conv`` the last W-1 pre-activation inputs in x's
    dtype.  The JAX package sums the state over the whole prompt in one
    product; here it is the chunked scan's last state (the same sum in
    another order)."""
    return mamba_forward(lp, x, cfg, with_state=True)[1]


# ---------------------------------------------------------------------------
# the attention-free model (mamba2-780m)
# ---------------------------------------------------------------------------

class MambaLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_defs(self) -> dict:
        c = self.cfg
        defs = {
            "blocks": mamba_block_defs(c, c.num_layers),
            "embed": PD((c.vocab_size, c.d_model), ("vocab", "d_model"), scale=0.02),
            "ln_f": PD((c.d_model,), ("d_model",), init="ones"),
        }
        if not c.tie_embeddings:
            defs["head"] = PD((c.d_model, c.vocab_size), ("d_model", "vocab"))
        return defs

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["head"]

    def _apply(self, lp, x, gather):
        return mamba_forward(gather(lp) if gather is not None else lp, x, self.cfg)

    def hidden_states(self, params, batch, *, gather=None):
        """Full-sequence forward to the final-norm hidden states: (x, aux 0,
        no prefix), as the JAX package's."""
        c = self.cfg
        x = params["embed"][batch["tokens"]]
        for lp in unstack_layers(params["blocks"], c.num_layers):
            if c.remat:
                x = checkpoint(self._apply, lp, x, gather, use_reentrant=False)
            else:
                x = self._apply(lp, x, gather)
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return x, torch.zeros((), dtype=torch.float32, device=x.device), 0

    def loss(self, params, batch, *, gather=None):
        tokens = batch["tokens"]
        x, aux, _ = self.hidden_states(params, {**batch, "tokens": tokens[:, :-1]},
                                       gather=gather)
        sum_loss, count = L.chunked_ce_loss(x, self._head(params), tokens[:, 1:])
        loss = sum_loss / torch.clamp(count, min=1.0)
        return loss, {"ce_loss": loss, "aux_loss": aux, "tokens": count}

    def logits(self, params, batch, *, gather=None):
        x, _, _ = self.hidden_states(params, batch, gather=gather)
        return (x @ self._head(params)).float()

    def cache_defs(self, batch_size: int, max_len: int) -> dict:
        return mamba_state_defs(self.cfg, self.cfg.num_layers, batch_size)

    def decode_step(self, params, cache, pos, tokens):
        """One-token decode. tokens: (B, 1); `pos` is unused (the state
        carries the history).  Writes the new states into `cache` in place;
        returns (logits (B, 1, V) f32, cache)."""
        c = self.cfg
        x = params["embed"][tokens]
        for i in range(c.num_layers):
            x, new = mamba_decode(layer_params(params["blocks"], i),
                                  {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                                  x, c)
            cache["ssm"][i].copy_(new["ssm"])
            cache["conv"][i].copy_(new["conv"])
        x = L.rms_norm(x, params["ln_f"], c.norm_eps)
        return (x @ self._head(params)).float(), cache

    def prefill(self, params, batch):
        """The chunked forward for the last position's logits and, per layer,
        the recurrent state it leaves (one pass a layer, ``with_state``).  Returns
        (logits (B, 1, V) f32, {"ssm": (L, B, H, P, N) f32, "conv":
        (L, B, W-1, conv_ch) in the activations' dtype})."""
        c = self.cfg
        x = params["embed"][batch["tokens"]]
        ssm, conv = [], []
        for i in range(c.num_layers):
            x, st = mamba_forward(layer_params(params["blocks"], i), x, c,
                                  with_state=True)
            ssm.append(st["ssm"])
            conv.append(st["conv"])
        x = L.rms_norm(x[:, -1:], params["ln_f"], c.norm_eps)
        logits = (x @ self._head(params)).float()
        return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}
