"""Config system for WideJAX.

Every assigned architecture registers a :class:`ModelConfig` here (exact
published dimensions) plus a reduced smoke variant derived by
:func:`smoke_config`.  Input shapes are global (arch × shape) cells; the
launcher cross-products them with meshes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # "fine-grained" MoE (dbrx) keeps d_ff per expert as given; capacity factor
    # is only used by the dropping router variant.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD hyper-parameters."""
    state_dim: int          # N (ssm_state)
    head_dim: int = 64      # P
    expand: int = 2         # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256        # SSD chunk length
    ngroups: int = 1        # B/C groups


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # 0 => attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default: d_model // num_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None # SWA window (danube)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every `attn_every`
    # mamba blocks (weights shared, LoRA-free simplification).
    attn_every: int = 0
    # enc-dec (whisper): encoder depth; decoder depth = num_layers.
    encoder_layers: int = 0
    source_len: int = 1500         # whisper: frames after conv frontend stub
    # vlm (pixtral): input_specs feeds precomputed patch embeddings of this
    # many positions prepended to the token stream.
    vision_tokens: int = 0
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM state or SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d          # q,k,v,o
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        mlp = 3 * d * f                                   # swiglu: gate,up,down
        if self.moe is not None:
            mlp = self.moe.num_experts * 3 * d * f + d * self.moe.num_experts
        norms = 2 * d
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            blk = (d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)  # in_proj
                   + s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)  # conv
                   + nheads                                               # A, dt_bias -> 2*nheads
                   + nheads
                   + d_in * d                                             # out_proj
                   + d)                                                   # norm
            total = self.num_layers * blk
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            mamba_blk = (d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
                         + s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)
                         + 2 * nheads + d_in * d + d)
            shared_attn = attn + 3 * d * f + norms  # one shared block
            total = self.num_layers * mamba_blk + shared_attn
        else:
            total = self.num_layers * (attn + mlp + norms)
            if self.encoder_layers:
                # encoder blocks + decoder cross-attention
                total += self.encoder_layers * (attn + mlp + norms)
                total += self.num_layers * (attn + d)
        total += v * d                                   # embed
        if not self.tie_embeddings:
            total += v * d                               # lm head
        total += d                                       # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_experts = self.moe.num_experts * 3 * d * f
        active_experts = self.moe.top_k * 3 * d * f
        return self.param_count() - self.num_layers * (dense_experts - active_experts)


# ---------------------------------------------------------------------------
# shapes (assigned cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("full quadratic attention: 500k KV cache does not fit "
                       "and prefill is O(L^2); skipped per assignment rules")
    return True, ""


# ---------------------------------------------------------------------------
# comm / mesh / train configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommConfig:
    """MPWide path configuration (paper §1.3.1)."""
    mode: str = "hierarchical"   # flat | hierarchical | gateway
    streams: int = 32            # paper: 1 local, >=32 WAN, <=256 efficient
    chunk_mb: float = 8.0        # MPW_setChunkSize analogue
    compress: str = "none"       # none | bf16 | int8   (beyond-paper)
    autotune: bool = True        # MPW_setAutoTuning (default on, like paper)
    pacing: float = 1.0          # MPW_setPacingRate: fraction in flight
    # cross-pod all-reduce algorithm (beyond-paper): "psum" lowers each
    # chunk to one collective (gather-based when compressed: per-pod bytes
    # grow linearly in pod count); "ring"/"ring2" are bandwidth-optimal
    # ppermute rings with per-step requantization (ring2: bidirectional,
    # half the latency-step depth) — see repro/core/ring.py
    algo: str = "psum"           # psum | ring | ring2
    # gradient-sync bucket size (beyond-paper latency hiding): > 0 splits
    # the gradient tree into ~bucket_mb buckets along the stacked `layers`
    # dim so each bucket's cross-pod sync can flush during backprop and the
    # exposed tail is consumed bucket-by-bucket interleaved with the
    # optimizer — see repro/core/buckets.py.  0 disables bucketing (one
    # whole-tree sync, the pre-bucketing behaviour).
    bucket_mb: float = 0.0
    # local-SGD cadence (beyond-paper elasticity, see repro/core/localsgd.py):
    # K > 1 keeps each step's gradient sync site-local and ships a model
    # *delta* across the WAN only every K-th step.  1 (default) is fully
    # synchronous — bit-identical to the pre-elastic behaviour.
    local_steps: int = 1


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # production shapes are fixed by the assignment:
    #   single-pod (16,16) ("data","model"); multi-pod (2,16,16) ("pod",...)
    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    zero1: bool = True           # shard optimizer state over data axis
    microbatches: int = 1        # gradient accumulation steps
    loss_dtype: str = "float32"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    comm: CommConfig = field(default_factory=CommConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import arch modules lazily so `configs.base` has no import cycle
    from repro_torch import configs as _pkg  # noqa: F401
    _pkg.load_all()


# ---------------------------------------------------------------------------
# smoke reduction
# ---------------------------------------------------------------------------

def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests.

    Keeps every structural feature (GQA ratio shape, bias, SWA, MoE top-k,
    SSD, shared-attn interleave, enc-dec, vision stub) while shrinking width,
    depth and tables so a forward+train step runs on one CPU device.
    """
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=32 if cfg.num_heads else None,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=0,
        sliding_window=64 if cfg.sliding_window else None,
        vision_tokens=16 if cfg.vision_tokens else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        source_len=24 if cfg.encoder_layers else cfg.source_len,
        remat=False,
    )
    if cfg.num_heads:
        # preserve the GQA grouping style: MHA stays MHA, GQA stays grouped
        if cfg.num_kv_heads == cfg.num_heads:
            kw["num_kv_heads"] = kw["num_heads"]
        else:
            kw["num_kv_heads"] = max(1, kw["num_heads"] // max(1, cfg.num_heads // cfg.num_kv_heads))
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=32, chunk=16)
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["num_layers"] = 4
    return dataclasses.replace(cfg, **kw)
