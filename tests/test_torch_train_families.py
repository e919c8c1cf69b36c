"""Training the ssm, hybrid, moe, audio and vlm families: the port's loss,
gradients and step pieces against the JAX package's, on the CPU, in one
process.

Both packages take the JAX package's own parameter tree (``tree_init(defs,
0)``, through ``params_from_jax`` for the port) and the same numpy tokens
and stub inputs, at each family's smoke config (mamba2-780m, zamba2-1.2b,
phi3.5-moe-42b-a6.6b, whisper-medium, pixtral-12b).  Checked:

* ``model.loss`` and every leaf's f32 gradient (``jax.grad`` against
  ``torch.autograd``), with the layers checkpointed as the published configs
  run them;
* the cross-pod chunk plan that ``_note_path_plan`` notes, with and without
  ZeRO's 1/D shards;
* the step's microbatch split: the vlm and audio families' stub inputs are
  cut along rows with the tokens (``build_train_step`` with 2 microbatches
  against the reference's on a one-device mesh);
* ZeRO's gather tables: one per stacked subtree, matched by structure; the
  encoder gathered layer by layer inside its checkpoint and only its final
  norm at the top; an unknown layer structure raises;
* the Trainer's batch placement: every key of a dict batch, this rank's
  rows of each, its dtype kept; the stub inputs reach ``model.loss``.

Tolerances, each with its reason:

* loss 1e-5 and gradients 1e-4 relative to the leaf's largest entry, the
  dense model's f32 bounds (``tests/test_torch_train_layers.py``): both sides
  compute in f32 and sum in other orders; 5e-4 for the gradients of the ssm
  and hybrid families, whose chunked SSD (exponentials of cumulative decays,
  the recurrence across chunks) and gated norm amplify those roundings: the
  smoke zamba2's worst leaf differs by 2.4e-4 of its largest entry, mamba2's
  by 5e-5 (``tools/ssm_depth_sweep.py`` shows the same amplification in the
  forward);
* the step with 2 microbatches: loss, grad norm and aux loss within 2e-3
  (relative for the norm), the bound of the multi-rank step tests
  (``tests/test_torch_train_zero.py``): bf16 parameters and activations,
  rounded at places that differ between XLA and PyTorch;
* the plans: equal.
"""
from __future__ import annotations

from dataclasses import asdict, replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import CommConfig as JCommConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core import telemetry as jtel
from repro.core.path import INTERPOD as J_INTERPOD
from repro.core.path import WidePath as JWidePath
from repro.models import build_model as j_build_model
from repro.models.param import tree_fsdp_dims as j_tree_fsdp_dims
from repro.models.param import tree_init as j_tree_init
from repro.runtime import step as jstep
from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.core import telemetry as ptel
from repro_torch.core.path import INTERPOD, WidePath
from repro_torch.core.tree import flatten
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.param import params_from_jax, state_from_jax
from repro_torch.runtime import Trainer
from repro_torch.runtime import step as pstep
from repro_torch.sharding import strip_layer_dim, tree_fsdp_dims
from test_torch_audio import jbatch, pbatch, stubs, tokens

FAMILIES = {"ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
            "moe": "phi3.5-moe-42b-a6.6b", "audio": "whisper-medium",
            "vlm": "pixtral-12b"}
LOSS_TOL = 1e-5
GRAD_TOL = {"ssm": 5e-4, "hybrid": 5e-4, "moe": 1e-4, "audio": 1e-4, "vlm": 1e-4}
STEP_TOL = 2e-3
B, S = 2, 24


def _f32_pair(arch: str, **over):
    """(JAX model, port model, f32 JAX params, port params) at smoke size."""
    jcfg = replace(j_smoke_config(j_get_config(arch)), **over)
    pcfg = replace(smoke_config(get_config(arch)), **over)
    jm, pm = j_build_model(jcfg), build_model(pcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), j_tree_init(jm.param_defs(), 0))
    return jm, pm, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    top = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= tol * top, f"{what}: max err {err} > {tol} * {top}"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    jm, pm, jp, pp = _f32_pair(FAMILIES[family], remat=True)
    toks, st = tokens(pm.cfg.vocab_size, S + 1, seed=17), stubs(pm.cfg, seed=5)
    jb = jbatch(toks, st)
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(jp)
    leaves, td = flatten(pp)
    for t in leaves:
        t.requires_grad_(True)
    pl, pmet = pm.loss(pp, pbatch(toks, st))
    pl.backward()
    assert float(pmet["tokens"]) == float(jmet["tokens"]) == B * S
    _close(pl, jl, LOSS_TOL, "loss")
    _close(pmet["aux_loss"], jmet["aux_loss"], LOSS_TOL, "aux_loss")
    if family == "moe":
        assert float(pmet["aux_loss"].detach()) > 0
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(leaves)
    for (path, want), got in zip(jleaves, leaves):
        assert got.grad is not None and got.grad.dtype == torch.float32, path
        _close(got.grad, want, GRAD_TOL[family], f"{family} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("shard", [1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunk_plan_matches_reference(family, shard):
    """The plan of the cross-pod sync over 2 pods: f32 gradients, under ZeRO
    (`shard` 2) each scattered leaf a half, the families' ``ssm_heads``,
    ``d_inner``, ``conv_ch``, ``experts`` and encoder leaves included."""
    arch = FAMILIES[family]
    jdefs = j_build_model(j_smoke_config(j_get_config(arch))).param_defs()
    pdefs = build_model(smoke_config(get_config(arch))).param_defs()
    kw = dict(mode="hierarchical", streams=4, chunk_mb=0.001, autotune=False)
    jpath = JWidePath(axis="pod", comm=JCommConfig(**kw), link=J_INTERPOD, name="train")
    ppath = WidePath(axis="pod", comm=CommConfig(**kw), link=INTERPOD, name="train")
    jstep._note_path_plan(jdefs, j_tree_fsdp_dims(jdefs, shard, 1), jpath, shard, 2)
    pstep._note_path_plan(pdefs, tree_fsdp_dims(pdefs, shard, 1), ppath, shard, 2)
    want = asdict(jtel.get_telemetry().path(jpath.key).plan)
    got = ptel.get_telemetry().path(ppath.key).plan.__dict__
    assert got == want
    assert want["n_chunks"] > len(flatten(pdefs)[0]) // 2


# ---------------------------------------------------------------------------
# the step with microbatches: every leaf of the batch split along rows
# ---------------------------------------------------------------------------

def _rc(pkg, arch: str, micro: int):
    cfg_mod = (get_config, smoke_config, RunConfig, ShapeConfig, CommConfig,
               TrainConfig) if pkg == "port" else (
        j_get_config, j_smoke_config, JRunConfig, JShapeConfig, JCommConfig,
        JTrainConfig)
    gc, sc, R, Sh, C, T = cfg_mod
    return R(model=sc(gc(arch)), shape=Sh("t", S, 4, "train"),
             comm=C(mode="hierarchical", streams=4, chunk_mb=0.001, autotune=False),
             train=T(microbatches=micro, warmup_steps=1, total_steps=10, lr=1e-3))


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_microbatches_split_every_leaf_like_reference(family):
    """`build_train_step` with 2 microbatches on one rank: each microbatch
    takes its rows of the stub inputs with its rows of the tokens.  Two steps
    from the reference's state on the same numpy batches."""
    arch = FAMILIES[family]
    jrc, prc = _rc("jax", arch, 2), _rc("port", arch, 2)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    rng = np.random.default_rng(23)
    batches = [(rng.integers(0, 256, size=(4, S + 1)), stubs(prc.model, seed=31 + i, rows=4))
               for i in range(2)]
    with jax.set_mesh(mesh):
        jb = jstep.build_train_step(jrc, mesh)
        jstate, want = jb.init_state(0), []
        state0 = jax.tree.map(np.asarray, jstate)   # the step donates its state
        for toks, st in batches:
            jstate, m = jb.fn(jstate, jbatch(toks, st, "bfloat16"))
            want.append([float(m[k]) for k in ("loss", "grad_norm", "aux_loss")])
    pb = pstep.build_train_step(prc, make_local_mesh(pod=1, device="cpu"))
    pstate, got = state_from_jax(state0, "cpu"), []
    for toks, st in batches:
        pstate, m = pb.fn(pstate, pbatch(toks, st, "bfloat16"))
        got.append([float(m[k]) for k in ("loss", "grad_norm", "aux_loss")])
    for (gl, gn, ga), (wl, wn, wa) in zip(got, want):
        assert abs(gl - wl) <= STEP_TOL, (got, want)
        assert abs(gn - wn) <= STEP_TOL * wn, (got, want)
        assert abs(ga - wa) <= STEP_TOL, (got, want)


def test_split_microbatches_refuses_a_ragged_leaf():
    batch = {"tokens": torch.zeros(4, 9, dtype=torch.int64),
             "patch_embeds": torch.zeros(3, 2, 8)}
    with pytest.raises(ValueError, match="patch_embeds"):
        pstep.split_microbatches(batch, 2)
    parts = pstep.split_microbatches({"tokens": torch.arange(8).reshape(4, 2),
                                      "x": torch.arange(4.0)}, 2)
    assert [p["x"].tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0]]
    assert [p["tokens"][:, 0].tolist() for p in parts] == [[0, 2], [4, 6]]


def test_step_reports_aux_loss_zero_off_the_moe_family():
    b = pstep.build_train_step(_rc("port", FAMILIES["ssm"], 1),
                               make_local_mesh(pod=1, device="cpu"))
    state = b.init_state(0)
    _, m = b.fn(state, {"tokens": torch.as_tensor(tokens(256, S + 1, rows=4))})
    assert isinstance(m["aux_loss"], torch.Tensor) and float(m["aux_loss"]) == 0.0


# ---------------------------------------------------------------------------
# ZeRO's gather tables
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for ``AllGatherAtUse``: records each gathered leaf's shape
    and dim and returns it as it is (the test's "shards" are whole leaves)."""
    seen: list = []

    @classmethod
    def apply(cls, x, d, group, stats):
        cls.seen.append((tuple(x.shape), d))
        return x


def test_gather_tables_match_layers_by_structure(monkeypatch):
    """whisper-medium's smoke config under a 2-rank data group: the encoder's
    layers gathered one by one by the encoder's table, inside their
    checkpoint (again in its recompute), the decoder's by the blocks' table,
    and at the top only the embedding, the final norms and nothing else of
    the encoder.  An unknown layer structure raises naming it."""
    monkeypatch.setattr(pstep, "AllGatherAtUse", _Recorder)
    _Recorder.seen = []
    cfg = replace(smoke_config(get_config(FAMILIES["audio"])), remat=True)
    model = build_model(cfg)
    defs = model.param_defs()
    dims = tree_fsdp_dims(defs, 2, 1)
    gather_layer, gather_top = pstep._make_gather(defs, dims, True, object())
    params = params_from_jax(jax.tree.map(np.asarray, j_tree_init(
        j_build_model(j_smoke_config(j_get_config(FAMILIES["audio"]))).param_defs(), 0)), "cpu")
    top = gather_top(params)
    enc_dims = {k: v for k, v in dims["encoder"].items() if k != "ln_f"}
    want_top = [(tuple(params[k].shape), dims[k]) for k in sorted(params)
                if k not in ("blocks", "encoder")]
    want_top.insert(0, (tuple(params["encoder"]["ln_f"].shape), dims["encoder"]["ln_f"]))
    assert sorted(_Recorder.seen) == sorted(want_top)
    assert top["encoder"]["attn"] is params["encoder"]["attn"]
    _Recorder.seen = []
    leaves, td = flatten(top)
    for t in leaves:
        t.requires_grad_(True)
    toks, st = tokens(cfg.vocab_size, S + 1), stubs(cfg)
    loss, _ = model.loss(top, pbatch(toks, st, "bfloat16"), gather=gather_layer)
    n_fwd = len(_Recorder.seen)
    loss.backward()
    enc_layer = [(tuple(s[1:]), d) for s, d in zip(
        [p.shape for p in flatten({k: params["encoder"][k] for k in enc_dims})[0]],
        flatten(strip_layer_dim(enc_dims))[0]) if d is not None]
    dec_layer = [(tuple(p.shape[1:]), d) for p, d in zip(
        flatten(params["blocks"])[0], flatten(strip_layer_dim(dims["blocks"]))[0])
        if d is not None]
    want_fwd = enc_layer * cfg.encoder_layers + dec_layer * cfg.num_layers
    assert _Recorder.seen[:n_fwd] == want_fwd
    # the checkpoints' recomputes gather every layer again, in the backward
    assert sorted(_Recorder.seen[n_fwd:]) == sorted(want_fwd)
    with pytest.raises(ValueError, match="unknown layer structure"):
        gather_layer({"wq": params["blocks"]["attn"]["wq"][0]})


# ---------------------------------------------------------------------------
# the Trainer's batches
# ---------------------------------------------------------------------------

def test_trainer_places_every_key_of_a_dict_batch():
    """Rank (pod 1, data 0) of 2 x 2 takes rows [4, 6) of a global batch of
    8 in every leaf; the token ids become int64, the stubs keep their dtype
    (f32, ml_dtypes' bf16, a tensor's); a leaf of other rows raises."""
    fake = SimpleNamespace(mesh=SimpleNamespace(pod=2, data=2, pod_index=1, data_index=0),
                           bundle=SimpleNamespace(device=torch.device("cpu")))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, size=(8, 5)).astype(np.int32)
    frames = rng.standard_normal((8, 3, 4)).astype(np.float32)
    patches = frames.astype(ml_dtypes.bfloat16)
    extra = torch.arange(8 * 2, dtype=torch.float16).reshape(8, 2)
    got = Trainer._place_batch(fake, {"tokens": toks, "source_frames": frames,
                                      "patch_embeds": patches, "extra": extra})
    assert got["tokens"].dtype == torch.int64
    assert got["tokens"].tolist() == toks[4:6].tolist()
    assert got["source_frames"].dtype == torch.float32
    assert np.array_equal(got["source_frames"].numpy(), frames[4:6])
    assert got["patch_embeds"].dtype == torch.bfloat16
    assert np.array_equal(got["patch_embeds"].float().numpy(),
                          patches[4:6].astype(np.float32))
    assert got["extra"].dtype == torch.float16 and torch.equal(got["extra"], extra[4:6])
    assert Trainer._place_batch(fake, toks)["tokens"].tolist() == toks[4:6].tolist()
    with pytest.raises(ValueError, match="source_frames"):
        Trainer._place_batch(fake, {"tokens": toks, "source_frames": frames[:6]})


def test_trainer_trains_the_vlm_family_on_dict_batches():
    """The Trainer on pixtral-12b's smoke config, one rank, two steps of
    dict batches: ``model.loss`` sees the patch embeddings, and the losses
    are ``build_train_step``'s on the same rows from the same state."""
    rc = _rc("port", FAMILIES["vlm"], 1)
    mesh = make_local_mesh(pod=1, device="cpu")
    tr = Trainer(rc, mesh)
    tr.init_or_restore(0)
    seen = []
    loss_fn = tr.bundle.model.loss

    def spy(params, batch, **kw):
        seen.append({k: (tuple(v.shape), v.dtype) for k, v in batch.items()})
        return loss_fn(params, batch, **kw)
    tr.bundle.model.loss = spy
    rng = np.random.default_rng(41)
    batches = [{"tokens": rng.integers(0, 256, size=(4, S + 1)).astype(np.int32),
                "patch_embeds": rng.standard_normal((4, 16, 128)).astype(ml_dtypes.bfloat16)}
               for _ in range(2)]
    ref = pstep.build_train_step(rc, mesh)
    state = ref.init_state(0)
    tr.run(iter(batches), 2, log=lambda *_: None)
    want = []
    for b in batches:
        state, m = ref.fn(state, {"tokens": torch.as_tensor(b["tokens"], dtype=torch.int64),
                                  "patch_embeds": torch.from_numpy(
                                      b["patch_embeds"].view(np.uint16).copy()).view(torch.bfloat16)})
        want.append(float(m["loss"]))
    assert seen[:2] == [{"tokens": ((4, S + 1), torch.int64),
                         "patch_embeds": ((4, 16, 128), torch.bfloat16)}] * 2
    assert [h["loss"] for h in tr.history] == want
    tr.close()


# ---------------------------------------------------------------------------
# the step's AdamW: donated moments, updated a piece at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adamw_sliced_donated_update_is_bit_identical(monkeypatch, dtype):
    """A leaf updated in pieces (here of 96 elements) gives the bits of its
    update in one piece, for 3 steps, leaves of one and of many pieces and a
    0-d leaf, whole and bucket by bucket; the new moments are written into
    the tensors the first step was given."""
    from repro_torch.core.buckets import plan_buckets
    from repro_torch.core.tree import flatten
    from repro_torch.optim import adamw, init_opt_state
    g = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(37, 11, generator=g).to(dtype),
              "b": torch.randn(7, generator=g).to(dtype), "c": torch.tensor(0.5)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in params.items()}
             for _ in range(3)]
    tc = TrainConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    lr = torch.tensor(2e-3)

    def run(**kw):
        p, opt = params, init_opt_state(params)
        firsts = (opt["m"]["a"], opt["v"]["a"])
        for gr in grads:
            p, opt, st = adamw.adamw_update(gr, opt, p, tc, lr, **kw)
        return p, opt, st, firsts
    want_p, want_o, want_s, _ = run()        # every leaf a piece of its own
    monkeypatch.setattr(adamw, "UPDATE_SLICE", 96)
    flags = [True, False, False]             # "a" stacked: 37 layers of 11
    plan = plan_buckets(flatten(params)[0], flags,
                        bucket_bytes=8 * 11 * params["a"].element_size())
    assert len(plan.layer_buckets) >= 3
    for kw in ({}, {"buckets": plan, "stacked": flags}):
        got_p, got_o, got_s, firsts = run(**kw)
        assert torch.equal(got_s["grad_norm"], want_s["grad_norm"])
        for k in params:
            assert torch.equal(got_p[k], want_p[k]) and got_p[k].dtype == params[k].dtype
            assert torch.equal(got_o["m"][k], want_o["m"][k])
            assert torch.equal(got_o["v"][k], want_o["v"][k])
        # the moments live on in the tensors the first step was given
        assert got_o["m"]["a"] is firsts[0] and got_o["v"]["a"] is firsts[1]
