"""Train and serve step builders.

The port of the JAX package's ``runtime/step.py``.  PyTorch runs eagerly, so
a bundle's ``fn`` is plain Python over the model and the collectives, not a
jitted shard_map.

* :func:`build_train_step`: one data-parallel training step across pods on a
  :class:`repro_torch.launch.mesh.PodMesh` (one rank per pod, one data rank,
  no tensor parallelism), modes ``flat`` and ``hierarchical``, in the
  reference's sequence: f32 gradients after the backward, ``accum_grads``
  with the WidePath sync, division by the data-parallel world, ``lr_at``,
  ``adamw_update``, and the loss averaged over the pod group.  ZeRO needs
  ``data > 1`` and is off; buckets, routes, site groups and local SGD are
  queued (ROADMAP.md queue A).
* :func:`build_serve_step`: prefill / decode on one device, under
  ``torch.inference_mode()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import RunConfig
from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import autotune_path
from repro_torch.core.collectives import queued, wide_allreduce
from repro_torch.core.overlap import accum_grads, modeled_exposure
from repro_torch.core.path import INTERPOD, WidePath
from repro_torch.core.tree import flatten, tree_map, unflatten
from repro_torch.launch.roofline import modeled_compute_window
from repro_torch.models import build_model
from repro_torch.models.param import leaf_bytes_pd, tree_fsdp_dims, tree_init
from repro_torch.optim import adamw_update, init_opt_state, lr_at


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises here,
    with a clear message, instead of deep inside the first kernel."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but PyTorch sees no CUDA device "
            f"(torch {torch.__version__}, CUDA build "
            f"{torch.version.cuda}); pass device='cpu' to run the plain "
            f"PyTorch versions of the kernels on the CPU")
    return dev


@dataclass
class StepBundle:
    fn: Callable
    model: object
    param_defs: dict
    path: WidePath
    device: torch.device
    cache_defs: Optional[dict] = None
    mesh: object = None                # train bundles: the PodMesh

    def init_state(self, seed: int = 0) -> dict:
        """Parameters from `seed` and a fresh optimizer state, on the
        bundle's device: the same bits on every rank."""
        params = tree_init(self.param_defs, seed, device=self.device)
        return {"params": params, "opt": init_opt_state(params)}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _param_bytes(defs) -> int:
    return sum(leaf_bytes_pd(pd) for pd in flatten(defs)[0])


def _eff_grad_leaves(defs, dims):
    """(leaves, scatter dims) of the cross-pod gradient payload: f32 on the
    wire, shaped like the parameters (no ZeRO scatter with one data rank),
    as ``meta`` tensors."""
    pds = flatten(defs)[0]
    dim_leaves = flatten(dims)[0]
    leaves = [torch.empty(pd.shape, dtype=torch.float32, device="meta")
              for pd in pds]
    return leaves, [d if (d is not None and len(x.shape)) else None
                    for x, d in zip(leaves, dim_leaves)]


def _note_path_plan(defs, dims, path: WidePath, world: int = 1, *,
                    window: float = 0.0, m_micro: int = 1) -> None:
    """Record the path's static gradient-sync plan into telemetry, as the
    JAX package records it at build time: gradients are f32 on the wire;
    `world` (the pod-axis size) feeds the modeled per-pod wire bytes; the
    modeled exposure against `window` lands in the overlap note."""
    eff_leaves, eff_dims = _eff_grad_leaves(defs, dims)
    chunks = st.plan_chunks(eff_leaves, eff_dims, path.chunk_bytes)
    buckets = st.assign_streams(chunks, path.streams)
    tel.note_plan(path.key, **st.plan_summary(
        chunks, buckets, path.streams, path.chunk_bytes, path.comm.pacing,
        algo=path.comm.algo, world=world, compress=path.comm.compress))
    res = modeled_exposure(
        sum(st.leaf_bytes(x) for x in eff_leaves), path.link,
        streams=path.streams, chunk_bytes=path.chunk_bytes,
        pacing=path.comm.pacing, compute_window=window, bucket_bytes=0,
        microbatches=m_micro, world=max(2, world),
        algo=path.comm.algo, compress=path.comm.compress)
    tel.note_overlap(path.key, res["exposed_s"], res["overlapped_s"])


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def build_train_step(rc: RunConfig, mesh, *, route=None, site_groups=None,
                     local_only: bool = False) -> StepBundle:
    """The training step on `mesh`: ``fn(state, batch) -> (state, metrics)``
    with `batch` this pod's rows ``{"tokens": (B_local, S+1)}`` on the
    mesh's device.  The autotuner's warm start reads the modeled compute
    window at the H100's peak (``launch/roofline.py``).

    Metrics: loss (averaged over the pod group), lr, grad_norm, aux_loss,
    and of the step's gradient sync: sync_s (host clock from a device sync
    to the synced gradients), chunks (the per-chunk log of
    :func:`repro_torch.core.collectives.streamed_psum`), wire_bytes (their
    modeled per-pod link bytes) and sent_bytes."""
    if route is not None:
        raise queued("a multi-hop route", "facade, relays, files, checkpoints")
    if site_groups is not None:
        raise queued("site groups", "gateway mode and site groups")
    if local_only:
        raise queued("local SGD (local_steps > 1)", "topology, chaos and elasticity")
    if rc.comm.mode == "gateway":
        raise queued("the gateway (Forwarder) mode", "gateway mode and site groups")
    if rc.comm.mode not in ("flat", "hierarchical"):
        raise ValueError(f"unknown comm mode {rc.comm.mode!r}")
    dev = resolve_device(mesh.device)
    model = build_model(rc.model)
    defs = model.param_defs()
    # ZeRO needs data > 1, which the mesh refuses: every leaf is replicated
    # in the pod, and these scatter dims only cut the cross-pod chunks
    dims = tree_fsdp_dims(defs, mesh.data, mesh.model)

    path = WidePath(axis="pod", comm=rc.comm, link=INTERPOD, name="train")
    tc = rc.train
    m_micro = max(1, tc.microbatches)
    pod_world = mesh.pod
    window = modeled_compute_window(rc.model, rc.shape, n_chips=mesh.n_ranks,
                                    microbatches=m_micro)
    path = autotune_path(path, _param_bytes(defs), world=pod_world,
                         compute_window=window)
    if rc.comm.mode != "flat":
        _note_path_plan(defs, dims, path, pod_world, window=window,
                        m_micro=m_micro)
    dp_world = mesh.pod * mesh.data

    def grad_fn(params, mb):
        leaves, td = flatten(params)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = model.loss(unflatten(td, ps), mb)
        grads = torch.autograd.grad(loss, ps)
        # f32 gradients from here on, as in the reference: f32 accumulation
        # and an f32 wire for every comm mode
        return (loss.detach(), _detached(metrics)), unflatten(
            td, [g.float() for g in grads])

    def fn(state: dict, batch: dict):
        params = state["params"]
        tokens = batch["tokens"]
        if tokens.shape[0] % m_micro:
            raise ValueError(f"local batch {tokens.shape[0]} does not split "
                             f"into {m_micro} microbatches")
        mbs = [{**batch, "tokens": t} for t in tokens.chunk(m_micro, dim=0)]
        log: list = []
        sync_s = [0.0]

        def sync(grads):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = wide_allreduce(grads, path, mesh, dims=dims, log=log)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            sync_s[0] += time.perf_counter() - t0
            return out

        loss, metrics, grads = accum_grads(grad_fn, params, mbs, sync=sync,
                                           overlap=m_micro > 1)
        grads = tree_map(lambda g: g.div_(dp_world), grads)
        lr = lr_at(state["opt"]["step"], tc, device=dev)
        new_params, new_opt, stats = adamw_update(grads, state["opt"], params,
                                                  tc, lr)
        if mesh.pod_group is not None:
            lh = loss.detach().float().reshape(1).cpu()
            dist.all_reduce(lh, op=dist.ReduceOp.SUM, group=mesh.pod_group)
            loss = (lh / dp_world).reshape(()).to(dev)
        out = {"loss": loss, "lr": lr, **stats,
               "aux_loss": metrics.get("aux_loss"),
               "sync_s": sync_s[0], "chunks": log,
               "wire_bytes": sum(c["wire_bytes"] for c in log),
               "sent_bytes": sum(c["sent_bytes"] for c in log)}
        return {"params": new_params, "opt": new_opt}, out

    return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                      device=dev, mesh=mesh)


def build_serve_step(rc: RunConfig, kind: Optional[str] = None, *,
                     device="cuda") -> StepBundle:
    """kind: "decode" (one token per row against a ``(B, seq_len)`` cache:
    ``fn(params, cache, pos, tokens) -> (logits, cache)``, the cache updated
    in place) or "prefill" (``fn(params, {"tokens": (B, S)}) -> (logits,
    cache)``)."""
    kind = kind or rc.shape.kind
    dev = resolve_device(device)
    model = build_model(rc.model)
    defs = model.param_defs()
    path = WidePath(axis="pod", comm=rc.comm, name="serve")
    if kind == "decode":
        fn = torch.inference_mode()(model.decode_step)
        return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                          device=dev,
                          cache_defs=model.cache_defs(rc.shape.global_batch,
                                                      rc.shape.seq_len))
    if kind != "prefill":
        raise ValueError(f"serve step kind must be 'decode' or 'prefill', "
                         f"got {kind!r}")
    fn = torch.inference_mode()(model.prefill)
    return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                      device=dev)
