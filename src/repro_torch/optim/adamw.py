"""Functional AdamW with global-norm clipping: the port of the JAX package's
``optim/adamw.py``.

The update keeps the reference's order of operations and roundings: bias
correction by division, the weight decay inside ``delta``, the parameter
updated in f32 and rounded to its own dtype (``torch.optim.AdamW``'s
decoupled decay is another sequence of roundings, and is not used).  State
is a plain tree: ``{"m", "v"}`` in f32 shaped like the parameters, and
``step`` a 0-d int32 tensor.  Under ZeRO the gradients, parameters and
moments are shards over the data axis: the global norm sums the scattered
leaves' squares over the data-parallel group and the replicated ones
locally, as the reference does.

With ``buckets=`` (a :class:`repro_torch.core.buckets.BucketPlan` and the
stacked flags it was planned with) the update is applied bucket by bucket
over layer-range slices and concatenated back: the math is elementwise, so
the bucketed update is bit-identical to the fused one.

Each leaf (or bucket slice) is updated in pieces of at most UPDATE_SLICE
elements of the flattened leaf, which bounds the f32 temporaries of its
update (a (131072, 5120) embedding's would be 2.7 GB each), and the new
moments are written into the old ones: the update consumes `opt_state`, as
the reference's train step donates its state to ``jax.jit`` (a caller that
still needs the old moments passes a copy).  Neither changes a bit of the
result.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.buckets import bucket_indices, slice_leaf
from repro_torch.core.collectives import psum_group
from repro_torch.core.tree import flatten, tree_map, unflatten


def init_opt_state(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = flatten(params)[0][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _flat_dims(dims, n: int) -> list:
    if dims is None:
        return [None] * n
    return dims if isinstance(dims, list) else flatten(dims)[0]


def global_norm(grads, dims=None, group=None, tp_dims=None,
                tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  `dims` (a tree
    beside `grads`, or a flat list) marks the scattered leaves (a dim) and
    the replicated ones (None); `group` is the data-parallel group the
    scattered leaves' sum is taken over (rank order), as the reference's
    psum over ``data_axes``.  Each part is summed in leaf order.

    Under the reference's ZeRO the data-parallel axes are ("pod", "data"):
    after the cross-pod sync every pod holds the same shard, so each
    scattered leaf is counted once per pod (ROADMAP.md §C 6); the port
    computes the same number.

    With tensor parallelism `tp_dims` marks the leaves that are blocks of
    a leaf sharded over the model group `tp_group` (a dim) and those whole
    on every model rank (None): a sharded leaf's squares are summed over the
    model group first, so each model rank gets the reference's norm of the
    whole leaves, the replicated ones counted once."""
    leaves = flatten(grads)[0]
    dim_list = _flat_dims(dims, len(leaves))
    tp_list = _flat_dims(tp_dims if tp_group is not None else None, len(leaves))
    dev = leaves[0].device
    zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
    # [scattered, replicated] sums, of the model-sharded leaves and the rest
    sums = {True: [zero(), zero()], False: [zero(), zero()]}
    for g, d, t in zip(leaves, dim_list, tp_list):
        s = torch.sum(torch.square(g.float()))
        part = sums[t is not None]
        if d is not None and group is not None:
            part[0] = part[0] + s
        else:
            part[1] = part[1] + s
    if tp_group is not None:
        sums[True] = [psum_group(x.reshape(1), tp_group).reshape(()) for x in sums[True]]
    scat = sums[True][0] + sums[False][0]
    repl = sums[True][1] + sums[False][1]
    if group is not None:
        scat = psum_group(scat, group)
    return torch.sqrt(scat + repl)


# elements of a leaf updated at once (see the module docstring)
UPDATE_SLICE = 1 << 24


def adamw_update(grads, opt_state: dict, params, tc: TrainConfig,
                 lr: torch.Tensor, *, dims=None, group=None, buckets=None,
                 stacked=None, tp_dims=None, tp_group=None):
    """One AdamW step.  Returns (new_params, new_opt_state, stats).  `dims`
    and `group` go to :func:`global_norm` (ZeRO: the shards' dims and the
    data-parallel group; `tp_dims` and `tp_group` the model axis's).
    `buckets` (a ``BucketPlan``) with `stacked` (the
    per-leaf flags it was planned with, a flat list or a tree beside the
    parameters) applies the update bucket by bucket.  The new moments are
    written into `opt_state`'s tensors where they are contiguous (see the
    module docstring)."""
    if buckets is not None and stacked is None:
        raise ValueError("adamw_update: buckets= needs the stacked flags the "
                         "plan was built with (stacked=None)")
    step = opt_state["step"] + 1
    norm = global_norm(grads, dims, group, tp_dims, tp_group)
    if tc.grad_clip:
        scale = torch.clamp(tc.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=norm.device)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(sf, b1), sf)
    c2 = 1.0 - torch.pow(torch.full_like(sf, b2), sf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + tc.weight_decay * p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    lp, td = flatten(params)
    args = list(zip(lp, flatten(grads)[0], flatten(opt_state["m"])[0],
                    flatten(opt_state["v"])[0]))
    if buckets is not None and buckets.buckets:
        out = _bucketed_apply(upd, args, buckets, stacked)
    else:
        out = [_sliced_apply(upd, *a) for a in args]
    return (unflatten(td, [o[0] for o in out]),
            {"m": unflatten(td, [o[1] for o in out]),
             "v": unflatten(td, [o[2] for o in out]), "step": step},
            {"grad_norm": norm})


def _targets(p, m, v) -> tuple:
    """Where a leaf's update goes: a new parameter tensor, and the moments
    into `m` and `v` themselves (the consumed state) where they are
    contiguous, into new tensors otherwise."""
    new = lambda t: torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return (new(p), m if m.is_contiguous() else new(m),
            v if v.is_contiguous() else new(v))


def _sliced_apply(upd, p, g, m, v, out=None) -> tuple:
    """upd(p, g, m, v) -> (p, m, v) over pieces of at most UPDATE_SLICE
    elements of the flattened leaf, written into `out` (contiguous
    (p, m, v) of the leaf's shapes; :func:`_targets` when None)."""
    out = out or _targets(p, m, v)
    src = [t.reshape(-1) for t in (p, g, m, v)]
    dst = [t.view(-1) for t in out]
    for i in range(0, src[0].numel(), UPDATE_SLICE):
        sl = slice(i, i + UPDATE_SLICE)
        for d, r in zip(dst, upd(*(t[sl] for t in src))):
            d[sl] = r
    return out


def _bucketed_apply(upd, args: list, plan, stacked) -> list:
    """Apply a leafwise (p, g, m, v) -> (p, m, v) update bucket by bucket:
    stacked leaves per layer-range slice, each slice written into its rows
    of the leaf's targets (the slices tile the layers dim), rest-bucket
    leaves whole; a leaf in no bucket keeps its parameter and moments, as
    in the reference."""
    flags = stacked if isinstance(stacked, list) else flatten(stacked)[0]
    out: list = [(p, m, v) for p, _, m, v in args]
    for b in plan.buckets:
        for i in bucket_indices(flags, b):
            if b.is_rest:
                out[i] = _sliced_apply(upd, *args[i])
                continue
            p, _, m, v = args[i]
            if out[i][0] is p:           # the leaf's first slice
                out[i] = _targets(p, m, v)
            _sliced_apply(upd, *[slice_leaf(t, b.lo, b.hi) for t in args[i]],
                          out=tuple(slice_leaf(t, b.lo, b.hi) for t in out[i]))
    return out
