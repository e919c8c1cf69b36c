"""Local-SGD over the WAN: K site-local steps, one cross-site delta sync.

The port of the JAX package's ``core/localsgd.py``.  Every site takes ``K``
optimizer steps whose gradient sync stays inside the site
(:func:`~repro_torch.core.collectives.local_site_allreduce`), then the
sites reconcile by shipping one **model delta** across the WAN:

    merged = anchor + mean_over_member_sites(params_site - anchor)

where `anchor` is the parameters at the previous reconciliation.  The
delta crosses the wire through the same machinery as a gradient sync
(:func:`~repro_torch.core.collectives.streamed_psum` over the membership's
gateway subgroup: ring/int8/chunking/streams/pacing all apply).

Elasticity: the member set comes from
:class:`~repro_torch.core.membership.SiteMembership` at the current epoch.
Non-member pods contribute zero to, and take nothing from, the merge; an
evicted site's parameters stay where they were, and :func:`catchup` later
clones a survivor's onto it when it rejoins.  K = 1 is the synchronous path
(the Trainer builds no delta sync for it).

The reference runs these inside its shard_map; here every rank of the pod
group calls them with its own tensors, members or not: each collective is
posted by every rank of the group it runs on, non-members posting zeros
as the reference's masked sums do.  :class:`LocalSGDController`,
:func:`reference_delta_merge` and :func:`reference_wan_bytes` are copies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compress as comp
from repro_torch.core.collectives import psum_group, streamed_psum
from repro_torch.core.path import WidePath
from repro_torch.core.tree import flatten, unflatten


class LocalSGDController:
    """The K-step cadence: which steps are sync steps.

    Steps are 0-based; with ``k=4`` the sync lands on steps 3, 7, 11, ...
    — i.e. *after* every K-th local step, so a run of N = m*K steps does
    exactly m reconciliations.  ``k <= 1`` means every step syncs (the
    synchronous path; the Trainer never builds a delta-sync for it).
    """

    def __init__(self, k: int = 1) -> None:
        self.k = max(1, int(k))

    @property
    def enabled(self) -> bool:
        return self.k > 1

    def is_sync_step(self, step: int) -> bool:
        return self.k <= 1 or (step + 1) % self.k == 0


def delta_sync(params, anchor, path: WidePath, mesh, *, dims=None,
               site_groups=None, member_pods=None, member_gateways=None):
    """One cross-site reconciliation on this rank's `params` (under ZeRO its
    shards, `dims` their scatter dims), against `anchor` (the same layout).

    Stages, as the reference's:

      1. the f32 delta against the anchor, zero unless this pod is a member
         gateway (each member site's pods hold the same parameters after K
         local steps, so the gateway's delta is the site's);
      2. :func:`streamed_psum` of the masked deltas with
         ``subgroup=member_gateways``, the WAN exchange on the path's knobs,
         its plan under ``{key}/delta``;
      3. masked to the member gateways again (a ring leaves the values of
         ranks outside the subgroup as they were) and summed within each
         site over its site group (``PodMesh.site_group``), which hands each
         site's gateway value to its pods;
      4. ``anchor + sum / n`` on member pods only, cast back to the
         parameter's dtype; the other pods keep their parameters.

    Without a pod axis the parameters come back as they are."""
    if mesh is None or mesh.pod_group is None:
        return params
    groups = [list(g) for g in site_groups]
    gw = [int(g) for g in member_gateways]
    n = len(gw)
    pod = mesh.pod_index
    is_m = pod in {int(p) for p in member_pods}
    is_gw = pod in gw
    p_leaves, td = flatten(params)
    a_leaves = flatten(anchor)[0]
    masked = [(p.float() - a.float()) if is_gw else torch.zeros_like(p, dtype=torch.float32)
              for p, a in zip(p_leaves, a_leaves)]
    exchanged = flatten(streamed_psum(unflatten(td, masked), path, mesh, dims=dims,
                                      subgroup=gw, tel_key=f"{path.key}/delta"))[0]
    del masked
    site = mesh.site_group(groups)
    out = []
    for i, (p, a) in enumerate(zip(p_leaves, a_leaves)):
        d, exchanged[i] = exchanged[i], None     # one leaf's f32 at a time
        s = psum_group(d if is_gw else torch.zeros_like(d), site)
        out.append((a.float() + s / n).to(p.dtype) if is_m else p)
    return unflatten(td, out) if is_m else params


def catchup(params, mesh, *, source_pod: int, target_pods):
    """Clone a survivor's parameters onto rejoining pods.

    The rejoined site missed every reconciliation while evicted; before it
    can contribute a delta it must share the survivors' anchor.  As in the
    reference: this rank's parameters in f32 where it is `source_pod` (a
    surviving gateway), zeros elsewhere, summed over the pod group, and the
    sum adopted on `target_pods` only.  A masked sum and not a broadcast:
    the sum turns a source ``-0.0`` into ``+0.0``, as the reference's does.
    One value and zeros sum to the same bits in any order, so the sum is
    the group's all-reduce, every leaf's issued before the first is waited
    for.  Every other pod's parameters pass through untouched."""
    if mesh is None or mesh.pod_group is None:
        return params
    pod = mesh.pod_index
    is_src = pod == int(source_pod)
    is_tgt = pod in {int(p) for p in target_pods}
    leaves, td = flatten(params)
    pending = [comp.psum_start(p.float() if is_src
                               else torch.zeros_like(p, dtype=torch.float32),
                               mesh.pod_group) for p in leaves]
    out = []
    for p, w in zip(leaves, pending):
        bcast = w.finish()
        out.append(bcast.to(p.dtype) if is_tgt else p)
    return unflatten(td, out)


# ---------------------------------------------------------------------------
# numpy reference twins (the property-test spec)
# ---------------------------------------------------------------------------

def reference_delta_merge(anchor, site_params, members):
    """What one reconciliation does, per site, in plain numpy.

    `site_params` maps site name -> params array; `members` is the live
    member list.  Returns the post-sync params per site: members get
    ``anchor + mean(member deltas)``, non-members keep their own.
    """
    deltas = [np.asarray(site_params[m], np.float32) - np.asarray(anchor, np.float32)
              for m in members]
    merged = np.asarray(anchor, np.float32) + np.mean(deltas, axis=0)
    return {s: (merged if s in members else np.asarray(p))
            for s, p in site_params.items()}


def reference_wan_bytes(n_params: int, steps: int, k: int, n_sites: int,
                        bytes_per_el: int = 4) -> int:
    """Modeled cross-site WAN bytes of a run: one gateway-subgroup
    exchange of the full model every K steps (ring: ~2 passes of the
    payload per member), versus every step when k=1."""
    syncs = steps // max(1, k)
    per_sync = 2 * (n_sites - 1) / max(1, n_sites) * n_params * bytes_per_el
    return int(syncs * per_sync)
