"""The mesh of the port: ``torch.distributed`` process groups in place of the
JAX package's device mesh (``launch/mesh.py``).

A :class:`PodMesh` has the axis sizes ``pod``, ``data`` and ``model`` and
lays its ranks out as ``jax.make_mesh((pod, data, model), ...)`` does,
row-major with the model axis innermost:
``rank = (pod_index * data + data_index) * model + model_index``.  Each rank
holds the groups of its axes:

* the model group, the ``model`` ranks of its (pod, data) coordinate (tensor
  and expert parallelism: the Megatron-style all-reduces, the vocab-parallel
  embedding and cross-entropy, the MoE all-to-alls);
* the data group, the ranks of its pod with its model index (the in-pod
  axis: ZeRO's gathers and reduce-scatters, the in-pod stages of the
  hierarchical and gateway modes);
* the pod group, the ranks of its data and model index, one per pod (the
  WAN axis);
* the world group, every rank of its model index (the flat mode, the loss
  average; with ``model`` 1 every rank);
* once asked for, one process group per WidePath stream over its pod group;
* once asked for, with site groups (``core/topology.py``
  ``Topology.pod_groups``), the group over the pods of its site (the
  intra-site stage of :func:`repro_torch.core.collectives.site_allreduce`).

Every data-parallel group is formed per model index: a rank's data-parallel
peers hold the same tensor-parallel shard.

Every group is created on every rank in one fixed order, once per mesh,
never per step: ``dist.new_group`` is collective over the whole world, so a
rank also creates the groups it is not a member of.  The groups use gloo:
the card's tensors cross through host memory, where MPWide's WAN sockets
carry them too, and gloo, unlike NCCL, can put several ranks on one card.
NCCL groups across cards are queued (ROADMAP.md queue A, 'tensor
parallelism and the production meshes').
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

BACKEND = "gloo"


@dataclass
class PodMesh:
    pod: int
    data: int
    model: int
    rank: int
    device: torch.device
    pod_group: Optional[object] = None       # this data index's pods; None with one pod
    data_group: Optional[object] = None      # this pod's data ranks; None with one
    world_group: Optional[object] = None     # every rank of this model index; None with one
    model_group: Optional[object] = None     # this coordinate's model ranks; None with one
    timeout: Optional[timedelta] = None      # of every group; None: gloo's default
    _streams: list = field(default_factory=list, repr=False)
    _sites: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return {"pod": self.pod, "data": self.data, "model": self.model}

    @property
    def pod_index(self) -> int:
        return self.rank // (self.data * self.model)

    @property
    def data_index(self) -> int:
        return (self.rank // self.model) % self.data

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def n_ranks(self) -> int:
        return self.pod * self.data * self.model

    def rank_of(self, p: int, d: int, m: Optional[int] = None) -> int:
        """The rank at (pod `p`, data `d`, model `m`; this rank's model index
        when `m` is None)."""
        return (p * self.data + d) * self.model + (self.model_index if m is None else m)

    def pod_ranks(self, d: int) -> list[int]:
        """The ranks of data index `d` and this rank's model index, one per
        pod, in pod order."""
        return [self.rank_of(p, d) for p in range(self.pod)]

    def model_ranks(self) -> list[int]:
        """The ranks of this rank's (pod, data) coordinate, in model order."""
        return [self.rank_of(self.pod_index, self.data_index, m)
                for m in range(self.model)]

    def group_of(self, axes) -> Optional[object]:
        """The process group over `axes` (a subset of ("pod", "data")) among
        the ranks of this model index, or None when those axes hold one
        rank."""
        axes = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        if not axes:
            return None
        if set(axes) == {"pod", "data"}:
            return self.world_group
        return self.pod_group if axes == ("pod",) else self.data_group

    @property
    def n_streams(self) -> int:
        """The stream groups created so far (each data index's)."""
        return len(self._streams)

    def stream_groups(self, n: int) -> list:
        """This data index's first `n` stream groups over its pod group,
        created the first time they are asked for.  Every rank runs the same
        sync plan, so every rank asks for the same counts in the same order;
        each new stream creates one group per data index, in index order."""
        if self.pod_group is None:
            return []
        while len(self._streams) < n:
            for m in range(self.model):
                for d in range(self.data):
                    g = self._new_group([self.rank_of(p, d, m)
                                         for p in range(self.pod)])
                    if (d, m) == (self.data_index, self.model_index):
                        self._streams.append(g)
        return self._streams[:n]

    def site_group(self, site_groups) -> Optional[object]:
        """This rank's group over the pods of its site (`site_groups`: lists
        of pod indices, one per site), or None when its site has one pod.
        Created the first time a layout is asked for: for each data index,
        one group per site of two or more pods, in site order.  Every rank
        runs the same sync, so every rank asks for the same layouts in the
        same order."""
        key = tuple(tuple(int(p) for p in g) for g in site_groups)
        if key not in self._sites:
            mine = None
            for m in range(self.model):
                for d in range(self.data):
                    for site in key:
                        if len(site) < 2:
                            continue
                        g = self._new_group([self.rank_of(p, d, m) for p in site])
                        if ((d, m) == (self.data_index, self.model_index)
                                and self.pod_index in site):
                            mine = g
            self._sites[key] = mine
        return self._sites[key]

    def _new_group(self, ranks: list):
        return dist.new_group(ranks, backend=BACKEND, timeout=self.timeout)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                    device="cuda", timeout: Optional[timedelta] = None) -> PodMesh:
    """A mesh over the ranks of the default process group (which must exist
    when ``pod * data * model > 1``), this rank on `device`, in the JAX
    mesh's rank order (model innermost).  `timeout` bounds each collective
    of the mesh's groups (a new group does not take the default group's)."""
    n = pod * data * model
    if pod < 1 or data < 1 or model < 1:
        raise ValueError(f"mesh of pod={pod} data={data} model={model} has no rank")
    mesh = PodMesh(pod=pod, data=data, model=model, rank=0,
                   device=torch.device(device), timeout=timeout)
    if n == 1:
        return mesh
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs "
                           f"torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh of {n} ranks over a process group of "
                         f"{dist.get_world_size()}")
    mesh.rank = dist.get_rank()
    # one fixed order on every rank: for each model index its world, its
    # data groups by pod and its pod groups by data index (an axis that spans
    # the model index's world uses its group); then the model groups by
    # (pod, data)
    mine = mesh.model_index
    for m in range(model):
        world = None
        if pod * data > 1:
            world = mesh._new_group([mesh.rank_of(p, d, m) for p in range(pod)
                                     for d in range(data)])
        if m == mine:
            mesh.world_group = world
        if data > 1:
            for p in range(pod):
                g = (world if pod == 1 else mesh._new_group(
                    [mesh.rank_of(p, d, m) for d in range(data)]))
                if (p, m) == (mesh.pod_index, mine):
                    mesh.data_group = g
        if pod > 1:
            for d in range(data):
                g = (world if data == 1 else mesh._new_group(
                    [mesh.rank_of(p, d, m) for p in range(pod)]))
                if (d, m) == (mesh.data_index, mine):
                    mesh.pod_group = g
    if model > 1:
        for p in range(pod):
            for d in range(data):
                g = mesh._new_group([mesh.rank_of(p, d, m) for m in range(model)])
                if (p, d) == (mesh.pod_index, mesh.data_index):
                    mesh.model_group = g
    return mesh
