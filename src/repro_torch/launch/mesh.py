"""The mesh of the port: ``torch.distributed`` process groups in place of the
JAX package's device mesh (``launch/mesh.py``).

A :class:`PodMesh` has the axis sizes ``pod``, ``data`` and ``model``, this
rank's pod index, the pod group (one rank per pod, the WAN axis) and, once
asked for, one process group per WidePath stream over the same ranks.  Every
group is created on every rank in the same order, once per mesh, never per
step.  The groups use gloo: the card's tensors cross through host memory,
where MPWide's WAN sockets carry them too, and gloo, unlike NCCL, can put two
ranks on one card.  ``data > 1`` and ``model > 1`` are queued (ROADMAP.md
queue A, 'data > 1 with ZeRO and reduce-scatter', and the other model
families for tensor parallelism), and so are NCCL pod groups across cards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.collectives import queued

BACKEND = "gloo"


@dataclass
class PodMesh:
    pod: int
    data: int
    model: int
    rank: int
    device: torch.device
    pod_group: Optional[object] = None       # None with one pod
    _streams: list = field(default_factory=list, repr=False)

    @property
    def shape(self) -> dict:
        return {"pod": self.pod, "data": self.data, "model": self.model}

    @property
    def pod_index(self) -> int:
        return self.rank // (self.data * self.model)

    @property
    def n_ranks(self) -> int:
        return self.pod * self.data * self.model

    def stream_groups(self, n: int) -> list:
        """The first `n` stream groups, created the first time they are
        asked for.  Every rank builds the same steps, so every rank asks for
        the same counts in the same order."""
        if self.pod_group is None:
            return []
        while len(self._streams) < n:
            self._streams.append(dist.new_group(list(range(self.n_ranks)),
                                                backend=BACKEND))
        return self._streams[:n]


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                    device="cuda") -> PodMesh:
    """A mesh over the ranks of the default process group (which must exist
    when ``pod * data * model > 1``), this rank on `device`."""
    if data != 1:
        raise queued(f"data = {data}", "data > 1 with ZeRO and reduce-scatter")
    if model != 1:
        raise queued(f"model = {model} (tensor parallelism)",
                     "the other model families")
    n = pod * data * model
    if n < 1:
        raise ValueError(f"mesh of pod={pod} data={data} model={model} has no rank")
    rank = 0
    group = None
    if n > 1:
        if not dist.is_initialized():
            raise RuntimeError(f"a mesh of {n} ranks needs "
                               f"torch.distributed.init_process_group first")
        if dist.get_world_size() != n:
            raise ValueError(f"mesh of {n} ranks over a process group of "
                             f"{dist.get_world_size()}")
        rank = dist.get_rank()
        group = dist.new_group(list(range(n)), backend=BACKEND)
    return PodMesh(pod=pod, data=data, model=model, rank=rank,
                   device=torch.device(device), pod_group=group)
