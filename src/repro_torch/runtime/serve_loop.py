"""Server: batched decode serving loop.

The decode loop supports two position modes:

* scalar ``pos`` — every row of the batch sits at the same depth;
* per-sequence ``(B,)`` positions — rows sit at different depths, as the
  continuous batcher requires (each slot's request prefilled a different
  prompt length).  Finished rows (EOS or per-row budget) stop counting
  toward output lengths and the loop exits as soon as every row is done,
  so freed slots return to the scheduler instead of idling to ``max_new``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.telemetry import get_telemetry
from repro_torch.core.tree import tree_map
from repro_torch.models.param import tree_init
from repro_torch.runtime.step import build_serve_step


@dataclass
class ServeResult:
    tokens: np.ndarray            # (B, steps); rows padded after they finish
    steps: int
    lengths: Optional[np.ndarray] = None   # (B,) tokens generated per row


def land_prefill(cache: dict, state: dict) -> dict:
    """Copy a prefill's state tree into a decode cache of the model's
    ``cache_defs(B, max_len)``, in place, and return the cache: each leaf
    into the leading corner of its cache leaf, in the cache's dtype (a
    mamba state whole; K/V of the prompt's length into the first S
    positions of the seq dim, so that decoding past S does not meet the
    clamp of a cache only S long; the vlm family's K/V hold its patch
    prefix too, n_prefix + S positions, and the audio family's
    cross-attention ``xk``/``xv`` fill their leaves whole).  Decode then
    starts at position n_prefix + S."""
    if set(state) != set(cache):
        raise ValueError(f"prefill state leaves {sorted(state)} are not the "
                         f"cache's {sorted(cache)}")
    for n, leaf in state.items():
        dst = cache[n]
        if leaf.dim() != dst.dim() or any(a > b for a, b in zip(leaf.shape, dst.shape)):
            raise ValueError(f"prefill leaf {n!r} of shape {tuple(leaf.shape)} does "
                             f"not fit the cache's {tuple(dst.shape)}")
        dst[tuple(slice(0, s) for s in leaf.shape)].copy_(leaf)
    return cache


def take_shards(params, defs, mesh, tp_dims):
    """This rank's TP blocks of the whole parameter tree `params` on `mesh`'s
    model axis (`params` itself without one); a leaf that is not of its
    PD's whole shape raises."""
    if mesh is None or tp_dims is None:
        return params
    from repro_torch.models.param import rank_shard

    def take(x, pd, t):
        if tuple(x.shape) != tuple(pd.shape):
            raise ValueError(f"parameter of shape {tuple(x.shape)}: Server(mesh=) "
                             f"takes the whole leaves, this one's is {pd.shape}")
        return rank_shard(x, None, t, mesh)
    return tree_map(take, params, defs, tp_dims)


class Server:
    """Greedy batched decoding against the decode StepBundle, on `device`
    ("cuda" by default; "cpu" runs the kernels' plain versions).

    With a `mesh` (the reference's ``Server(rc, mesh, ...)``; its device is
    the server's) of ``model > 1`` each model rank runs the decode on its
    TP shards: of the whole tree `params`, as the reference places it
    (:func:`take_shards`), or, without `params`, of the whole tree drawn
    from `seed` leaf by leaf.
    Every model rank decodes the same tokens (the logits are gathered whole
    on every rank); rank 0 reports them.  The cache holds the rank's K/V
    heads; land a TP prefill's state into it with :func:`land_prefill`.

    The serving engine (`runtime.serving`) layers the continuous batcher
    (`core.serving`) and the KV shipper (`core.kvship`) on top; this loop is
    the per-step engine both share.
    """

    def __init__(self, rc: RunConfig, params=None, seed: int = 0, *,
                 device="cuda", mesh=None):
        self.rc = rc
        self.mesh = mesh
        self.bundle = build_serve_step(rc, kind="decode", device=device,
                                       mesh=mesh)
        self.device = self.bundle.device
        self.params = (take_shards(params, self.bundle.param_defs, mesh,
                                   self.bundle.tp_dims)
                       if params is not None else self.bundle.init_params(seed))
        # signatures whose first step has run: (B, pos kind, cache geometry).
        # The JAX package compiles once per signature and excludes that first
        # step from timings; eager PyTorch has no compile, but the first step
        # of a new geometry still pays allocator and kernel-load costs, so the
        # same rule keeps the two packages' telemetry comparable.
        self._warm_shapes: set = set()

    def init_cache(self):
        return tree_init(self.bundle.cache_defs, 0, device=self.device)

    @staticmethod
    def _compile_sig(B: int, vec: bool, cache) -> tuple:
        geom = tuple(sorted((n, tuple(x.shape), str(x.dtype))
                            for n, x in cache.items()))
        return (B, "vec" if vec else "scalar", geom)

    def generate(self, prompt_tokens: np.ndarray, max_new: int = 16,
                 prefill_pos: Optional[Any] = None, *,
                 eos_id: Optional[int] = None,
                 max_new_per_seq: Optional[np.ndarray] = None,
                 cache=None, pad_id: int = 0) -> ServeResult:
        """prompt_tokens: (B, 1) last prompt token per sequence.

        `prefill_pos` is a scalar (all rows at one depth) or a (B,) vector
        of per-row depths; pass `cache=` to decode against a prefilled cache
        (the default zero cache exercises the step shape only).  `eos_id`
        and `max_new_per_seq` finish rows early; the loop stops once every
        row is done and `ServeResult.lengths` reports per-row token counts.
        """
        B = prompt_tokens.shape[0]
        if cache is None:
            cache = self.init_cache()
        vec = (max_new_per_seq is not None
               or (prefill_pos is not None and np.ndim(prefill_pos) >= 1))
        sig = self._compile_sig(B, vec, cache)
        if vec:
            pos0 = (np.zeros(B, np.int64) if prefill_pos is None
                    else np.asarray(prefill_pos, np.int64).reshape(B))
            pos_base = torch.as_tensor(pos0, device=self.device)
        else:
            pos_base = int(prefill_pos) if prefill_pos is not None else 0
        budget = (np.full(B, max_new, np.int64) if max_new_per_seq is None
                  else np.asarray(max_new_per_seq, np.int64).reshape(B))
        tok = torch.as_tensor(np.asarray(prompt_tokens, np.int64),
                              device=self.device)
        out = []
        lengths = np.zeros(B, np.int64)
        done = lengths >= budget
        tele = get_telemetry()
        path_key = self.bundle.path.key
        steps = 0
        for i in range(int(budget.max(initial=0))):
            if done.all():
                break
            t0 = time.perf_counter()
            logits, cache = self.bundle.fn(self.params, cache, pos_base + i, tok)
            tok = torch.argmax(logits[:, -1:, :], dim=-1)
            step_tok = tok[:, 0].cpu().numpy()          # waits for the step
            if sig in self._warm_shapes:
                tele.record(path_key, time.perf_counter() - t0, step=i)
            else:
                self._warm_shapes.add(sig)
            active = ~done
            lengths += active
            if eos_id is not None:
                done = done | (active & (step_tok == eos_id))
            done = done | (lengths >= budget)
            out.append(np.where(active, step_tok, pad_id))
            steps += 1
        tokens = (np.stack(out, axis=1) if out
                  else np.zeros((B, 0), np.int64))
        return ServeResult(tokens=tokens, steps=steps, lengths=lengths)
