"""ServingEngine: disaggregated prefill/decode with continuous batching.

Glues the three serving pieces together with *real* model work:

* `core.serving.ContinuousBatcher` — the slot scheduler (virtual step clock,
  deterministic event timeline);
* `core.kvship` — the prefilled KV cache crossing the WAN as chunked leaves
  over a `WidePath` (``mode="disagg"``), with exact per-hop wire bytes under
  ``serve/req{rid}/kv`` telemetry keys;
* `runtime.serve_loop.Server` — the decode StepBundle, driven here with
  per-sequence ``(B,)`` positions so every slot sits at its own depth.

Engine semantics: one engine step == one batcher step == one decode token
per occupied slot.  Prefill and KV-ship execute synchronously at their
transition step (the batcher runs with ``ship_steps=0``), so a monolithic
engine (``mode="mono"``) and a disaggregated one replay the *same* schedule
and, with the ``none`` codec, give bit-identical tokens.  Modeled WAN seconds
land in telemetry via the shipper.  Everything runs under
``torch.inference_mode()`` on `device` ("cuda" by default).

Not ported yet (ROADMAP.md queue A): shipping under a topology route's fault
schedules, and the serve failover driven by site membership and the chaos
incident log.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.kvship import KVShipPlan, plan_kv_ship, ship_kv
from repro_torch.core.path import WidePath
from repro_torch.core.serving import ContinuousBatcher
from repro_torch.runtime.serve_loop import Server


class ServingEngine:
    """Continuous-batching serving with optional prefill/decode split.

    Parameters
    ----------
    rc: run config; ``rc.shape.global_batch`` is the decode slot count and
        ``rc.shape.seq_len`` the decode cache length.
    mode: ``"mono"`` (prefill feeds decode in memory) or ``"disagg"``
        (prefill KV is shipped over `path` before decode may start).
    path: the WAN `WidePath` KV caches cross when ``mode="disagg"``.
    params / seed: the parameter tree (else initialized from `seed`).
    deadline_steps / shed: passed to the batcher — per-request SLOs with
        shedding.
    device: where the model runs.

    ``timings`` holds host-clock seconds of each prefill (to its first
    token), each KV ship with its landing in the decode cache, and each
    decode step; each ends in a device synchronisation.
    """

    def __init__(self, rc: RunConfig, *, mode: str = "mono",
                 path: Optional[WidePath] = None, params=None, seed: int = 0,
                 queue_limit: int = 64, step_s: float = 1e-2,
                 deadline_steps=None, shed: bool = True, device="cuda"):
        if mode not in ("mono", "disagg"):
            raise ValueError(f"mode must be 'mono' or 'disagg', got {mode!r}")
        if mode == "disagg" and path is None:
            raise ValueError(f"mode='disagg' needs a WidePath to ship KV "
                             f"over, got path={path!r}")
        if rc.model.encoder_layers:
            raise ValueError(
                f"ServingEngine is decoder-only; {rc.model.name!r} has "
                f"{rc.model.encoder_layers} encoder layers")
        self.rc = rc
        self.mode = mode
        self.path = path
        self.server = Server(rc, params=params, seed=seed, device=device)
        self.device = self.server.device
        self.model = self.server.bundle.model
        self.max_slots = rc.shape.global_batch
        self.max_len = rc.shape.seq_len
        self.batcher = ContinuousBatcher(
            self.max_slots, queue_limit, prefill_steps=1, ship_steps=0,
            step_s=step_s, deadline_steps=deadline_steps, shed=shed)
        self.cache = self.server.init_cache()
        self._pos = np.zeros(self.max_slots, np.int64)
        self._tok = np.zeros((self.max_slots, 1), np.int64)
        self._decoding: dict[int, int] = {}     # slot -> rid
        self._prompts: dict[int, np.ndarray] = {}
        self._outputs: dict[int, list] = {}
        self.results: dict[int, np.ndarray] = {}   # rid -> generated tokens
        self.timings: dict[str, list] = {"prefill_s": [], "ship_s": [],
                                         "decode_s": []}
        self._n_events = 0
        self._ship_plans: dict[tuple, KVShipPlan] = {}

    # -- request intake -----------------------------------------------------
    def submit(self, prompt_tokens: np.ndarray, max_new: int,
               deadline_steps: Optional[int] = None) -> Optional[int]:
        """Admit one request (or None when admission control rejects or
        sheds it)."""
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        S_p = prompt.shape[0]
        w = self.rc.model.sliding_window
        if S_p + max_new > self.max_len or (w and S_p > w):
            raise ValueError(
                f"prompt_len={S_p} + max_new={max_new} exceeds the decode "
                f"cache (max_len={self.max_len}, window={w})")
        rid = self.batcher.submit(S_p, max_new, deadline_steps=deadline_steps)
        if rid is not None:
            self._prompts[rid] = prompt
        return rid

    # -- engine step --------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """One engine step: batcher transition + the real work it implies."""
        pre = dict(self._decoding)   # slots decoding before this step
        self.batcher.step_once()
        tl = self.batcher.timeline()
        events = tl[self._n_events:]
        self._n_events = len(tl)
        if pre:
            self._decode_tick(pre)   # batcher rule (3): pre-existing slots
        for kind, tag, _step in events:
            rid = int(tag[3:])
            if kind == "decode":
                self._on_decode_start(rid)
            elif kind == "complete":
                self._on_complete(rid)
            elif kind in ("timeout", "requeue"):
                self._on_abort(rid, keep_prompt=kind == "requeue")
            elif kind in ("shed", "reject"):
                self._prompts.pop(rid, None)
        return len(events)

    def run_to_completion(self, max_steps: int = 100_000) -> dict:
        """Step until every submitted request is terminal; returns stats."""
        steps = 0
        while self.batcher.active() > 0:
            if steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps: "
                    f"{self.batcher.active()} request(s) still live")
            self.step()
            steps += 1
        return self.batcher.stats()

    # -- internals ----------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_tick(self, slots: dict) -> None:
        """One real batched decode step; only `slots` rows advance."""
        t0 = time.perf_counter()
        logits, self.cache = self.server.bundle.fn(
            self.server.params, self.cache,
            torch.as_tensor(self._pos, device=self.device),
            torch.as_tensor(self._tok, device=self.device))
        toks = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self.timings["decode_s"].append(time.perf_counter() - t0)
        for slot, rid in slots.items():
            self._outputs[rid].append(int(toks[slot]))
            self._pos[slot] += 1
            self._tok[slot, 0] = toks[slot]

    def _on_decode_start(self, rid: int) -> None:
        """Prefill the request's prompt, ship its KV if disaggregated, land
        it in the decode cache, and bank the first token."""
        slot = self.batcher.slot_of(rid)
        prompt = self._prompts[rid]
        S_p = prompt.shape[0]
        t0 = time.perf_counter()
        tokens = torch.as_tensor(prompt[None, :], device=self.device)
        logits, pcache = self.model.prefill(self.server.params,
                                            {"tokens": tokens})
        first = int(torch.argmax(logits[0, -1]))
        t1 = time.perf_counter()
        kv = {n: pcache[n][:, 0] for n in ("k", "v")}
        if self.mode == "disagg":
            geom = tuple(sorted((n, tuple(a.shape)) for n, a in kv.items()))
            if geom not in self._ship_plans:
                self._ship_plans[geom] = plan_kv_ship(kv, self.path)
            kv, _res = ship_kv(kv, self._ship_plans[geom], rid,
                               step=self.batcher.now())
        for n, leaf in kv.items():
            # in place: the decode cache's buffer is reused, as the JAX
            # package reuses it by donation
            self.cache[n][:, slot, :S_p].copy_(leaf)
        self._sync()
        self.timings["prefill_s"].append(t1 - t0)
        self.timings["ship_s"].append(time.perf_counter() - t1)
        self._pos[slot] = S_p
        self._tok[slot, 0] = first
        self._outputs[rid] = [first]
        self._decoding[slot] = rid

    def _slot_of_decoding(self, rid: int) -> Optional[int]:
        for s, r in self._decoding.items():
            if r == rid:
                return s
        return None

    def _on_complete(self, rid: int) -> None:
        slot = self._slot_of_decoding(rid)
        if slot is not None:
            del self._decoding[slot]
        self.results[rid] = np.asarray(self._outputs.pop(rid), np.int64)

    def _on_abort(self, rid: int, *, keep_prompt: bool) -> None:
        """A request left the pipeline without completing: `timeout` drops
        it for good, `requeue` keeps the prompt so the re-queued request
        prefills again from scratch."""
        slot = self._slot_of_decoding(rid)
        if slot is not None:
            del self._decoding[slot]
        self._outputs.pop(rid, None)
        if not keep_prompt:
            self._prompts.pop(rid, None)
