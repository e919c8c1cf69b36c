"""Checkpoint manager: retention, latest-step discovery, async save,
optional DataGather replication to a peer location (local path or, with a
`transfer` engine, shipped across sites over a WidePath route).

A copy of the JAX package's ``checkpoint/manager.py``; ``save`` takes its
host copy of the state (tensors, on any device) with ``Tensor.to("cpu")``
before the writer thread starts, and ``restore`` hands each leaf to the
caller's ``place`` (``store.restore``).  ``timings`` keeps each save's host
copy and write seconds."""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Optional

from repro_torch.checkpoint import store
from repro_torch.checkpoint.replicate import DataGather
from repro_torch.core.tree import tree_map


_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, chunk_mb: float = 32.0,
                 streams: int = 8, replica_dir: Optional[str] = None,
                 transfer=None):
        """`transfer` (a :class:`repro_torch.core.filetransfer.FileTransfer`)
        routes replication through the WAN path machinery — chunked
        multi-stream transfers, per-hop telemetry, resumable jobs — instead
        of the local-copy fallback; this is how `Trainer` ships checkpoints
        to a peer site along a topology route."""
        self.dir = directory
        self.keep = keep
        self.chunk_mb = chunk_mb
        self.streams = streams
        os.makedirs(directory, exist_ok=True)
        self.transfer = transfer
        self.replica_dir = replica_dir
        # the gatherer starts lazily after the first COMPLETED save: a
        # manager whose primary directory is still empty (fresh restart, or
        # first save in flight) must not begin mirroring — the mirror prune
        # would wipe the very replica the restart may restore from
        self.gatherer = None
        # guards gatherer/_async_thread: _ensure_gatherer runs on the async
        # save thread while save()/wait()/close() run on the trainer thread
        self._state_lock = threading.Lock()
        self._async_thread: Optional[threading.Thread] = None
        # per save: {"step", "host_s", "write_s"} (write_s once written)
        self.timings: list[dict] = []

    def _ensure_gatherer(self):
        with self._state_lock:
            if self.replica_dir and self.gatherer is None:
                self.gatherer = DataGather(self.dir, self.replica_dir,
                                           transfer=self.transfer).start()

    # -- discovery -----------------------------------------------------------
    @staticmethod
    def _steps_in(directory: Optional[str]) -> list[int]:
        out = []
        if not directory or not os.path.isdir(directory):
            return out
        for d in os.listdir(directory):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(directory, d, store.MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def steps(self) -> list[int]:
        return self._steps_in(self.dir)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def has_checkpoint(self) -> bool:
        """Anything restorable — in the primary directory *or* the replica
        mirror (the restart-from-replica scenario)."""
        return bool(self.steps() or self._steps_in(self.replica_dir))

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # -- save/restore ---------------------------------------------------------
    def save(self, step: int, state, *, extra: Optional[dict] = None,
             block: bool = True):
        """Save (optionally async: the host copy happens now, file IO in a
        background thread — off the training critical path)."""
        # always drain a pending async save first: two writers on the same
        # step_N.tmp directory race rmtree/os.replace against each other
        self.wait()
        t0 = time.perf_counter()
        host_state = tree_map(
            lambda x: x.detach().to("cpu", copy=True), state)
        row = {"step": step, "host_s": time.perf_counter() - t0}
        with self._state_lock:
            self.timings.append(row)

        def run():
            t1 = time.perf_counter()
            store.save(host_state, self.path(step), step=step,
                       chunk_mb=self.chunk_mb, streams=self.streams, extra=extra)
            with self._state_lock:
                row["write_s"] = time.perf_counter() - t1
            self._prune()
            # start mirroring only once the primary HOLDS a published
            # checkpoint: any earlier (top of save, __init__) and the
            # gatherer's first prune pass races the in-flight store.save
            # against a still-empty primary — wiping the very replica a
            # restarted pod may still need to restore from
            self._ensure_gatherer()

        if block:
            run()
        else:
            with self._state_lock:
                self._async_thread = threading.Thread(target=run, daemon=True)
                self._async_thread.start()

    def wait(self):
        # join OUTSIDE the lock: run() takes it in _ensure_gatherer
        t = self._async_thread
        if t is not None:
            t.join()
            with self._state_lock:
                self._async_thread = None

    def replicate_now(self) -> int:
        """One synchronous mirror pass to the replica: ship the checkpoints
        across sites *now* (the final-save path) instead of waiting for the
        background gatherer's next tick.  Returns files shipped."""
        return self.gatherer.sync() if self.gatherer else 0

    def restore(self, like, *, step: Optional[int] = None, place=None
                ) -> tuple[Any, dict]:
        """Restore `step` (default: latest).  When the primary directory has
        no usable checkpoint — the whole-pod-loss scenario DataGather exists
        for — falls back to the replica mirror, so a pod that lost its local
        storage restarts from the copy its peer site gathered."""
        directory = None
        want = step if step is not None else self.latest_step()
        if want is not None and (step is None or want in self.steps()):
            directory = self.path(want)
        elif self.replica_dir:
            rsteps = self._steps_in(self.replica_dir)
            if step is not None and step in rsteps:
                want = step
            elif step is None and rsteps:
                want = rsteps[-1]
            if want is not None and want in rsteps:
                directory = os.path.join(self.replica_dir, f"step_{want:08d}")
        if directory is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.dir}"
                + (f" or replica {self.replica_dir}" if self.replica_dir
                   else ""))
        return store.restore(directory, like, place=place,
                             streams=self.streams)

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            import shutil
            shutil.rmtree(self.path(s), ignore_errors=True)

    def close(self):
        self.wait()
        if self.gatherer:
            self.gatherer.stop()
