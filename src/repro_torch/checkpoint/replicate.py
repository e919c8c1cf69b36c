"""DataGather: continuous one-way directory synchronization over a WidePath.

The paper's DataGather keeps a remote directory mirrored while a simulation
runs, so output data accumulates at one site.  Here it mirrors checkpoint
directories to a replica location (a peer site's storage in production; any
path here), running concurrently with training — whole-pod loss then
restarts from the replica.

The mirror's data plane is the mpw-cp engine
(:class:`repro_torch.core.filetransfer.FileTransfer`): each pass is a manifest
diff (walk src, compare size/mtime against dst) whose stale entries become
:class:`FileJob`s — chunked, multi-stream, checksummed, optionally
compressed transfers that relay through whatever route the engine's path
carries and land in per-hop telemetry.  Without an explicit engine the
mirror degrades to a local single-stream transfer (same atomicity, no
telemetry), which is byte-for-byte what the old ``shutil.copy2`` walk did.
"""
from __future__ import annotations

import os
import threading

from repro_torch.core.filetransfer import (
    PART_SUFFIX,
    SIDECAR_SUFFIX,
    TRANSIENT_SUFFIXES,
    ChecksumError,
    FileTransfer,
    local_transfer,
)


def sync_once(src: str, dst: str,
              transfer: FileTransfer | None = None) -> int:
    """One-way sync; returns number of files copied. Atomic per file.

    The copy condition is the mirror diff: a file ships when the mirror copy
    is missing, the source is *newer* (mtime), or the sizes differ — so a
    same-size rewrite with a newer mtime still overwrites (checkpoint files
    are fixed-shape: same size, new bytes).  Runs concurrently with the
    writer: a source file may vanish between the walk and the stat/copy
    (checkpoint GC deleting an old step), which must not crash the pass —
    the next prune removes its mirror copy.  Transient artifacts are never
    *mirrored* (``.tmp`` files, whole ``.tmp`` staging directories, engine
    droppings); in the destination, orphaned engine droppings (``.part``
    partials, ``.mpwcp.json`` sidecars left by an interrupted earlier
    pass) ARE pruned, so a killed mirror pass cannot leak
    checkpoint-sized partials into the replica forever.
    """
    if not os.path.isdir(src):
        return 0
    eng = transfer if transfer is not None else local_transfer()
    os.makedirs(dst, exist_ok=True)
    copied = 0
    for root, dirs, files in os.walk(src):
        # store.save stages whole checkpoints in `step_N.tmp/` directories
        # before its atomic rename: descending into one would ship partial
        # shards over the WAN and then ship the published copy again
        dirs[:] = [x for x in dirs if not x.endswith(TRANSIENT_SUFFIXES)]
        rel = os.path.relpath(root, src)
        troot = os.path.join(dst, rel) if rel != "." else dst
        os.makedirs(troot, exist_ok=True)
        for fn in files:
            if fn.endswith(TRANSIENT_SUFFIXES):
                continue
            s = os.path.join(root, fn)
            t = os.path.join(troot, fn)
            try:
                if (not os.path.exists(t)
                        or os.path.getmtime(s) > os.path.getmtime(t)
                        or os.path.getsize(s) != os.path.getsize(t)):
                    # mirror jobs never resume: the diff already skips files
                    # that are up to date, and a sidecar would itself show
                    # up as a mirror entry
                    eng.copy(s, t, resume=False)
                    copied += 1
            except FileNotFoundError:
                continue   # deleted from src mid-walk
    # prune deleted entries (keep mirror exact); bottom-up so directories
    # emptied by file pruning can be removed in the same pass
    for root, dirs, files in os.walk(dst, topdown=False):
        rel = os.path.relpath(root, dst)
        sroot = os.path.join(src, rel) if rel != "." else src
        for fn in files:
            if fn.endswith(".tmp"):
                continue                # a concurrent writer's staging file
            if not fn.endswith((PART_SUFFIX, SIDECAR_SUFFIX)) \
                    and os.path.exists(os.path.join(sroot, fn)):
                continue
            # mirrored entries whose source vanished, AND any engine
            # droppings (.part partials, .mpwcp.json sidecars): this pass's
            # own copies have completed before the prune runs (passes are
            # serialized), so a dropping here is an earlier interrupted
            # pass's orphan — without this, a checkpoint-sized .part could
            # sit in the replica forever.  (The mirror owns its dst: don't
            # point resumable user transfers at a DataGather destination.)
            try:
                os.remove(os.path.join(root, fn))
            except FileNotFoundError:
                pass
        if root != dst and not os.path.isdir(sroot):
            try:
                os.rmdir(root)          # only succeeds once empty
            except OSError:
                pass                    # still holds live entries
    return copied


class DataGather:
    """Background mirroring thread (start/stop).

    `transfer` routes the mirror's bytes over a WidePath (multi-stream,
    compressed, multi-hop — the WAN checkpoint-shipping configuration);
    None keeps the local fallback.
    """

    def __init__(self, src: str, dst: str, interval_s: float = 2.0,
                 transfer: FileTransfer | None = None):
        self.src, self.dst = src, dst
        self.interval_s = interval_s
        self.transfer = transfer
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sync_lock = threading.Lock()
        self.copied_total = 0

    def sync(self) -> int:
        """One synchronous mirror pass (the loop body; also what
        `CheckpointManager.replicate_now` and the `stop()` drain run).
        Serialized: a caller-driven pass must not overlap the background
        tick on the same destination — two concurrent copies of one file
        race part-file truncation against chunk writes."""
        with self._sync_lock:
            n = sync_once(self.src, self.dst, transfer=self.transfer)
            self.copied_total += n
        return n

    def _safe_sync(self) -> int:
        """sync() that survives transient failures: a bad pass (I/O error,
        a chunk exhausting its checksum retries) must not kill the mirror
        thread — the next tick retries.  The WAN data plane can raise
        ChecksumError, which the old OSError-only guard let escape."""
        try:
            return self.sync()
        except (OSError, ChecksumError):
            return 0

    def start(self):
        def loop():
            while not self._stop.is_set():
                self._safe_sync()
                self._stop.wait(self.interval_s)

        with self._sync_lock:
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        self._safe_sync()           # drain; must not throw out of shutdown
