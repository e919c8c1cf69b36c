"""Chunked, multi-stream checkpoint store (the mpw-cp analogue): the port of
the JAX package's ``checkpoint/store.py``, with its on-disk format byte for
byte.

Leaves are written as raw little-endian chunk files
``leaf{i:05d}_c{j:04d}.bin`` of `chunk_mb` each by a pool of `streams`
writer threads, with a JSON manifest (``manifest.json``: ``step``,
``leaves`` with each leaf's ``name``, ``shape``, ``dtype`` and ``chunks``,
and ``extra``).  Leaves are numbered in the order ``jax.tree`` flattens the
reference's state, dict keys sorted (:func:`leaf_paths`), and named by
their key path joined with ``/``, so either package restores the other's
checkpoints.  Restore assembles each leaf on the host and hands it to the
caller's `place` (this rank's shard, its device), so a run can restart on
another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import torch

from repro_torch.core.tree import flatten, unflatten

MANIFEST = "manifest.json"

# the manifest's dtype names (numpy's, as the reference writes them)
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(name, leaf) in ``jax.tree_util.tree_flatten_with_path`` order: dict
    keys sorted, list and tuple items by index, the path joined with "/"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in leaf_paths(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def host_bytes(x: torch.Tensor) -> memoryview:
    """The little-endian bytes of `x` in C order, as ``np.ndarray.tobytes``
    gives them (a view when `x` is a contiguous host tensor)."""
    t = x.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy()) if t.numel() else memoryview(b"")


def save(tree, directory: str, *, step: int = 0, chunk_mb: float = 32.0,
         streams: int = 8, extra: Optional[dict] = None) -> dict:
    """Write a tree of tensors as a checkpoint.  Returns the manifest."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    chunk_bytes = max(1 << 10, int(chunk_mb * (1 << 20)))

    entries = []
    jobs = []
    for i, (name, t) in enumerate(leaf_paths(tree)):
        raw = host_bytes(t)
        chunks = []
        for c0 in range(0, max(len(raw), 1), chunk_bytes):
            fname = f"leaf{i:05d}_c{len(chunks):04d}.bin"
            piece = raw[c0:c0 + chunk_bytes]
            chunks.append({"file": fname, "offset": c0, "size": len(piece)})
            jobs.append((os.path.join(tmp, fname), piece))
        entries.append({"name": name, "shape": list(t.shape),
                        "dtype": _NAMES[t.dtype], "chunks": chunks})

    def write(job):
        path, payload = job
        with open(path, "wb") as f:
            f.write(payload)

    with ThreadPoolExecutor(max_workers=max(1, streams)) as pool:
        list(pool.map(write, jobs))

    manifest = {"step": step, "leaves": entries, "extra": extra or {}}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)            # atomic publish
    return manifest


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


def read_leaf(directory: str, entry: dict) -> torch.Tensor:
    """One manifest entry's tensor, assembled on the host."""
    dtype = DTYPES[entry["dtype"]]
    total = sum(ch["size"] for ch in entry["chunks"])
    if total == 0:
        return torch.empty(entry["shape"], dtype=dtype)
    buf = bytearray(total)
    view = memoryview(buf)
    off = 0
    for ch in entry["chunks"]:
        with open(os.path.join(directory, ch["file"]), "rb") as f:
            off += f.readinto(view[off:off + ch["size"]])
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
        entry["shape"])


def restore(directory: str, like, *,
            place: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
            streams: int = 8):
    """Restore into the structure of `like` (a tree whose leaves name the
    checkpoint's by position; their values are not read).  `place(name,
    tensor)` puts each host leaf where the caller wants it (a shard of it,
    on a device); by default the leaves stay on the host.  Returns (tree,
    manifest)."""
    manifest = load_manifest(directory)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    place = place or (lambda name, t: t)

    def load(name):
        return place(name, read_leaf(directory, by_name[name]))

    names = [n for n, _ in leaf_paths(like)]
    with ThreadPoolExecutor(max_workers=max(1, streams)) as pool:
        tensors = list(pool.map(load, names))
    _, td = flatten(like)
    return unflatten(td, tensors), manifest
