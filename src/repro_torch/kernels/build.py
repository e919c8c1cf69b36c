"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with :mod:`ctypes`.  The
libraries go to ``build/repro_torch_kernels/`` at the repository root, at
first use, under a file name that carries a hash of the source, of every
header in ``csrc/`` and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  A failed build raises: nothing
falls back to the plain versions.  ``ptxas`` reports each kernel's registers
and spills (``-Xptxas -v``); :func:`resources` reads that report from the
builds of this process.

The C entry points take pointers and the CUDA stream as ``c_void_p``, launch
on the stream they are given (the wrappers pass PyTorch's current stream),
allocate nothing and return the launch's ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "quant", "rmsnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}      # nvcc's output of each build of this process


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: its name carries a hash
    of the source, of every ``csrc/*.cuh`` and of every flag."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    """Start nvcc for one source unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    _logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def build_all(names=SOURCES) -> list[str]:
    """Compile every named source that is not built yet, all nvcc processes
    at once.  Returns the names it compiled."""
    with _lock:
        started = {n: _start(n) for n in names}
        built = []
        try:
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
                    built.append(n)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?(\w+)'?")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes (stores + loads) of each kernel in an
    ``nvcc -Xptxas -v`` log, by mangled name."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0})
            continue
        if cur is None:
            continue
        if (m := _SPILL.search(line)):
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        if (m := _USED.search(line)):
            cur["registers"] = int(m.group(1))
    return out


def resources(name: str) -> dict[str, dict[str, int]]:
    """:func:`parse_ptxas` of the build of ``csrc/<name>.cu`` made by this
    process; empty when this process loaded an earlier build."""
    return parse_ptxas(_logs.get(name, ""))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_handle(t) -> int:
    """PyTorch's current CUDA stream on `t`'s device, as an integer handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
