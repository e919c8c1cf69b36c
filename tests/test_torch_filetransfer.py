"""The port's mpw-cp engine (``core/filetransfer.py``) and DataGather mirror
(``checkpoint/replicate.py``) against the JAX package's, in process.

The port's modules are copies of the reference's (only the package of the
imports differs), so every case of ``tests/test_filetransfer.py`` and
``tests/test_replicate_sync.py`` runs on both packages' engines with the
same files and must give **identical** ``FileResult`` fields (paths made
relative), sidecars, telemetry rows (path ids normalized) and tuner
histories.  A transfer interrupted under one package resumes under the
other.  Every file lives under ``tmp_path``; mtimes are set with
``os.utime``, never waited for; the mirror thread is joined with a
deadline and nothing is asserted about how many passes it made.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import random
import re
import threading
from types import SimpleNamespace

import pytest

PKGS = ("repro", "repro_torch")


def pkg(root: str) -> SimpleNamespace:
    ft = importlib.import_module(f"{root}.core.filetransfer")
    return SimpleNamespace(
        ft=ft, FileTransfer=ft.FileTransfer, ChecksumError=ft.ChecksumError,
        MPW=importlib.import_module(f"{root}.core.api").MPW,
        CommConfig=importlib.import_module(f"{root}.configs.base").CommConfig,
        path=importlib.import_module(f"{root}.core.path"),
        topo=importlib.import_module(f"{root}.core.topology"),
        tel=importlib.import_module(f"{root}.core.telemetry"),
        rep=importlib.import_module(f"{root}.checkpoint.replicate"))


def _make_file(path: str, nbytes: int = 300_000, seed: int = 0) -> None:
    """The reference test's file: half random bytes, half compressible."""
    random.seed(seed)
    data = bytes(random.getrandbits(8) for _ in range(nbytes // 2))
    data += b"compressible " * ((nbytes - len(data)) // 13 + 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data[:nbytes])
    os.utime(path, (1_700_000_000, 1_700_000_000))


def _wan(P, streams: int = 4, chunk_mb: float = 0.0625, compress: str = "none",
         name: str = "t"):
    return P.path.WidePath(axis="pod", link=P.path.WAN_LONDON_POZNAN, name=name,
                           comm=P.CommConfig(streams=streams, chunk_mb=chunk_mb,
                                             compress=compress))


def _norm(res, base: str) -> dict:
    """A FileResult's fields, its paths relative to `base`."""
    d = dataclasses.asdict(res)
    d["src"], d["dst"] = (os.path.relpath(d["src"], base),
                          os.path.relpath(d["dst"], base))
    return d


def _keys(report: dict) -> dict:
    return {re.sub(r"mpw\d+", "mpwN", k): v for k, v in report.items()}


class _Interrupt(RuntimeError):
    pass


def _interrupter(after: int):
    seen: list = []

    def hook(chunk, hop, payload):
        if len(seen) >= after and chunk.leaf not in seen:
            raise _Interrupt()
        seen.append(chunk.leaf)
        return payload
    return hook


# -- the cases, each run under both packages ----------------------------------

def case_plan(P, d):
    return [dataclasses.astuple(c) for c in P.ft.plan_file_chunks(300_000, 1 << 16)] + [
        dataclasses.astuple(c) for c in P.ft.plan_file_chunks(0, 1 << 20)]


def case_roundtrip(P, d):
    src, dst = f"{d}/a/src.bin", f"{d}/b/dst.bin"
    _make_file(src)
    res = P.FileTransfer(_wan(P), record=False).copy(src, dst)
    return [_norm(res, d), os.path.getmtime(dst),
            os.path.exists(dst + P.ft.PART_SUFFIX),
            os.path.exists(dst + P.ft.SIDECAR_SUFFIX)]


def case_empty(P, d):
    src = f"{d}/e.bin"
    open(src, "wb").close()
    return _norm(P.FileTransfer(_wan(P), record=False).copy(src, f"{d}/e.out"), d)


def case_zlib(P, d):
    src = f"{d}/src.bin"
    _make_file(src)
    return _norm(P.FileTransfer(_wan(P, compress="int8"), record=False).copy(
        src, f"{d}/dst.bin"), d)


def case_copy_tree(P, d):
    _make_file(f"{d}/tree/a.bin", 70_000)
    _make_file(f"{d}/tree/sub/b.bin", 70_001, seed=1)
    return [_norm(r, d) for r in
            P.FileTransfer(_wan(P), record=False).copy_tree(f"{d}/tree", f"{d}/mirror")]


def case_checksum_requeue(P, d):
    src = f"{d}/src.bin"
    _make_file(src)
    hit: list = []

    def corrupt_once(chunk, hop, payload):
        if chunk.leaf == 2 and not hit:
            hit.append(1)
            return b"\xff" + payload[1:]
        return payload
    return _norm(P.FileTransfer(_wan(P), record=False, fault_hook=corrupt_once)
                 .copy(src, f"{d}/dst.bin"), d)


def case_checksum_exhausted(P, d):
    src = f"{d}/src.bin"
    _make_file(src)
    eng = P.FileTransfer(_wan(P), record=False, max_retries=2,
                         fault_hook=lambda c, h, p: b"\0" * len(p) if c.leaf == 0 else p)
    with pytest.raises(P.ChecksumError) as e:
        eng.copy(src, f"{d}/dst.bin")
    sidecar = json.load(open(f"{d}/dst.bin" + P.ft.SIDECAR_SUFFIX))
    sidecar["src"] = os.path.relpath(sidecar["src"], d)
    return [str(e.value).replace(d, "D"), sidecar]


def case_resume_source_changed(P, d):
    src, dst = f"{d}/src.bin", f"{d}/dst.bin"
    _make_file(src)
    eng = P.FileTransfer(_wan(P, streams=1), record=False, fault_hook=_interrupter(2))
    with pytest.raises(_Interrupt):
        eng.copy(src, dst)
    _make_file(src, seed=99)
    os.utime(src, (1_700_000_100, 1_700_000_100))      # a newer source
    eng.fault_hook = None
    return _norm(eng.copy(src, dst), d)


def case_two_hop_filecopy(P, d):
    src = f"{d}/src.bin"
    _make_file(src)
    P.tel.get_telemetry().reset()
    mpw = P.MPW.Init()
    pid = mpw.CreateForwarder(P.topo.cosmogrid_topology(), "tokyo", "espoo")
    mpw.setChunkSize(pid, 1 << 16)
    res = mpw.FileCopy(pid, src, f"{d}/dst.bin")
    path = mpw.path(pid)
    rows = {k: {f: v[f] for f in ("transfers", "total_bytes", "total_seconds", "plan")}
            for k, v in _keys(mpw.Report()).items()}
    stats = mpw.PathStats(pid)
    out = [_norm(res, d), rows, [h["total_bytes"] for h in stats["hops"]],
           re.sub(r"mpw\d+", "mpwN", path.hop_key(1))]
    mpw.Finalize()
    return out


def case_send_recv(P, d):
    src = f"{d}/src.bin"
    _make_file(src, 70_000)
    mpw = P.MPW.Init()
    pid = mpw.CreatePath(nstreams=2, comm=P.CommConfig(streams=2, chunk_mb=0.0625))
    out = mpw.FileSend(pid, src, f"{d}/sent.bin")
    back = mpw.FileRecv(pid, f"{d}/sent.bin", f"{d}/back.bin")
    mpw.Finalize()
    return [_norm(out, d), _norm(back, d)]


def case_online_tuner(P, d):
    src = f"{d}/src.bin"
    _make_file(src, 150_000)
    mpw = P.MPW.Init()
    pid = mpw.CreatePath(comm=P.CommConfig(streams=1, chunk_mb=0.0625))
    mpw.setAutoTuning(pid, True, online=True, window=1)
    results = [_norm(mpw.FileCopy(pid, src, f"{d}/d{i}.bin"), d) for i in range(4)]
    tuner = mpw.paths[pid].tuner
    out = [results, [list(map(str, h)) for h in tuner.history], tuner.tune_algo,
           dataclasses.asdict(mpw.path(pid).comm)]
    mpw.Finalize()
    return out


def case_algo_probe_revert(P, d):
    src = f"{d}/src.bin"
    _make_file(src, 70_000)
    mpw = P.MPW.Init()
    pid = mpw.CreatePath(comm=P.CommConfig(streams=1, chunk_mb=0.0625))
    mpw.setAutoTuning(pid, True, online=True, window=1)
    mpw.paths[pid].path = mpw.path(pid).with_(algo="ring2")
    mpw.FileCopy(pid, src, f"{d}/d.bin")
    algo = mpw.path(pid).comm.algo
    mpw.Finalize()
    return algo


def case_datagather_verb(P, d):
    import shutil
    _make_file(f"{d}/data/keep.bin", 70_000)
    _make_file(f"{d}/data/old/drop.bin", 70_000)
    mpw = P.MPW.Init()
    pid = mpw.CreatePath(comm=P.CommConfig(streams=2, chunk_mb=0.0625))
    g = mpw.DataGather(pid, f"{d}/data", f"{d}/mirror", start=False)
    first = g.sync()
    shutil.rmtree(f"{d}/data/old")
    second = g.sync()
    mpw.Finalize()
    return [g.transfer.digest, first, second,
            sorted(os.path.relpath(os.path.join(r, f), f"{d}/mirror")
                   for r, _, fs in os.walk(f"{d}/mirror") for f in fs)]


CASES = {f.__name__[5:]: f for f in (
    case_plan, case_roundtrip, case_empty, case_zlib, case_copy_tree,
    case_checksum_requeue, case_checksum_exhausted, case_resume_source_changed,
    case_two_hop_filecopy, case_send_recv, case_online_tuner,
    case_algo_probe_revert, case_datagather_verb)}


@pytest.mark.parametrize("case", list(CASES))
def test_filetransfer_case_identical_to_reference(tmp_path, case):
    got = {}
    for root in PKGS:
        d = str(tmp_path / root)
        os.makedirs(d)
        got[root] = CASES[case](pkg(root), d)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("first,then", [("repro", "repro_torch"),
                                        ("repro_torch", "repro")])
def test_interrupted_copy_resumes_under_the_other_package(tmp_path, first, then):
    """Three chunks land under one package; the other resumes from its
    sidecar and ships only the rest.  Both packages' sidecars of the same
    interruption are identical."""
    src = str(tmp_path / "src.bin")
    _make_file(src)
    sidecars = {}
    for root in PKGS:
        P = pkg(root)
        dst = str(tmp_path / f"{root}.bin")
        eng = P.FileTransfer(_wan(P, streams=1), record=False,
                             fault_hook=_interrupter(3))
        with pytest.raises(_Interrupt):
            eng.copy(src, dst)
        sidecars[root] = json.load(open(dst + P.ft.SIDECAR_SUFFIX))
    assert sidecars["repro"] == sidecars["repro_torch"]
    assert len(sidecars["repro"]["done"]) == 3
    P = pkg(then)
    dst = str(tmp_path / f"{first}.bin")
    res = P.FileTransfer(_wan(P, streams=1), record=False).copy(src, dst)
    assert res.skipped == 3 and res.sent == res.n_chunks - 3
    assert res.sha256 == P.ft.file_sha256(src)
    assert not os.path.exists(dst + P.ft.SIDECAR_SUFFIX)


# -- the DataGather mirror (tests/test_replicate_sync.py) ---------------------

def _write(path: str, text: str = "x", mtime: int = 1_700_000_000) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    os.utime(path, (mtime, mtime))


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs) + sorted(
        os.path.relpath(r, root) for r, _, _ in os.walk(root))


def mirror_orphan_dirs(P, d):
    _write(f"{d}/src/step_1/a.bin")
    _write(f"{d}/src/step_2/b/c.bin")
    n1 = P.rep.sync_once(f"{d}/src", f"{d}/dst")
    import shutil
    shutil.rmtree(f"{d}/src/step_1")
    shutil.rmtree(f"{d}/src/step_2/b")
    n2 = P.rep.sync_once(f"{d}/src", f"{d}/dst")
    return [n1, n2, _tree(f"{d}/dst")]


def mirror_staging_tmp(P, d):
    _write(f"{d}/src/step_1.tmp/shard.bin")
    _write(f"{d}/src/step_0/shard.bin")
    _write(f"{d}/src/step_0/x.tmp")
    return [P.rep.sync_once(f"{d}/src", f"{d}/dst"), _tree(f"{d}/dst")]


def mirror_same_size_newer(P, d):
    _write(f"{d}/src/shard.bin", "aaaa")
    n1 = P.rep.sync_once(f"{d}/src", f"{d}/dst")
    _write(f"{d}/src/shard.bin", "bbbb", mtime=1_700_000_010)  # same size, newer
    n2 = P.rep.sync_once(f"{d}/src", f"{d}/dst")
    n3 = P.rep.sync_once(f"{d}/src", f"{d}/dst")
    return [n1, n2, n3, open(f"{d}/dst/shard.bin").read()]


def mirror_droppings(P, d):
    _write(f"{d}/src/f.bin", "fresh")
    P.rep.sync_once(f"{d}/src", f"{d}/dst")
    _write(f"{d}/dst/f.bin.part", "x" * 1000)
    _write(f"{d}/dst/f.bin.mpwcp.json", "{}")
    _write(f"{d}/dst/gone.bin.part", "x" * 1000)
    P.rep.sync_once(f"{d}/src", f"{d}/dst")
    return _tree(f"{d}/dst")


def mirror_wan_engine(P, d):
    _write(f"{d}/src/step_10/shard0.bin", "x" * 200_000)
    _write(f"{d}/src/step_10/meta.json", "{}")
    eng = P.FileTransfer(_wan(P, compress="int8", name="mirror-test"))
    return [P.rep.sync_once(f"{d}/src", f"{d}/dst", transfer=eng),
            P.rep.sync_once(f"{d}/src", f"{d}/dst", transfer=eng), _tree(f"{d}/dst"),
            open(f"{d}/dst/step_10/shard0.bin").read() == "x" * 200_000]


MIRRORS = {f.__name__[7:]: f for f in (mirror_orphan_dirs, mirror_staging_tmp,
                                       mirror_same_size_newer, mirror_droppings,
                                       mirror_wan_engine)}


@pytest.mark.parametrize("case", list(MIRRORS))
def test_mirror_case_identical_to_reference(tmp_path, case):
    got = {}
    for root in PKGS:
        d = str(tmp_path / root)
        got[root] = MIRRORS[case](pkg(root), d)
    assert got["repro_torch"] == got["repro"]


def test_mirror_thread_survives_checksum_failure(tmp_path):
    """A pass whose chunk exhausts its CRC retries raises out of ``sync()``;
    the port's background loop and its ``stop()`` drain survive it.  The
    thread is joined with a deadline; how many passes it made is not
    asserted."""
    P = pkg("repro_torch")
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    _write(os.path.join(src, "f.bin"), "payload")
    bad = P.FileTransfer(P.path.local_path(), record=False, max_retries=0,
                         fault_hook=lambda c, h, p: b"\x00" * len(p))
    g = P.rep.DataGather(src, dst, interval_s=0.01, transfer=bad)
    with pytest.raises(P.ChecksumError):
        g.sync()                       # the pass itself fails ...
    g.start()
    passed = threading.Event()
    real = g.sync

    def sync_and_mark():
        try:
            return real()
        finally:
            passed.set()
    g.sync = sync_and_mark
    assert passed.wait(timeout=60)     # ... the loop ran one and is still up
    assert g._thread.is_alive()
    g.stop()                           # the drain does not raise either
    g._thread.join(timeout=60)
    assert not g._thread.is_alive()
    assert not os.path.exists(os.path.join(dst, "f.bin"))
    assert P.rep.DataGather(src, dst).sync() == 1   # a healthy plane mirrors
