"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the 5-request trace of tests/test_serving.py with the
JAX package's own parameters (the port's through ``params_from_jax``), for
the none, bf16 and int8 KV wire codecs.  Checked: the batcher timeline and
stats are identical; per-request and per-hop telemetry wire bytes are
identical; tokens are equal up to the first step where the reference's own
top-1/top-2 logit margin is within twice the model tolerance (5e-2 with
bf16 parameters, see tests/test_torch_model.py) — past such a near tie the
two greedy decodes may rightly part.  The port's mono and disagg-none tokens
are bit-identical.  Also: the port imports neither jax nor ``repro``, and
without a card it refuses to build an engine without ``device=``.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CommConfig as JCommConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core.path import WAN_LONDON_POZNAN as J_WAN_LP
from repro.core.path import WidePath as JWidePath
from repro.core.telemetry import get_telemetry as j_get_telemetry
from repro.launch.mesh import make_local_mesh
from repro.models.param import tree_init as j_tree_init
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig, TrainConfig,
                                 get_config, smoke_config)
from repro_torch.core.path import WAN_LONDON_POZNAN, WidePath
from repro_torch.core.telemetry import get_telemetry
from repro_torch.models.param import params_from_jax
from repro_torch.runtime import ServingEngine
from test_serving import _requests

REPO = Path(__file__).resolve().parents[1]
TOL = 5e-2          # bf16 parameters (tests/test_torch_model.py)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_smoke_config(j_get_config("llama3.2-3b"))
    jrc = JRunConfig(model=jcfg, shape=JShapeConfig("d", 64, 3, "decode"),
                     comm=JCommConfig(), train=JTrainConfig())
    rc = RunConfig(model=smoke_config(get_config("llama3.2-3b")),
                   shape=ShapeConfig("d", 64, 3, "decode"), comm=CommConfig(),
                   train=TrainConfig())
    mesh = make_local_mesh()
    from repro.models import build_model
    jmodel = build_model(jcfg)
    jparams = j_tree_init(jmodel.param_defs(), 0)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jrc=jrc, rc=rc, mesh=mesh, jmodel=jmodel, jparams=jparams,
                pparams=pparams, reqs=_requests(jcfg))


def _paths(compress: str):
    return (JWidePath(axis="pod", comm=JCommConfig(streams=4, chunk_mb=0.001,
                                                   compress=compress),
                      link=J_WAN_LP, name="kvship"),
            WidePath(axis="pod", comm=CommConfig(streams=4, chunk_mb=0.001,
                                                 compress=compress),
                     link=WAN_LONDON_POZNAN, name="kvship"))


def _reset(tels, reqs, path):
    for t in tels:
        for rid in range(len(reqs)):
            key = f"serve/req{rid}/kv"
            t.reset(key)
            for h, hop in enumerate(path.route):
                t.reset(f"{key}/hop{h}:{hop.name}")


def _run(engine, reqs):
    for prompt, mnew in reqs:
        assert engine.submit(prompt, mnew) is not None
    stats = engine.run_to_completion()
    assert stats["completed"] == len(reqs)
    return stats


def _margin(setup, context: np.ndarray) -> float:
    """The reference's top-1 minus top-2 logit after `context`."""
    logits, _ = setup["jmodel"].prefill(
        setup["jparams"], {"tokens": jnp.asarray(context[None], jnp.int32)})
    top = np.sort(np.asarray(logits[0, -1], np.float32))
    return float(top[-1] - top[-2])


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_disagg_engine_matches_reference(setup, compress):
    reqs = setup["reqs"]
    jpath, ppath = _paths(compress)
    jtel, ptel = j_get_telemetry(), get_telemetry()
    _reset((jtel, ptel), reqs, ppath)
    ref = JServingEngine(setup["jrc"], setup["mesh"], mode="disagg", path=jpath,
                         params=setup["jparams"])
    port = ServingEngine(setup["rc"], mode="disagg", path=ppath,
                         params=setup["pparams"], device="cpu")
    rstats, pstats = _run(ref, reqs), _run(port, reqs)
    assert port.batcher.timeline() == ref.batcher.timeline()
    assert pstats == rstats
    for rid in range(len(reqs)):
        key = f"serve/req{rid}/kv"
        keys = [key] + [f"{key}/hop{h}:{hop.name}" for h, hop in enumerate(ppath.route)]
        for k in keys:
            assert ptel.path(k).total_bytes == jtel.path(k).total_bytes > 0, k
            assert ptel.path(k).transfers == jtel.path(k).transfers == 1, k
    for rid, (prompt, mnew) in enumerate(reqs):
        r, p = ref.results[rid], port.results[rid]
        assert len(r) == len(p) == mnew
        diff = np.flatnonzero(r != p)
        if diff.size:
            t = int(diff[0])
            m = _margin(setup, np.concatenate([prompt, r[:t]]))
            assert m <= 2 * TOL, (f"req{rid} parts from the reference at token "
                                  f"{t} where the reference's margin is {m}")


def test_port_mono_and_disagg_none_bit_identical(setup):
    reqs = setup["reqs"]
    _, path = _paths("none")
    engines = {}
    for mode, p in (("mono", None), ("disagg", path)):
        engines[mode] = ServingEngine(setup["rc"], mode=mode, path=p,
                                      params=setup["pparams"], device="cpu")
        _run(engines[mode], reqs)
    mono, dis = engines["mono"], engines["disagg"]
    assert mono.batcher.timeline() == dis.batcher.timeline()
    assert sorted(mono.results) == sorted(dis.results) == list(range(len(reqs)))
    for rid in mono.results:
        np.testing.assert_array_equal(mono.results[rid], dis.results[rid])
    assert len(dis.timings["decode_s"]) > 0
    assert len(dis.timings["prefill_s"]) == len(reqs)


def test_engine_rejects_bad_mode_and_missing_path(setup):
    with pytest.raises(ValueError, match="mode must be"):
        ServingEngine(setup["rc"], mode="split", device="cpu")
    with pytest.raises(ValueError, match="needs a WidePath"):
        ServingEngine(setup["rc"], mode="disagg", device="cpu")


def test_no_card_no_default_device(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(setup["rc"])


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for name in _imported_modules(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {name}"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "n = sum(1 for k in sys.modules if k.startswith('repro_torch'))\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout


# ---------------------------------------------------------------------------
# Server: per-sequence positions, EOS early exit, warm-shape keys
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(setup):
    from dataclasses import replace
    from repro_torch.runtime import Server
    rc2 = replace(setup["rc"], shape=ShapeConfig("d", 64, 2, "decode"))
    return Server(rc2, params=setup["pparams"], device="cpu")


def test_server_vector_pos_matches_single_row_runs(server):
    prompts = np.array([[5], [9]])
    res = server.generate(prompts, max_new=4, prefill_pos=np.array([3, 7]))
    assert res.tokens.shape == (2, 4) and res.lengths.tolist() == [4, 4]
    for row, p in ((0, 3), (1, 7)):
        ref = server.generate(np.repeat(prompts[row:row + 1], 2, axis=0),
                              max_new=4, prefill_pos=p)
        np.testing.assert_array_equal(res.tokens[row], ref.tokens[0])


def test_server_budget_eos_and_padding(server):
    prompts = np.array([[5], [9]])
    res = server.generate(prompts, max_new=6, max_new_per_seq=np.array([2, 5]))
    assert res.steps == 5 and res.lengths.tolist() == [2, 5]
    assert (res.tokens[0, 2:] == 0).all()
    ref = server.generate(prompts, max_new=6, prefill_pos=0)
    eos = int(ref.tokens[0, 1])
    exp0 = int(np.argmax(ref.tokens[0] == eos)) + 1
    res = server.generate(prompts, max_new=6, prefill_pos=0, eos_id=eos, pad_id=-1)
    assert res.lengths[0] == exp0 and (res.tokens[0, exp0:] == -1).all()


def test_server_warm_shapes_include_cache_geometry(server):
    from repro_torch.models.param import tree_init
    tel = get_telemetry()
    key = server.bundle.path.key
    prompts = np.array([[5], [9]])
    server.generate(prompts, max_new=3)
    n0 = tel.path(key).transfers
    server.generate(prompts, max_new=3)
    assert tel.path(key).transfers - n0 == 3          # warm: every step
    small = tree_init(server.bundle.model.cache_defs(2, 32), 0, device="cpu")
    n1 = tel.path(key).transfers
    server.generate(prompts, max_new=3, cache=small)
    assert tel.path(key).transfers - n1 == 2          # first step skipped


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3.2-3b",
         "--smoke", "--device", "cpu", "--engine", "disagg", "--compress", "int8",
         "--requests", "3", "--tokens", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "completed=3" in out.stdout and "device=cpu" in out.stdout
