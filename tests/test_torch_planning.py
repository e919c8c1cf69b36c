"""The port's planning layer against the JAX package's, on the CPU.

The copied modules (configs, path, telemetry, autotune, retry, the continuous
batcher) and the ported chunk planner and KV shipper must give the same
answers as the reference for the same inputs: the same chunks and streams,
the same KV-ship plans for every wire codec, the same modeled seconds, the
same golden batcher timeline, and the same `Report` text.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import CommConfig as JCommConfig
from repro.configs import get_config as j_get_config
from repro.core import autotune as j_autotune
from repro.core import kvship as j_kvship
from repro.core import streams as j_streams
from repro.core import telemetry as j_tel
from repro.core.path import WAN_LONDON_POZNAN as J_WAN_LP
from repro.core.path import WAN_POZNAN_GDANSK as J_WAN_PG
from repro.core.path import Hop as JHop
from repro.core.path import WidePath as JWidePath
from repro.core.retry import KVSHIP_RETRY as J_KVSHIP_RETRY
from repro.core import serving as j_serving
from repro.core.serving import ContinuousBatcher as JBatcher
from repro_torch.configs import CommConfig, get_config
from repro_torch.core import autotune, kvship, streams
from repro_torch.core import serving as port_serving
from repro_torch.core import telemetry as tel
from repro_torch.core.path import WAN_LONDON_POZNAN, WAN_POZNAN_GDANSK, Hop, WidePath
from repro_torch.core.retry import KVSHIP_RETRY
from repro_torch.core.serving import ContinuousBatcher
from test_serving import GOLDEN_TIMELINE, GOLDEN_TRACE


def _leaves(shapes, dtype: str):
    """The same leaves for both packages: numpy (JAX package), torch (port)."""
    if dtype == "bfloat16":
        import ml_dtypes
        np_dt = ml_dtypes.bfloat16
    else:
        np_dt = np.float32
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([a.astype(np_dt) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _two_hop(compress: str, port: bool):
    mod = (CommConfig, Hop, WidePath, WAN_LONDON_POZNAN, WAN_POZNAN_GDANSK) if port \
        else (JCommConfig, JHop, JWidePath, J_WAN_LP, J_WAN_PG)
    Comm, H, WP, lp, pg = mod
    comm = Comm(streams=4, chunk_mb=0.001, compress=compress)
    hops = (H(name="hop0-lon-poz", link=lp, comm=comm),
            H(name="hop1-poz-gda", link=pg, comm=comm))
    return WP(axis="pod", comm=comm, name="kvship").with_hops(hops)


# ---------------------------------------------------------------------------
# chunk planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_bytes,n_streams", [(1 << 10, 3), (4096, 8),
                                                   (1 << 20, 16), (300, 5)])
def test_plan_chunks_and_streams_match(chunk_bytes, n_streams):
    shapes = [(7, 33), (64, 4, 2), (1,), (128,), (5, 5, 5)]
    jl, pl = _leaves(shapes, "float32")
    dims = [0, 1, None, 0, -1]
    jd = j_streams.normalize_dims(jl, dims)
    pd = streams.normalize_dims(pl, dims)
    assert jd == pd
    jc = j_streams.plan_chunks(jl, jd, chunk_bytes)
    pc = streams.plan_chunks(pl, pd, chunk_bytes)
    assert [tuple(vars(c).values()) for c in jc] == [tuple(vars(c).values()) for c in pc]
    jb = j_streams.assign_streams(jc, n_streams)
    pb = streams.assign_streams(pc, n_streams)
    key = lambda bs: [[(c.leaf, c.start, c.size, c.nbytes) for c in b] for b in bs]
    assert key(jb) == key(pb)
    for algo, world, compress in [("psum", 4, "int8"), ("ring", 3, "bf16"),
                                  ("shift", 1, "none")]:
        assert (j_streams.plan_summary(jc, jb, n_streams, chunk_bytes, 0.5,
                                       algo=algo, world=world, compress=compress)
                == streams.plan_summary(pc, pb, n_streams, chunk_bytes, 0.5,
                                        algo=algo, world=world, compress=compress))
    for leaf_j, leaf_p in zip(jl, pl):
        assert j_streams.leaf_bytes(leaf_j) == streams.leaf_bytes(leaf_p)
        assert (j_streams.chunk_rows(leaf_j, 0, chunk_bytes)
                == streams.chunk_rows(leaf_p, 0, chunk_bytes))


def test_slice_and_stitch_round_trip():
    x = torch.arange(40.0).reshape(10, 4)
    chunks = streams.plan_chunks([x], [0], 3 * 16)
    pieces = [(c, streams.slice_chunk(x, c)) for c in chunks]
    assert [p.shape[0] for _, p in pieces] == [3, 3, 3, 1]
    assert torch.equal(streams.stitch_leaf(x, pieces[::-1]), x)


# ---------------------------------------------------------------------------
# KV-ship plans and shipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plan_kv_ship_matches(compress, dtype):
    cfg = get_config("llama3.2-3b")
    shape = (cfg.num_layers, 333, cfg.num_kv_heads, cfg.resolved_head_dim)
    jt = {n: np.zeros(shape, dtype=_leaves([(1,)], dtype)[0][0].dtype) for n in "kv"}
    pt = {n: torch.empty(shape, dtype=getattr(torch, dtype), device="meta") for n in "kv"}
    for streams_, chunk_mb in [(16, 8.0), (4, 0.5), (64, 1.0)]:
        jp = JWidePath(axis="pod", comm=JCommConfig(streams=streams_, chunk_mb=chunk_mb,
                                                    compress=compress),
                       link=J_WAN_LP, name="kvship")
        pp = WidePath(axis="pod", comm=CommConfig(streams=streams_, chunk_mb=chunk_mb,
                                                  compress=compress),
                      link=WAN_LONDON_POZNAN, name="kvship")
        a, b = j_kvship.plan_kv_ship(jt, jp), kvship.plan_kv_ship(pt, pp)
        assert b.dtype == a.dtype == dtype
        assert [tuple(vars(c).values()) for c in a.chunks] == \
               [tuple(vars(c).values()) for c in b.chunks]
        assert (a.leaf_names, a.shapes, a.streams_used, a.payload_bytes,
                a.wire_bytes_hop, a.wire_bytes_total) == \
               (b.leaf_names, b.shapes, b.streams_used, b.payload_bytes,
                b.wire_bytes_hop, b.wire_bytes_total)
        assert a.load_balance == b.load_balance


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_ship_kv_bytes_and_payload_match(compress):
    """Two hops, float32 KV: same per-hop telemetry bytes and modeled
    seconds, and the same decoded KV bit for bit (the int8 codec's quant and
    dequant are exact)."""
    jl, pl = _leaves([(4, 24, 2, 8), (4, 24, 2, 8)], "float32")
    jkv, pkv = dict(zip("kv", jl)), dict(zip("kv", pl))
    jpath, ppath = _two_hop(compress, port=False), _two_hop(compress, port=True)
    jplan, pplan = j_kvship.plan_kv_ship(jkv, jpath), kvship.plan_kv_ship(pkv, ppath)
    rid = {"none": 910, "bf16": 911, "int8": 912}[compress]
    key = f"serve/req{rid}/kv"
    j_tel.get_telemetry().reset(key)
    tel.get_telemetry().reset(key)
    jout, jres = j_kvship.ship_kv(jkv, jplan, rid)
    pout, pres = kvship.ship_kv(pkv, pplan, rid)
    assert (pres.wire_bytes_hop, pres.wire_bytes_total, pres.n_chunks) == \
           (jres.wire_bytes_hop, jres.wire_bytes_total, jres.n_chunks)
    assert pres.modeled_s == jres.modeled_s and pres.per_hop_s == jres.per_hop_s
    for k in [key] + [f"{key}/hop{i}:{h.name}" for i, h in enumerate(ppath.route)]:
        assert (tel.get_telemetry().path(k).total_bytes
                == j_tel.get_telemetry().path(k).total_bytes), k
    for n in "kv":
        np.testing.assert_array_equal(pout[n].numpy(), np.asarray(jout[n]))


def test_ship_kv_rejects_geometry_drift():
    kv = {n: torch.zeros((4, 8, 2, 8)) for n in "kv"}
    plan = kvship.plan_kv_ship(kv, _two_hop("none", port=True))
    grown = {"k": torch.zeros((4, 9, 2, 8)), "v": kv["v"]}
    with pytest.raises(ValueError, match="re-plan on cache-geometry change"):
        kvship.ship_kv(grown, plan, 913)
    with pytest.raises(ValueError, match="unknown KV wire codec"):
        kvship._encode_decode(kv["k"], "fp8")


def test_kv_cache_bytes_formula_matches():
    for args in [(4, 2, 32, 8), (28, 8, 128, 1024)]:
        assert kvship.kv_cache_bytes(*args) == j_kvship.kv_cache_bytes(*args)
    cfg = get_config("llama3.2-3b")
    per_token = kvship.kv_cache_bytes(cfg.num_layers, cfg.num_kv_heads,
                                      cfg.resolved_head_dim, 1)
    assert per_token == 112 * 1024


# ---------------------------------------------------------------------------
# link model, autotuner, retry policy
# ---------------------------------------------------------------------------

def test_link_model_and_tuner_match():
    for nbytes in (1e3, 7.5e6, 2.3e9):
        for s, cb, pace in [(1, 1 << 20, 1.0), (16, 8 << 20, 0.5), (64, 1 << 16, 0.25)]:
            assert (autotune.simulate_transfer_s(nbytes, WAN_LONDON_POZNAN, streams=s,
                                                 chunk_bytes=cb, pacing=pace)
                    == j_autotune.simulate_transfer_s(nbytes, J_WAN_LP, streams=s,
                                                      chunk_bytes=cb, pacing=pace))
        assert (vars(autotune.tune(int(nbytes), WAN_LONDON_POZNAN))
                == vars(j_autotune.tune(int(nbytes), J_WAN_LP)))
        for world, algo, compress in [(4, "psum", "int8"), (3, "ring", "bf16")]:
            assert (autotune.simulate_transfer_s(nbytes, WAN_LONDON_POZNAN, streams=8,
                                                 chunk_bytes=1 << 20, world=world,
                                                 algo=algo, compress=compress)
                    == j_autotune.simulate_transfer_s(nbytes, J_WAN_LP, streams=8,
                                                      chunk_bytes=1 << 20, world=world,
                                                      algo=algo, compress=compress))
    assert [KVSHIP_RETRY.delay_s(a, key=k) for a in range(4) for k in (0, 7)] == \
           [J_KVSHIP_RETRY.delay_s(a, key=k) for a in range(4) for k in (0, 7)]


# ---------------------------------------------------------------------------
# continuous batcher and telemetry report
# ---------------------------------------------------------------------------

def test_batcher_golden_timeline_matches():
    kw = dict(prefill_steps=lambda r: max(1, r.prompt_len // 8), ship_steps=1,
              step_s=1e-2)
    port, ref = ContinuousBatcher(2, 4, **kw), JBatcher(2, 4, **kw)
    ps, rs = port.run(GOLDEN_TRACE), ref.run(GOLDEN_TRACE)
    assert port.timeline() == GOLDEN_TIMELINE == ref.timeline()
    assert ps == rs


def _ship_steps(kv_bytes, cfg, modeled_ship_steps, path):
    def ship_steps(req):
        return modeled_ship_steps(kv_bytes(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.resolved_head_dim, req.prompt_len),
                                  path, 25e-3)
    return ship_steps


def test_batcher_kv_bytes_model_matches():
    cfg, jcfg = get_config("llama3.2-3b"), j_get_config("llama3.2-3b")
    path = WidePath(link=WAN_LONDON_POZNAN)
    jpath = JWidePath(link=J_WAN_LP)
    runs = []
    for B, P, kvb, c, ship in (
            (ContinuousBatcher, path, kvship.kv_cache_bytes, cfg,
             port_serving.modeled_ship_steps),
            (JBatcher, jpath, j_kvship.kv_cache_bytes, jcfg,
             j_serving.modeled_ship_steps)):
        b = B(2, 4, ship_steps=_ship_steps(kvb, c, ship, P), step_s=25e-3,
              deadline_steps=40)
        stats = b.run([(0, 256, 2), (0, 512, 3), (1, 64, 4), (3, 1024, 2)])
        runs.append((b.timeline(), stats))
    assert runs[0] == runs[1]


def test_report_text_matches():
    port, ref = tel.Telemetry(), j_tel.Telemetry()
    for t in (port, ref):
        t.note_plan("kvship:lon-poz", payload_bytes=123456, n_chunks=7,
                    streams_used=4, streams_configured=16, chunk_bytes=1 << 20,
                    pacing=0.5, load_balance=1.25, algo="shift", wire_bytes=33333)
        for i, s in enumerate((0.01, 0.02, 0.015)):
            t.record("kvship:lon-poz", s, nbytes=123456, step=i)
            t.record("serve/req0/kv/hop0:lon-poz", s / 2, nbytes=1000, step=i)
        t.path("grad:interpod").note_overlap(0.004, 0.012)
        t.record("grad:interpod", 0.05, nbytes=1 << 30)
    assert port.format_report() == ref.format_report()
    assert port.report() == ref.report()
