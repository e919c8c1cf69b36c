"""Online autotuning in the port's Trainer against the JAX package's, and the
Trainer's and the launcher's other keywords and flags of the reference.

* **Scripted clock** (in this process): both packages' Trainers on one
  rank, smoke qwen1.5-0.5b, ``autotune_every=2``, each fed the same step
  times through a patched ``time.perf_counter`` in its own train-loop
  module.  The same retune sequence (step, config) must come out, with
  the same plan noted in telemetry at each retune and the same tuner
  history; a swap back to a cached config re-notes its plan (``replan``)
  without building a bundle.
* **Real clocks** (spawned gloo ranks, 120 s gloo timeout, joined with a
  deadline): 2 pods, and 2 pods x 2 data ranks under ZeRO (where the tuner
  probes ``bucket_mb``), int8 wire, ``autotune_every=2``.  Only what holds
  whatever the clocks say is asserted: every rank's tuner saw the same
  times, swapped at the same steps to the same configs and built its
  stream groups in step; at least one retune; finite losses; the replicas
  bit-identical after every step (``check_replicas``).  On the 2 x 2 mesh,
  swapping ``bucket_mb`` between 0 and 0.05 (tail mode) and back runs on
  the live state: every step's parameters are bit-identical to a run that
  never swapped (the tail int8 sync is the unbucketed one's bits); with
  no codec the flush bundle's hooks fire in its step alone, and sites of
  one pod each (every pod a gateway) give the plain sync's bits.
* **§C 8**: ``Trainer(replica_dir=, ckpt_every=, keep=, site_groups=,
  retry=)`` (``replica_dir`` and ``retry`` ported since) and
  ``launch/train.py --ckpt-every / --lease-steps``: each works (``--coordinator``
  without ``--route`` stops as the reference's does).
"""
from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sites import GLOO_TIMEOUT, spawn

# step times of the scripted run (sums exact in binary): the first window
# sets the incumbent, the probe of steps 3-5 improves on it, the one of
# steps 6-8 does not
SCRIPT = [1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.75, 0.75, 0.75]
EVERY = 2


class ScriptedClock:
    """``perf_counter`` for a loop that reads the clock twice a step (before
    and after): step k lasts ``dts[k]``."""

    def __init__(self, dts):
        self.dts, self.calls, self.t = list(dts), 0, 0.0

    def perf_counter(self) -> float:
        k, after = divmod(self.calls, 2)
        self.calls += 1
        if after:
            self.t += self.dts[k]
        return self.t


def _plan(tel, key):
    p = tel.get_telemetry().path(key).plan
    return None if p is None else dict(p.__dict__)


def _ref_scripted():
    import jax

    import repro.runtime.train_loop as loop
    from repro.configs import (CommConfig, RunConfig, ShapeConfig, TrainConfig,
                               get_config, smoke_config)
    from repro.core import telemetry as tel
    from repro.data import DataConfig, make_pipeline
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                   comm=CommConfig(mode="hierarchical"), train=TrainConfig())
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=2), prefetch=0)
    tel.get_telemetry().reset()
    tr = loop.Trainer(rc, mesh, autotune_every=EVERY)
    tr.init_or_restore()
    return tr, tel, data, loop


def _port_scripted():
    import repro_torch.runtime.train_loop as loop
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import telemetry as tel
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch.mesh import make_local_mesh
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                   comm=CommConfig(mode="hierarchical"), train=TrainConfig())
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=2), prefetch=0)
    tel.get_telemetry().reset()
    tr = loop.Trainer(rc, make_local_mesh(device="cpu"), autotune_every=EVERY)
    tr.init_or_restore()
    return tr, tel, data, loop


def _scripted_run(make, monkeypatch) -> dict:
    tr, tel, data, loop = make()
    monkeypatch.setattr(loop, "time", types.SimpleNamespace(
        perf_counter=ScriptedClock(SCRIPT).perf_counter))
    key = tr.bundle.path.key
    plans = []

    def log(msg):
        if msg.startswith("[autotune]"):
            plans.append(_plan(tel, key))

    hist = tr.run(iter(data), len(SCRIPT), log_every=0, log=log)
    monkeypatch.undo()
    out = {"retunes": [[s, c] for s, c in tel.get_telemetry().path(key).retunes],
           "plans": plans, "history": [[c, h] for c, h in tr.tuner.history],
           "times": [h["time_s"] for h in hist],
           "stragglers": [h["straggler"] for h in hist],
           "n_bundles": len(tr._bundles)}
    # a swap back to the first config: a cache hit that re-notes its plan
    first = out["retunes"][0][1]
    cfg0 = {k: v for k, v in tr.tuner.history[0][0].items()}
    n = len(tr._bundles)
    tr._retune(cfg0, log=lambda s: None)
    out["swap_back"] = {"built": len(tr._bundles) - n,
                        "plan": _plan(tel, key), "cfg0": cfg0, "first": first}
    return out


@pytest.fixture(scope="module")
def scripted():
    mp = pytest.MonkeyPatch()
    try:
        return _scripted_run(_ref_scripted, mp), _scripted_run(_port_scripted, mp)
    finally:
        mp.undo()


def test_scripted_clock_gives_the_reference_retune_sequence(scripted):
    ref, port = scripted
    assert port["times"] == ref["times"] == SCRIPT
    # one window of 2 after a warm-up step: a retune every third step
    assert [s for s, _ in ref["retunes"]] == [2, 5, 8]
    assert port["retunes"] == ref["retunes"]
    assert port["history"] == ref["history"]
    assert port["n_bundles"] == ref["n_bundles"] == 4


def test_scripted_clock_notes_the_reference_plans(scripted):
    ref, port = scripted
    assert len(port["plans"]) == len(ref["plans"]) == 3
    assert port["plans"] == ref["plans"]
    # each retune noted the plan of the config it swapped to
    for (_, cfg), plan in zip(port["retunes"], port["plans"]):
        assert plan["streams_configured"] == cfg["streams"]
        assert plan["pacing"] == cfg["pacing"] and plan["algo"] == cfg["algo"]


def test_swap_back_to_a_cached_bundle_renotes_its_plan(scripted):
    ref, port = scripted
    for run in (ref, port):
        sb = run["swap_back"]
        assert sb["built"] == 0
        assert sb["plan"]["streams_configured"] == sb["cfg0"]["streams"]
    assert port["swap_back"]["plan"] == ref["swap_back"]["plan"]


def test_first_step_of_each_new_bundle_stays_out_of_the_straggler_detector(scripted):
    """Steps 0, 3, 6 run on new bundles; with step times that jump there the
    detector would flag them otherwise (it flags after 5 samples)."""
    _, port = scripted
    assert not any(port["stragglers"])


# ---------------------------------------------------------------------------
# real clocks on spawned ranks
# ---------------------------------------------------------------------------

STEPS = 6
# name -> (pods, data ranks)
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
SWAP_STEPS = 4
# name -> (codec, swap bucket_mb, site groups)
SWAP_RUNS = {"swapped": ("int8", True, None), "fixed": ("int8", False, None),
             "flush-sites": ("none", True, [[0], [1]]), "flush": ("none", True, None)}


def _rank(rank: int, pods: int, data: int, init: str, out: str) -> None:
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    from repro_torch.core import telemetry as tel
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.train_loop import Trainer
    torch.set_num_threads(1)
    n = pods * data
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n,
                            timeout=GLOO_TIMEOUT)
    try:
        mesh = make_local_mesh(pod=pods, data=data, device="cpu", timeout=GLOO_TIMEOUT)
        cfg = smoke_config(get_config("qwen1.5-0.5b"))
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2 * n)

        def trainer(compress="int8", site_groups=None):
            rc = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2 * n, "train"),
                           comm=CommConfig(mode="hierarchical", compress=compress),
                           train=TrainConfig(warmup_steps=1, total_steps=20, lr=1e-3))
            tr = Trainer(rc, mesh, autotune_every=EVERY, site_groups=site_groups,
                         check_replicas=True)
            tr.init_or_restore(0)
            return tr

        tel.get_telemetry().reset()
        tr = trainer()
        hist = tr.run(iter(make_pipeline(dc, prefetch=0)), STEPS, log_every=0,
                      log=lambda s: None)
        res = {"zero": tr.bundle.zero, "tune_bucket": tr.tuner.tune_bucket,
               "retunes": list(tel.get_telemetry().path(tr.bundle.path.key).retunes),
               "config": [h["config"] for h in hist],
               "fresh": [h["fresh"] for h in hist],
               "tuner_s": [h["tuner_s"] for h in hist],
               "loss": [h["loss"] for h in hist],
               "checksum": [h["checksum"] for h in hist],
               "stream_groups": mesh.n_streams}
        if data > 1:
            # bucket_mb 0 -> 0.05 -> 0 on the live state: int8 (tail mode)
            # against no swap; no codec (flush mode) with one-pod sites
            # against the same swaps without them
            runs = {}
            for name, (codec, swap, sites) in SWAP_RUNS.items():
                t = trainer(codec, sites)
                cfg0 = t.tuner.config()
                t.tuner = None          # the swaps below are the only ones
                it = iter(make_pipeline(dc, prefetch=0))
                state_kept = []
                for k in range(SWAP_STEPS):
                    if swap and k in (1, 2):
                        before = t.state
                        t._retune({**cfg0, "bucket_mb": 0.05 if k == 1 else 0.0},
                                  log=lambda s: None)
                        state_kept.append(t.state is before)
                    t.run(it, 1, log_every=0)
                runs[name] = {k: [h[k] for h in t.history] for k in
                              ("checksum", "bucket_mode", "n_buckets", "n_chunks")}
                runs[name].update(state_kept=state_kept, n_bundles=len(t._bundles))
            res["swap"] = runs
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    res = {}
    for name, (pods, data) in MESHES.items():
        out = tmp_path_factory.mktemp(f"tauto{name}")
        spawn(_rank, pods * data, (pods, data, f"file://{out}/rdv", str(out)))
        res[name] = [json.load(open(f"{out}/rank{r}.json")) for r in range(pods * data)]
    return res


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_rank_swaps_at_the_same_steps_to_the_same_configs(real, mesh):
    ranks = real[mesh]
    r0 = ranks[0]
    assert len(r0["retunes"]) >= 1
    for r in ranks[1:]:
        for k in ("retunes", "config", "fresh", "tuner_s", "stream_groups"):
            assert r[k] == r0[k], (mesh, k)
    # the retunes are the steps after which the config changed
    changed = [i for i in range(1, STEPS) if r0["config"][i] != r0["config"][i - 1]]
    assert [s + 1 for s, _ in r0["retunes"] if s + 1 < STEPS] == changed
    assert max(r0["tuner_s"]) > 0 and r0["fresh"][0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_autotuned_run_trains_with_replicas_in_step(real, mesh):
    ranks = real[mesh]
    pods, data = MESHES[mesh]
    for r in ranks:
        assert all(np.isfinite(r["loss"])), r["loss"]
        assert r["zero"] == (data > 1)
        # bucket_mb is probed exactly where the config can bucket
        assert r["tune_bucket"] == (data > 1)
        assert all("bucket_mb" in c for _, c in r["retunes"]) == (data > 1)
        # stream groups: at most the most streams a step ran with (a plan of
        # fewer chunks than streams uses fewer)
        assert 1 <= r["stream_groups"] <= max(c["streams"] for c in r["config"])
    # check_replicas raised on any divergence; the checksums also agree here
    for d in range(data):
        same = [ranks[p * data + d]["checksum"] for p in range(pods)]
        assert all(s == same[0] for s in same)


def test_bucket_swap_keeps_the_live_state_bit_for_bit(real):
    for r in real["2x2"]:
        sw, fx = r["swap"]["swapped"], r["swap"]["fixed"]
        assert sw["bucket_mode"] == [None, "tail", None, None]
        assert fx["bucket_mode"] == [None] * SWAP_STEPS
        assert sw["state_kept"] == [True, True]
        assert sw["n_bundles"] == 2          # the first bundle, cached, reused
        assert sw["checksum"] == fx["checksum"]


def test_flush_hooks_act_only_in_their_bundle_and_take_site_groups(real):
    """The flush bundle syncs its layer buckets from hooks in the backward;
    swapped back, the unbucketed bundle's step syncs the whole tree once
    (no hook fired).  Sites of one pod each make every pod a gateway: the
    site sync, flush hooks included, gives the plain sync's bits."""
    for r in real["2x2"]:
        fs, fl = r["swap"]["flush-sites"], r["swap"]["flush"]
        for run in (fs, fl):
            assert run["bucket_mode"] == [None, "flush", None, None]
            assert run["n_buckets"][1] >= 3 and run["n_buckets"][2:] == [0, 0]
            assert run["n_chunks"][2:] == [run["n_chunks"][0]] * 2
            assert run["state_kept"] == [True, True]
        assert fs["checksum"] == fl["checksum"]


# ---------------------------------------------------------------------------
# §C 8: the reference's keywords and flags
# ---------------------------------------------------------------------------

def _rc():
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config, smoke_config)
    return RunConfig(model=smoke_config(get_config("qwen1.5-0.5b")),
                     shape=ShapeConfig("t", 16, 2, "train"),
                     comm=CommConfig(mode="hierarchical", autotune=False),
                     train=TrainConfig())


def _one_pod():
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(device="cpu")


def test_trainer_replica_dir_names_its_item(tmp_path):
    """Ported since: `replica_dir` goes to the checkpoint manager, and is
    unused without `ckpt_dir`, as in the reference."""
    from repro_torch.runtime.train_loop import Trainer
    assert Trainer(_rc(), _one_pod(), replica_dir=str(tmp_path / "r")).manager is None
    tr = Trainer(_rc(), _one_pod(), ckpt_dir=str(tmp_path / "c"),
                 replica_dir=str(tmp_path / "r"))
    assert tr.manager.replica_dir == str(tmp_path / "r")
    assert tr.manager.transfer is None     # no route: the local mirror


def test_trainer_retry_names_its_item():
    """Ported since: the fault-recovery budget, the reference's default 8."""
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.runtime.train_loop import Trainer
    assert Trainer(_rc(), _one_pod(), retry=RetryPolicy(max_attempts=2)
                   ).retry.max_attempts == 2
    assert Trainer(_rc(), _one_pod()).retry.max_attempts == 8


def test_trainer_keeps_ckpt_every():
    from repro_torch.runtime.train_loop import Trainer
    assert Trainer(_rc(), _one_pod(), ckpt_every=7).ckpt_every == 7
    assert Trainer(_rc(), _one_pod()).ckpt_every == 50     # the reference's default


def test_trainer_keeps_keep():
    from repro_torch.runtime.train_loop import Trainer
    assert Trainer(_rc(), _one_pod(), keep=2).keep == 2
    assert Trainer(_rc(), _one_pod()).keep == 3            # the reference's default


def test_trainer_takes_site_groups():
    """One pod has nothing to group: the step runs as without them."""
    from repro_torch.runtime.train_loop import Trainer
    tr = Trainer(_rc(), _one_pod(), site_groups=[[0]])
    tr.init_or_restore(0)
    toks = np.random.default_rng(0).integers(0, 100, (2, 17))
    hist = tr.run(iter([toks]), 1, log_every=0)
    assert tr.site_groups == [[0]] and np.isfinite(hist[0]["loss"])


def test_launcher_takes_ckpt_every_without_ckpt_dir(capsys):
    from repro_torch.launch.train import main
    main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "1",
          "--seq-len", "16", "--global-batch", "2", "--ckpt-every", "5"])
    assert "[train] done: loss" in capsys.readouterr().out


def test_launcher_takes_lease_steps_and_queues_coordinator(capsys):
    from repro_torch.launch.train import main, parser
    assert parser().parse_args(["--arch", "x", "--lease-steps", "3"]).lease_steps == 3
    main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "1",
          "--seq-len", "16", "--global-batch", "2", "--lease-steps", "3"])
    assert "[train] done: loss" in capsys.readouterr().out
    # --coordinator is ported; without --route it stops as the reference's does
    with pytest.raises(SystemExit, match="--coordinator needs --route"):
        main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
              "--lease-steps", "3", "--coordinator", "amsterdam"])
