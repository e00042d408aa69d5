"""The data axis launched from one command (eld_tpu_torch/parallel/launch.py)
and the rank-card rule (config.rank_card), on the CPU.

``--mesh_data D`` with no launcher around the entry point starts D ranks
itself; on ``--device cpu`` they are gloo ranks, which stand in for the
virtual CPU devices of eld_tpu's mesh_data=2 Engine.  The launched runs
are child processes of this file's module fixture, started before the
first test so that the one-process tests and eld_tpu's Engine run while
they work, each in a process group of its own that is killed at its
timeout:

  * ``launch``: ``python -c`` calling ``_session`` below, which runs
    ``train_real.main(... --mesh_data 2)``, a ``launch`` of ``_probe``
    (both ranks' weights, torchrun's variables, their ``sys.modules``)
    and a ``launch`` of ``_fail`` (rank 1 raises while rank 0 waits for
    it in the rendezvous);
  * ``torchrun0`` / ``torchrun1``: the same argv as two explicit
    torchrun-style children (torchrun's variables and OMP_NUM_THREADS=1);
  * ``cli``: ``python -X importtime -m eld_tpu_torch.tools.train_real ...
    --mesh_data 2``, so every process's imports are logged (spawn starts
    the ranks with the parent's interpreter flags and re-imports its
    ``__main__``, the entry point);
  * ``cli_fails``: the same with ``-b 3``, which does not split over 2.

This module imports no JAX at its top, so a rank that unpickles one of
its functions imports none.
"""

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch
import torch.distributed as dist

from eld_tpu_torch.config import Config, rank_card
from eld_tpu_torch.parallel import launch as launch_mod
from eld_tpu_torch.parallel.launch import launch, plan_ranks, run_ranks
from eld_tpu_torch.parallel.multihost import maybe_initialize_multihost
from eld_tpu_torch.tools import test_eld, test_sid, train_real, train_syn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SESSION_TIMEOUT_S = 180
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
NAMES = ("SID_Sony_input_Raw.eps", "SID_Sony_target_Raw.eps")  # train_real's stores
SEED = 21
STEPS = 4  # one epoch of 8 paired patches at a global batch of 2
ENTRY_POINTS = {"train_syn": train_syn, "train_real": train_real, "test_sid": test_sid,
                "test_eld": test_eld}


@pytest.fixture(autouse=True)
def no_launcher(monkeypatch):
    """No torchrun variables around the one-process tests."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def _argv(root, name):
    return ["--traindir", os.path.join(root, "train"), "--evaldir", os.path.join(root, "none"),
            "--device", "cpu", "--base_width", "4", "-b", "2", "--epochs", "1", "--no-verbose",
            "--nThreads", "0", "--seed", str(SEED), "--checkpoints_dir",
            os.path.join(root, "ck"), "--name", name]


def _foreign_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "eld_tpu"))


# ---- what the launched ranks run (module level: they pickle by reference) --

def _probe(argv):
    """A rank of train_real.main: what it was given and what it holds."""
    engine = train_real.main(argv)
    return {"rank": engine.rank, "world": engine.world, "argv": argv[-3:],
            "env": {k: os.environ.get(k) for k in TORCHRUN_ENV},
            "threads": torch.get_num_threads(), "iterations": engine.iterations,
            "state_dict": {k: v.detach().clone() for k, v in engine.model.state_dict().items()},
            "modules": _foreign_modules()}


def _fail(argv):
    """Rank 1 raises once rank 0 is waiting for it in the rendezvous."""
    from eld_tpu_torch.parallel.multihost import initialize_multihost

    workdir, rank = argv[0], int(os.environ["RANK"])
    with open(os.path.join(workdir, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    if rank == 0:
        initialize_multihost(backend="gloo")
        dist.barrier()
        return "rank 0 was not stopped"
    deadline = time.monotonic() + 60
    while not os.path.exists(os.path.join(workdir, "pid0")) and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(1.0)
    raise ValueError("rank 1 fails on purpose")


def _session(root):
    res = {}
    rec = train_real.main(_argv(root, "launched") + ["--mesh_data", "2"])
    res["record"] = dataclasses.asdict(rec)
    res["probes"] = launch(_probe, _argv(root, "probed") + ["--no-log"], 2, "cpu")
    failed = os.path.join(root, "failed")
    os.makedirs(failed)
    t0 = time.monotonic()
    try:
        res["failure"] = f"returned {launch(_fail, [failed], 2, 'cpu')}"
    except RuntimeError as e:
        res["failure"] = str(e)
    res["failure_s"] = time.monotonic() - t0
    res["pids"] = [int(open(os.path.join(failed, f"pid{r}")).read()) for r in range(2)]
    res["modules"] = _foreign_modules()
    torch.save(res, os.path.join(root, "session.pt"))


# ---- the sessions --------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(name, root, cmd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV + ("OMP_NUM_THREADS",)}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    log = open(os.path.join(root, f"{name}.log"), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                            start_new_session=True)
    return {"proc": proc, "log": log, "deadline": time.monotonic() + SESSION_TIMEOUT_S}


def _kill(run):
    if run["proc"].poll() is None:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait()
    run["log"].close()


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The sessions, started before the module's first test; none
    outlives the module."""
    from tests.test_torch_paired import _paired_stores

    root = str(tmp_path_factory.mktemp("launch"))
    _paired_stores(os.path.join(root, "train"), NAMES)
    py, port = sys.executable, _free_port()
    torchrun = [py, "-m", "eld_tpu_torch.tools.train_real", *_argv(root, "torchrun"),
                "--multihost", "--mesh_data", "2"]
    runs = {"launch": _spawn("launch", root, [
        py, "-c", "import sys; from tests.test_torch_launch import _session; _session(sys.argv[1])",
        root])}
    for r in range(2):
        runs[f"torchrun{r}"] = _spawn(f"torchrun{r}", root, torchrun, {
            "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"})
    cli = ["-m", "eld_tpu_torch.tools.train_real", "--mesh_data", "2"]
    runs["cli"] = _spawn("cli", root, [py, "-X", "importtime", *cli, *_argv(root, "cli")])
    runs["cli_fails"] = _spawn("cli_fails", root, [py, *cli, *_argv(root, "cli_fails"),
                                                   "-b", "3"])
    yield root, runs
    for run in runs.values():
        _kill(run)


@pytest.fixture(scope="module")
def finished(started):
    """{session: (exit code or None if killed at its timeout, its log)}."""
    root, runs = started
    out = {}
    for name, run in runs.items():
        try:
            rc = run["proc"].wait(timeout=max(0.0, run["deadline"] - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        _kill(run)
        out[name] = (rc, open(os.path.join(root, f"{name}.log")).read())
    return root, out


def _ok(finished, name):
    root, out = finished
    rc, log = out[name]
    if rc != 0:
        pytest.fail(f"{name} exited {rc} (None: killed at {SESSION_TIMEOUT_S} s)\n{log[-4000:]}")
    return root, log


@pytest.fixture(scope="module")
def session(finished):
    root, _ = _ok(finished, "launch")
    return torch.load(os.path.join(root, "session.pt"), weights_only=True)


def _checkpoint(root, name):
    path = os.path.join(root, "ck", name, "model_latest.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


# ---- the rank-card rule (F4) ----------------------------------------------

@pytest.mark.parametrize("device,local_rank,want", [
    ("cuda", 0, 0), ("cuda", 1, 1), ("cuda", 2, 2), ("cuda", 3, 3), ("cuda:1", 1, 2),
    ("cuda:2", 0, 2)])
def test_rank_card(device, local_rank, want):
    assert rank_card(device, local_rank, cards=4) == torch.device("cuda", want)


@pytest.mark.parametrize("device,local_rank", [("cuda", 4), ("cuda:1", 3), ("cuda:4", 0)])
def test_rank_card_refuses_a_card_past_the_visible_ones(device, local_rank):
    index = (torch.device(device).index or 0) + local_rank
    with pytest.raises(ValueError, match=f"4 CUDA cards are visible.*cuda:{index} is missing"):
        rank_card(device, local_rank, cards=4)


@pytest.mark.parametrize("device,local_rank,want", [("cuda", 1, 1), ("cuda:1", 1, 2),
                                                    ("cuda:2", 0, 2)])
def test_nccl_group_is_bound_to_the_ranks_card(monkeypatch, device, local_rank, want):
    """Under torchrun's variables the NCCL group's ``device_id`` and the
    current card are ``rank_card``'s, the card the rank's Engine takes."""
    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.update(current=d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k, v in (("RANK", str(local_rank)), ("WORLD_SIZE", "4"), ("LOCAL_RANK", str(local_rank)),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    maybe_initialize_multihost(Config(device=device, multihost=True))
    assert seen["backend"] == "nccl" and seen["init_method"] == "env://"
    assert seen["device_id"] == seen["current"] == torch.device("cuda", want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from eld_tpu_torch.config import torch_device
    assert torch_device(device) == torch.device("cuda", want)


# ---- planning the ranks ----------------------------------------------------

@pytest.mark.parametrize("device,data,spatial,cards,want", [
    ("cpu", -1, 1, 0, 1), ("cpu", 2, 1, 0, 2), ("cpu", 4, 1, 8, 4), ("cpu", 1, 2, 0, 1),
    ("cuda", -1, 1, 1, 1), ("cuda", -1, 1, 4, 4), ("cuda", -1, 1, 8, 8), ("cuda", 1, 1, 4, 1),
    ("cuda", 4, 1, 4, 4), ("cuda:2", -1, 1, 8, 6), ("cuda:1", 2, 1, 4, 2),
    ("cuda:3", -1, 1, 2, 1), ("cuda", -1, 2, 8, 1), ("cuda", 1, 4, 8, 1)])
def test_plan_ranks(capsys, device, data, spatial, cards, want):
    """No launcher: -1 is every visible card from --device's on (1 on the
    CPU), an explicit D stands; -1 beside --mesh_spatial S > 1 is one rank,
    said once."""
    cfg = Config(device=device, mesh_data=data, mesh_spatial=spatial)
    assert plan_ranks(cfg, cards) == want
    said = capsys.readouterr().err.count("the data axis is one rank")
    assert said == (1 if spatial > 1 and data < 0 else 0)


@pytest.mark.parametrize("device,data,cards", [("cuda", -1, 8), ("cuda", 2, 8), ("cpu", 3, 0)])
def test_plan_ranks_under_a_launcher_is_the_world(monkeypatch, device, data, cards):
    """Under torchrun's variables D is the world size whatever the flags
    say (the Engine refuses a --mesh_data that is not); nothing launches."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    cfg = Config(device=device, mesh_data=data)
    assert plan_ranks(cfg, cards) == 4
    monkeypatch.setattr(launch_mod, "launch", lambda *a: pytest.fail("launched under a launcher"))
    assert run_ranks(train_syn.main, [], cfg) is None


@pytest.mark.parametrize("device,data,spatial,cards,match", [
    ("cuda", 5, 1, 4, "cuda:0..cuda:4, have 4 visible cards: cuda:4 is missing"),
    ("cuda:3", 2, 1, 4, "cuda:3..cuda:4, have 4 visible cards: cuda:4 is missing"),
    ("cuda", 2, 1, 0, "have 0 visible cards: cuda:0 is missing"),
    ("cuda", 2, 2, 8, "2 x 2 grid of 4 cards in one command.*not supported yet"),
    ("cpu", 2, 2, 0, "2 x 2 grid of 4 cards in one command.*not supported yet")])
def test_plan_ranks_refusals(device, data, spatial, cards, match):
    with pytest.raises(ValueError, match=match):
        plan_ranks(Config(device=device, mesh_data=data, mesh_spatial=spatial), cards)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_refuse_more_ranks_than_cards_before_anything_starts(
        tmp_path, monkeypatch, entry):
    """A 2-card host (patched in): --mesh_data 3 is refused naming cuda:2
    before a store is opened or a process starts, and --mesh_data 2 with
    --mesh_spatial 2 as the grid it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(launch_mod, "launch", lambda *a: pytest.fail("a launch started"))
    data = "--traindir" if entry.startswith("train") else "--datadir"
    argv = ["--device", "cuda", "--checkpoints_dir", str(tmp_path), "--no-log", "--no-verbose",
            data, str(tmp_path / "missing")]
    main = ENTRY_POINTS[entry].main
    with pytest.raises(ValueError, match="cuda:0..cuda:2, have 2 visible cards: cuda:2 is missing"):
        main(argv + ["--mesh_data", "3"])
    with pytest.raises(ValueError, match="2 x 2 grid .* not supported yet"):
        main(argv + ["--mesh_data", "2", "--mesh_spatial", "2"])


def test_launch_refuses_a_missing_card_before_starting(monkeypatch):
    from torch.distributed.launcher import api

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(api, "elastic_launch", lambda *a: pytest.fail("the agent started"))
    with pytest.raises(ValueError, match="cuda:2 is missing"):
        launch(_probe, [], 3, "cuda")
    with pytest.raises(ValueError, match="cuda:3 is missing"):
        launch(_probe, [], 2, "cuda:2")


@pytest.mark.parametrize("cards,want", [(1, None), (4, 4)])
def test_run_ranks_launches_only_past_one_rank(monkeypatch, cards, want):
    """-1 on a one-card host runs in this process (no launch, no group);
    on four it launches four ranks of ``main`` with the argv as given and
    returns rank 0's result."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(launch_mod, "launch",
                        lambda *a: calls.append(a) or [f"rank {r}" for r in range(a[2])])
    argv = ["--device", "cuda", "-b", "8"]
    got = run_ranks(train_syn.main, argv, Config(device="cuda", mesh_data=-1))
    if want is None:
        assert got is None and not calls and not dist.is_initialized()
    else:
        assert got == "rank 0" and calls == [(train_syn.main, argv, want, "cuda")]


# ---- the launched runs -------------------------------------------------------

def test_launched_ranks_end_bitwise_equal(session):
    """train_real --device cpu --mesh_data 2 in one process: two gloo
    ranks, rank 0's RunRecord back from main; a launch of the same argv
    gives both ranks, bitwise equal to each other and to it."""
    rec, probes = session["record"], session["probes"]
    assert (rec["rank"], rec["world"], rec["device"]) == (0, 2, "cpu")
    assert rec["iterations"] == STEPS and rec["epoch"] == 1 and len(rec["history"]) == STEPS
    assert [p["rank"] for p in probes] == [0, 1] and all(p["world"] == 2 for p in probes)
    assert all(p["iterations"] == STEPS for p in probes)
    _assert_equal(probes[0]["state_dict"], probes[1]["state_dict"])
    _assert_equal(rec["state_dict"], probes[0]["state_dict"])


def test_launched_ranks_get_what_torchrun_gives(session):
    """Each rank sees torchrun's variables, --multihost --mesh_data 2 at
    the end of its argv, and one torch thread (torchrun's OMP_NUM_THREADS
    rule past one rank)."""
    for r, p in enumerate(session["probes"]):
        env = p["env"]
        assert (env["RANK"], env["LOCAL_RANK"], env["WORLD_SIZE"]) == (str(r), str(r), "2")
        assert env["MASTER_ADDR"] and int(env["MASTER_PORT"]) > 0
        assert p["argv"] == ["--multihost", "--mesh_data", "2"]
        assert p["threads"] == 1


def test_launched_checkpoint_equals_torchrun_style_children(session, finished):
    """The launched run's checkpoint (rank 0 its only writer) equals bit
    for bit the one two explicit torchrun-style children write from the
    same argv."""
    root, _ = _ok(finished, "torchrun0")
    _ok(finished, "torchrun1")
    ours, theirs = _checkpoint(root, "launched"), _checkpoint(root, "torchrun")
    assert ours["iterations"] == theirs["iterations"] == STEPS
    _assert_equal(ours["netG"], theirs["netG"])
    _assert_equal(ours["netG"], session["record"]["state_dict"])
    assert sorted(os.listdir(os.path.join(root, "ck", "launched"))) == [
        "logs", "model_latest.pt", "opt.txt"]


def test_launched_run_matches_jax_mesh_data_2(session, finished):
    """Against eld_tpu's Engine with mesh_data=2 on the virtual CPU mesh,
    one epoch of the same paired stores and seed from the port's initial
    weights: test_torch_train.py's tolerance."""
    import jax
    import jax.numpy as jnp

    import eld_tpu.train.engine as jax_engine_mod
    from eld_tpu.config import Config as JaxConfig
    from eld_tpu.data import datasets as jax_datasets
    from eld_tpu.data.loader import Loader as JaxLoader
    from eld_tpu.data.patchstore import PatchStore as JaxPatchStore
    from eld_tpu.train.state import TrainState as JaxTrainState
    from eld_tpu.train.state import make_optimizer as jax_make_optimizer
    from eld_tpu_torch.compat.jax_params import flax_to_state_dict, state_dict_to_flax
    from eld_tpu_torch.models import build_arch
    from tests.test_torch_parallel import assert_params_close

    root, _ = finished

    def init_state(model, key, sample_shape, lr=1e-4, beta1=0.9, weight_decay=0.0):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            init = build_arch("unet", 4, 4, base_width=4, skip_mode="split").state_dict()
        params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(init))
        tx = jax_make_optimizer(lr, beta1, weight_decay)
        return JaxTrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32), tx=tx)

    train = os.path.join(root, "train")
    ds = jax_datasets.ELDTrainDataset(JaxPatchStore(os.path.join(train, NAMES[1])),
                                      [JaxPatchStore(os.path.join(train, NAMES[0]))],
                                      rng=onp.random.default_rng(SEED))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_mod, "create_train_state", init_state)
        jeng = jax_engine_mod.Engine(JaxConfig(
            mesh_data=2, noise="", is_train=True, base_width=4, batch_size=2, seed=SEED,
            no_log=True, no_verbose=True, checkpoints_dir=os.path.join(root, "jax")))
        ref = jeng.train(JaxLoader(ds, batch_size=2, shuffle=True, num_workers=0, seed=SEED,
                                   drop_last=True))
    assert jeng.mesh.shape["data"] == 2 and jeng.iterations == STEPS
    rec = session["record"]
    onp.testing.assert_allclose(onp.mean([h[1]["Pixel"] for h in rec["history"]]),
                                ref["Pixel"], rtol=1e-5)
    assert_params_close(flax_to_state_dict(jeng.state.params), rec["state_dict"], steps=STEPS)


def test_a_failed_rank_fails_the_launch_and_no_child_outlives_it(session):
    """Rank 1 raises while rank 0 waits for it: launch raises naming rank
    1 and its error, at once and not at a timeout, and both ranks are
    gone."""
    assert session["failure"].startswith("rank 1 of 2 failed (exit code 1)"), session["failure"]
    assert "rank 1 fails on purpose" in session["failure"]
    assert session["failure_s"] < 60
    for pid in session["pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_launched_ranks_import_no_jax(session, finished):
    """No launched rank, nor the process that launched it, holds jax or
    eld_tpu: not through the target's module (``_probe`` pickles by
    reference to this file) nor through spawn's re-import of the CLI's
    ``__main__`` (``-X importtime`` logs the parent's and both ranks'
    imports)."""
    assert session["modules"] == [] and all(p["modules"] == [] for p in session["probes"])
    _, log = _ok(finished, "cli")
    names = [line.rsplit("|", 1)[1].strip() for line in log.splitlines()
             if line.startswith("import time:") and "|" in line]
    assert sum(n == "eld_tpu_torch.parallel.launch" for n in names) == 3  # parent + 2 ranks
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "eld_tpu")]
    assert "[i] --mesh_data 2: launching 2 ranks on cpu over gloo" in log
    assert log.count("Epoch: 0") == 1  # rank 0's output alone


def test_cli_exits_nonzero_when_a_rank_fails(finished):
    root, out = finished
    rc, log = out["cli_fails"]
    assert rc not in (0, None), log[-3000:]
    assert "of 2 failed (exit code 1)" in log and "not divisible" in log, log[-3000:]
