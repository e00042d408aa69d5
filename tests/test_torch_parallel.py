"""The port's parallel layer (eld_tpu_torch/parallel, the data-parallel
steps and Engine) and its asynchronous checkpoint saves, on the CPU,
against eld_tpu where eld_tpu has the same function.

Multi-process cases run gloo ranks as child processes of this file,

    python tests/test_torch_parallel.py SESSION RANK WORLD PORT WORKDIR

two sessions of two ranks and one of a single rank, started together by a
module fixture that kills them at their timeout, so a hung collective fails
the tests that read the session and does not stall the run.  Each rank
saves what it saw to WORKDIR/rank<R>.pt for the tests to compare.  The
ranks of the "graph" session take the CUDA-graph path of the
data-parallel trainers on the CPU: ``test_torch_fake_card``'s stand-in
graph replays by rerunning the captured call, and the backend query is
patched to say NCCL, so their gloo collectives stand in for the card's.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as onp
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

if __name__ != "__main__":  # a rank (this file run as a script) needs no JAX: ~10 s of imports
    import jax
    import jax.numpy as jnp

    import eld_tpu.train.engine as jax_engine_mod
    from eld_tpu.config import Config as JaxConfig
    from eld_tpu.data.loader import Loader as JaxLoader
    from eld_tpu.models import build_arch as jax_build_arch
    from eld_tpu.parallel import MeshSpec as JaxMeshSpec
    from eld_tpu.parallel import make_mesh
    from eld_tpu.parallel.spatial import make_spatial_forward as jax_make_spatial_forward
    from eld_tpu.train.state import TrainState as JaxTrainState
    from eld_tpu.train.state import make_optimizer as jax_make_optimizer
from eld_tpu_torch import config as config_mod
from eld_tpu_torch.compat.jax_params import flax_to_state_dict, state_dict_to_flax
from eld_tpu_torch.config import Config
from eld_tpu_torch.data.loader import Loader
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.model import synthesize
from eld_tpu_torch.noise.params import load_camera_params, sample_params_batch, take_rows
from eld_tpu_torch.parallel.mesh import MeshSpec, rank_rows, spatial_devices
from eld_tpu_torch.parallel.multihost import (
    all_hosts_agree,
    allgather_objects,
    barrier,
    broadcast_from_host0,
    host_shard,
    initialize_multihost,
    is_host0,
    maybe_initialize_multihost,
)
from eld_tpu_torch.parallel.spatial import make_spatial_forward, spatial_halo
from eld_tpu_torch.tools import test_sid
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.state import create_train_state
from eld_tpu_torch.train.steps import (
    fold_in,
    graph_replays,
    make_train_scan,
    make_train_step,
    pick_batch,
    rank_noise_seed,
)
from tests.test_torch_fake_card import _ReplayingGraph, install_fake_card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
SESSION_TIMEOUT_S = 120
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py); the ranks run on one thread too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- shared helpers (the parent and the ranks build the same inputs) -----

def _torch_unet(width=4, seed=7):
    torch.manual_seed(seed)
    return build_arch("unet", 4, 4, base_width=width, skip_mode="split")


class _PairedDataset:
    def __init__(self, n=12, size=32, seed=3):
        rng = onp.random.default_rng(seed)
        self.items = [{"input": rng.random((size, size, 4), dtype=onp.float32),
                       "target": rng.random((size, size, 4), dtype=onp.float32)}
                      for _ in range(n)]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


class _CleanDataset:
    def __init__(self, n=8, size=16, seed=4):
        rng = onp.random.default_rng(seed)
        self.items = [{"clean": rng.integers(0, 65535, (size, size, 4), dtype=onp.uint16)}
                      for _ in range(n)]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _pool():
    rng = onp.random.default_rng(6)
    return {"clean": torch.from_numpy(rng.integers(0, 65535, (6, 16, 16, 4), dtype=onp.uint16))}


def _cfg(workdir, name, **kw):
    base = dict(device="cpu", base_width=4, no_verbose=True, no_log=True,
                checkpoints_dir=os.path.join(str(workdir), "ck"), name=name)
    base.update(kw)
    return Config(**base)


def _dp_cfg(workdir, multihost):
    return _cfg(workdir, "dp", multihost=multihost, is_train=True, noise="", batch_size=4,
                no_log=False, save_epoch_freq=1)


def _pool_cfg(workdir, name, multihost, batch_size=4):
    return _cfg(workdir, name, multihost=multihost, is_train=True, noise="eld", include=4,
                batch_size=batch_size, seed=9)


def _eval_loader():
    return Loader(_PairedDataset(n=5, seed=8), batch_size=1, num_workers=0)


def _cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


# ---- the ranks ---------------------------------------------------------

def _two_ranks(rank, workdir):
    """Collectives, refusals, a data-parallel epoch, a merged eval and a
    pooled synthetic epoch on two gloo ranks."""
    res = {"again": initialize_multihost(backend="gloo"),  # a no-op on a live group
           "gathered": allgather_objects({"rank": rank}),
           "broadcast": broadcast_from_host0({"from": rank}),
           "agree": [all_hosts_agree(True), all_hosts_agree(rank == 0)]}
    oversize = []
    for fn in (lambda: allgather_objects("x" * (10 if rank == 0 else 5000), max_bytes=1024),
               lambda: broadcast_from_host0("x" * (5000 if rank == 0 else 10), max_bytes=1024)):
        try:
            fn()
            oversize.append("")
        except ValueError as e:
            oversize.append(str(e))
    res["oversize"] = oversize

    refusals = {}
    for name, kw in (("batch", dict(is_train=True, noise="", batch_size=3)),
                     ("mesh_data", dict(mesh_data=1)), ("spatial", dict(mesh_spatial=2))):
        try:
            Engine(_cfg(workdir, "refused", multihost=True, **kw))
            refusals[name] = ""
        except (ValueError, NotImplementedError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
    res["refusals"] = refusals

    calls = []
    real_save = ckpt.save_checkpoint

    def counted(*a, **kw):
        calls.append(a[2] if len(a) > 2 else kw.get("label"))
        return real_save(*a, **kw)

    ckpt.save_checkpoint = counted
    eng = Engine(_dp_cfg(workdir, multihost=True))
    eng.model.load_state_dict(_torch_unet().state_dict())
    loader = Loader(_PairedDataset(), batch_size=4, shuffle=True, num_workers=0, seed=5,
                    drop_last=True, shard=host_shard())
    eng.train(loader)
    res["dp_params"] = _cpu_state(eng.model)
    res["dp_pixel"] = [h[1]["Pixel"] for h in eng.history]
    res["dp_rows"] = [b["input"][:, 0, 0, 0].tolist() for b in loader]
    res["eval"] = eng.eval(_eval_loader(), "ev", loss_key="PSNR", crop=False).as_dict()
    ckpt.wait_for_saves()
    barrier()
    res["saves"] = calls
    res["writer"] = eng.writer is not None
    res["files"] = sorted(os.listdir(eng.cfg.save_dir))
    res["runs"] = sorted(os.listdir(os.path.join(eng.cfg.save_dir, "logs")))

    pooled = Engine(_pool_cfg(workdir, "pool", multihost=True))
    pooled.train_pool(_pool(), steps=3, steps_per_call=2)
    res["pool_params"] = _cpu_state(pooled.model)
    res["pool_history"] = [(h[0], h[1]) for h in pooled.history]
    return res


def _one_rank(workdir):
    """A world-1 group against no group: the same runs, per-step and
    pooled, synthetic noise on the plain path."""
    res = {}
    for tag, multihost in (("dist", True), ("plain", False)):
        eng = Engine(_pool_cfg(workdir, tag, multihost, batch_size=2))
        eng.train(Loader(_CleanDataset(), batch_size=2, shuffle=True, num_workers=0, seed=5,
                         drop_last=True, shard=host_shard() if multihost else (0, 1)))
        eng.train_pool(_pool(), steps=3, steps_per_call=2)
        res[f"{tag}_params"] = _cpu_state(eng.model)
        res[f"{tag}_history"] = [(h[0], h[1]) for h in eng.history]
        res[f"{tag}_ddp"] = eng._forward is not None
    return res


def _eager_trainers(eng):
    """The Engine's per-step trainer and its pooled trainer of K = 2 built
    with capture=False: the eager arm, through the DDP wrapper."""
    cfg, shard = eng.cfg, (eng.rank, eng.world)
    noise = cfg.noise or None
    eng._train_step = make_train_step(eng.model, noise_model=noise, bank=eng.bank,
                                      forward=eng._forward, shard=shard, capture=False)
    eng._train_scans[(2, cfg.batch_size)] = make_train_scan(
        eng.model, noise_model=noise, bank=eng.bank, batch=cfg.batch_size, steps_per_call=2,
        forward=eng._forward, shard=shard, capture=False)


def _collectives(fn):
    """The gloo all-reduces ``fn()`` issues, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key == "gloo:all_reduce")


def _graph_ranks(rank, workdir):
    """The data-parallel trainers on the graph path (a stand-in graph that
    replays by rerunning the call, the backend query saying NCCL) against
    the same Engines' trainers built with capture=False, from the same
    weights: a paired per-step epoch (as ``_two_ranks``'), two synthetic
    per-step epochs and a pooled epoch of three calls of K = 2 (as
    ``_two_ranks``' pooled one, twice as long)."""
    install_fake_card(setattr, _ReplayingGraph)
    steps.nccl_group = lambda: True
    res = {}
    for arm in ("graph", "eager"):
        paired = Engine(_cfg(workdir, f"paired_{arm}", multihost=True, is_train=True, noise="",
                             batch_size=4))
        paired.model.load_state_dict(_torch_unet().state_dict())
        synthetic = Engine(_pool_cfg(workdir, f"syn_{arm}", multihost=True))
        pooled = Engine(_pool_cfg(workdir, f"pool_{arm}", multihost=True))
        if arm == "eager":
            for eng in (paired, synthetic, pooled):
                _eager_trainers(eng)
        paired.train(Loader(_PairedDataset(), batch_size=4, shuffle=True, num_workers=0, seed=5,
                            drop_last=True, shard=host_shard()))
        for _ in range(2):
            synthetic.train(Loader(_CleanDataset(), batch_size=4, shuffle=True, num_workers=0,
                                   seed=5, drop_last=True, shard=host_shard()))
        pool = _pool()
        pooled.train_pool(pool, steps=6, steps_per_call=2)
        trainers = (paired._train_step, synthetic._train_step, pooled._scan_fn(2))
        res[arm] = {"paired_params": _cpu_state(paired.model),
                    "paired_pixel": [h[1]["Pixel"] for h in paired.history],
                    "syn_params": _cpu_state(synthetic.model),
                    "syn_pixel": [h[1]["Pixel"] for h in synthetic.history],
                    "pool_params": _cpu_state(pooled.model),
                    "pool_history": [(h[0], h[1]) for h in pooled.history],
                    "replays": [graph_replays(fn) for fn in trainers]}
        if arm == "graph":
            # the noise seeds of the last step and call; then a replay's
            # collectives: one for the gradients per step, one for the
            # losses per call (DDP's hooks issue none)
            res["seeds"] = [next(iter(fn.graphs.values())).seeds.tolist() for fn in trainers[1:]]
            rows = torch.from_numpy(onp.stack([it["clean"] for it in _CleanDataset().items[:2]]))
            res["collectives"] = [
                _collectives(lambda: trainers[1](synthetic.state, {"clean": rows}, 5)),
                _collectives(lambda: trainers[2](pooled.state, pool, [5, 6]))]
            res["replays_after"] = [graph_replays(fn) for fn in trainers[1:]]
    return res


def _rank_main(session, rank, world, port, workdir):
    torch.set_num_threads(1)
    shard = initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    res = {"shard": shard}
    res.update({"two": _two_ranks, "graph": _graph_ranks}[session](rank, workdir)
               if world == 2 else _one_rank(workdir))
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(session, world, workdir):
    os.makedirs(workdir, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    port = _free_port()
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), session, str(r), str(world), str(port),
             workdir], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log))
    return {"name": session, "procs": procs, "workdir": workdir,
            "deadline": time.monotonic() + SESSION_TIMEOUT_S}


def _finish(session):
    """Wait for a session's ranks; kill them all at its deadline or as soon
    as one fails (the others would wait in a collective).  Returns the
    ranks' results, or the failure's message."""
    procs = [p for p, _ in session["procs"]]
    failure = None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failure = "a rank failed"
            break
        if time.monotonic() > session["deadline"]:
            failure = f"the ranks did not finish within {SESSION_TIMEOUT_S} s"
            break
        time.sleep(0.1)
    for p, log in session["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    if failure is None and any(p.returncode for p in procs):
        failure = "a rank failed"
    if failure is not None:
        logs = "".join(open(os.path.join(session["workdir"], f"rank{r}.log")).read()[-3000:]
                       for r in range(len(procs)))
        return f"session {session['name']}: {failure}\n{logs}"
    return [torch.load(os.path.join(session["workdir"], f"rank{r}.pt"), weights_only=True)
            for r in range(len(procs))]


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The sessions, started before the module's first test so that the
    one-process tests run while the ranks work; no rank outlives the
    module."""
    root = str(tmp_path_factory.mktemp("ranks"))
    runs = [_start("two", 2, os.path.join(root, "two")),
            _start("graph", 2, os.path.join(root, "graph")),
            _start("one", 1, os.path.join(root, "one"))]
    yield runs
    for run in runs:
        for p, log in run["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


@pytest.fixture(scope="module")
def sessions(started):
    """The sessions' results; each is waited for within its own
    SESSION_TIMEOUT_S."""
    return {s["name"]: (_finish(s), s["workdir"]) for s in started}


def _ranks(sessions, name):
    res, workdir = sessions[name]
    if isinstance(res, str):
        pytest.fail(res)
    return res, workdir


def assert_params_close(ref: dict, got: dict, steps: int):
    """The tolerance of test_torch_train.py's Engine comparison: no element
    further than two Adam steps' worth, and 99.9% within 1e-6."""
    close, total = 0, 0
    for k, v in ref.items():
        d = (got[k].detach().cpu() - v).abs()
        assert float(d.max()) <= 2 * LR * steps, k
        close += int((d <= 1e-6).sum())
        total += d.numel()
    assert close / total >= 0.999, close / total


# ---- the mesh, the bootstrap and the loader, in one process --------------

def test_mesh_resolution_and_rank_rows():
    assert MeshSpec().resolve(world=4, cards=0) == MeshSpec(data=4, spatial=1)
    assert MeshSpec(2, 2).resolve(world=2, cards=2) == MeshSpec(2, 2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        MeshSpec(2, 1).resolve(world=1, cards=8)
    with pytest.raises(ValueError, match="cuda:1 is missing"):
        MeshSpec(1, 2).resolve(world=1, cards=1)
    assert [rank_rows(r, 2, 8) for r in range(2)] == [slice(0, 4), slice(4, 8)]
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(0, 3, 8)


def test_initialize_multihost_outcomes_without_a_cluster(monkeypatch):
    """No cluster environment: nothing asked gives one process, --multihost
    (strict) and partial explicit arguments raise."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost(backend="gloo") == (0, 1)
    assert maybe_initialize_multihost(Config(device="cpu")) == (0, 1)
    with pytest.raises(ValueError, match="no cluster environment"):
        initialize_multihost(strict=True, backend="gloo")
    with pytest.raises(ValueError, match="no cluster environment"):
        maybe_initialize_multihost(Config(device="cpu", multihost=True))
    with pytest.raises(ValueError, match="together"):
        initialize_multihost(num_processes=2, backend="gloo")
    assert not dist.is_initialized() and host_shard() == (0, 1) and is_host0()
    assert allgather_objects({"a": 1}) == [{"a": 1}] and broadcast_from_host0(3) == 3
    assert all_hosts_agree(True) and not all_hosts_agree(False)


def test_refusals_in_one_process(tmp_path, monkeypatch):
    """--mesh_data that is not the world size (the Engine, and test_sid
    under a launcher of one rank, where the entry point launches nothing),
    --chop with --mesh_spatial > 1, --mesh_spatial beyond the visible
    cards, and a multi-process launch without --multihost."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Engine(_cfg(tmp_path, "d", mesh_data=2))
    with monkeypatch.context() as launcher:
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
            launcher.setenv(k, v)
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            test_sid.main(["--mesh_data", "2", "--device", "cpu", "--checkpoints_dir",
                           str(tmp_path / "sid"), "--no-log", "--no-verbose"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        Engine(_cfg(tmp_path, "c", chop=True, mesh_spatial=2))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"cuda:{cards} is missing"):
        Engine(_cfg(tmp_path, "s", mesh_spatial=max(2, cards + 1)))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="Pass --multihost"):
        Engine(_cfg(tmp_path, "w"))
    with pytest.raises(RuntimeError, match="--multihost was not given"):
        maybe_initialize_multihost(Config(device="cpu"))


def test_spatial_forward_starts_at_the_engines_card(tmp_path, monkeypatch):
    """--mesh_spatial S takes the S cards from the Engine's own, cuda:k ..
    cuda:k+S-1, and refuses by name a CPU --device and a range past the
    visible cards (a 2-card host, patched in), before the model moves."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--device is cpu"):
        Engine(_cfg(tmp_path, "cpu", mesh_spatial=2))
    with pytest.raises(ValueError, match="from --device cuda:1 needs cuda:1..cuda:2.*cuda:2 is "
                                         "missing"):
        Engine(_cfg(tmp_path, "k1", mesh_spatial=2, device="cuda:1"))
    assert spatial_devices("cuda:1", 2, 3) == [torch.device("cuda", 1), torch.device("cuda", 2)]
    assert spatial_devices("cuda:0", 2, 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("world", [2, 4])
def test_loader_shard_rows_equal_jax(world):
    """Each rank's rows of every global batch (rows rank::world), two
    shuffled epochs on two threads, equal eld_tpu's Loader(shard=) exactly;
    both raise the same two ValueErrors."""
    ds = _CleanDataset(n=16)
    for rank in range(world):
        kw = dict(batch_size=8, shuffle=True, num_workers=2, seed=3, drop_last=True,
                  shard=(rank, world))
        ours, ref = Loader(ds, **kw), JaxLoader(ds, **kw)
        got = [b["clean"] for _ in range(2) for b in ours]
        want = [b["clean"] for _ in range(2) for b in ref]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.shape[0] == 8 // world
            onp.testing.assert_array_equal(a, b)
    for kw in (dict(batch_size=6, shard=(0, 4), drop_last=True),
               dict(batch_size=8, shard=(0, 2), drop_last=False)):
        for cls in (Loader, JaxLoader):
            with pytest.raises(ValueError):
                cls(ds, **kw)


def test_rank_rows_of_a_pooled_batch_and_rank_noise_seeds():
    """A rank's pick is its rows of the global pick (indices and
    augmentation masks); a one-rank run keeps today's noise seed, and
    rank seeds are distinct over ranks and steps."""
    pool = _pool()
    full = pick_batch(pool, 4, 123)["clean"]
    for r in range(2):
        part = pick_batch(pool, 4, 123, rank_rows(r, 2, 4))["clean"]
        assert torch.equal(part, full[2 * r:2 * r + 2])
    steps = [fold_in(2018, i) for i in range(1000)]
    assert all(rank_noise_seed(s) == fold_in(s, 1) for s in steps)
    assert len({rank_noise_seed(s, r, 4) for s in steps for r in range(4)}) == 4000


# ---- the spatial forward against eld_tpu's --------------------------------

SPATIAL_CASES = {"conv": (2, 128, 64, 4), "unet": (1, 128, 64, 4),
                 "misaligned": (1, 40, 128, 4), "ragged": (1, 72, 48, 4)}


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("case", list(SPATIAL_CASES))
def test_spatial_forward_matches_jax(case, s):
    """The port's forward over S CPU replicas against eld_tpu's over the
    spatial axis of the virtual CPU mesh (MeshSpec(1, S)), on a 5x5 conv
    with halo 16 and on a width-4 unet (Flax weights from the port's) at
    aligned, misaligned (H 40) and ragged (H 72, W 48) frames: 1e-5 abs."""
    x = onp.random.default_rng(1).random(SPATIAL_CASES[case], dtype=onp.float32)
    if case == "conv":
        w = onp.random.default_rng(2).random((4, 4, 5, 5), dtype=onp.float32) / 100
        wt, wj = torch.from_numpy(w), jnp.asarray(w.transpose(2, 3, 1, 0))

        def ours(t):
            return F.conv2d(t.permute(0, 3, 1, 2), wt, padding=2).permute(0, 2, 3, 1)

        def theirs(p, t):
            return jax.lax.conv_general_dilated(t, wj, (1, 1), "SAME",
                                                dimension_numbers=("NHWC", "HWIO", "NHWC"))

        params, halo, base = None, 16, 16
    else:
        ours = _torch_unet(seed=3).eval()
        jm = jax_build_arch("unet", 4, 4, base_width=4, skip_mode="split")
        params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(ours.state_dict()))

        def theirs(p, t):
            return jm.apply({"params": p}, t)

        halo, base = None, ours.alignment()
    got = make_spatial_forward(ours, ["cpu"] * s, halo=halo, base=base)(torch.from_numpy(x))
    want = jax_make_spatial_forward(theirs, make_mesh(JaxMeshSpec(1, s)), halo=halo,
                                    base=base)(params, jnp.asarray(x))
    assert got.shape == x.shape
    assert float(onp.abs(got.numpy() - onp.asarray(want)).max()) <= 1e-5
    assert spatial_halo(16) == 16 and spatial_halo(32) == 32


# ---- two ranks and one rank ------------------------------------------------

def test_collectives_on_two_ranks(sessions):
    """allgather_objects, broadcast_from_host0 and all_hosts_agree give
    every rank the same answer; an oversize payload on ONE rank raises on
    both; a second initialize_multihost on a live group is a no-op."""
    ranks, _ = _ranks(sessions, "two")
    for r, res in enumerate(ranks):
        assert res["shard"] == res["again"] == (r, 2)
        assert res["gathered"] == [{"rank": 0}, {"rank": 1}]
        assert res["broadcast"] == {"from": 0}
        assert res["agree"] == [True, False]
        assert all("raised collectively on every process" in m for m in res["oversize"])


def test_refusals_on_two_ranks(sessions):
    """A global batch that does not split over the ranks, --mesh_data that
    is not the world size, and spatial sharding across processes."""
    ranks, _ = _ranks(sessions, "two")
    for res in ranks:
        ref = res["refusals"]
        assert ref["batch"].startswith("ValueError: batch_size=3 must be divisible"), ref
        assert "torchrun --nproc_per_node 1" in ref["mesh_data"], ref
        assert ref["spatial"].startswith("NotImplementedError: spatially-sharded"), ref


@pytest.fixture(scope="module")
def jax_mesh_data_2(tmp_path_factory):
    """eld_tpu's Engine with mesh_data=2 on the virtual mesh, from
    ``_torch_unet``'s weights, after one epoch of the paired batches that
    the ranks' data-parallel epochs see: (the Engine, its metrics)."""
    def init_state(model, key, sample_shape, lr=1e-4, beta1=0.9, weight_decay=0.0):
        params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(_torch_unet().state_dict()))
        tx = jax_make_optimizer(lr, beta1, weight_decay)
        return JaxTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                             epoch=jnp.zeros((), jnp.int32), tx=tx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_mod, "create_train_state", init_state)
        jeng = jax_engine_mod.Engine(JaxConfig(mesh_data=2, noise="", is_train=True,
                                               base_width=4, batch_size=4, no_log=True,
                                               no_verbose=True,
                                               checkpoints_dir=str(tmp_path_factory.mktemp("j"))))
        ref = jeng.train(JaxLoader(_PairedDataset(), batch_size=4, shuffle=True, num_workers=0,
                                   seed=5, drop_last=True))
    return jeng, ref


def test_data_parallel_epoch_matches_jax_mesh_data_2(sessions, jax_mesh_data_2):
    """Two gloo ranks train one epoch of paired batches (each its rows
    rank::2 of every global batch of 4) and end bitwise equal; against
    eld_tpu's Engine with mesh_data=2 on the virtual mesh, from the same
    initial weights, within test_torch_train.py's tolerance.  The reported
    loss is the global batch's."""
    ranks, _ = _ranks(sessions, "two")
    for k, v in ranks[0]["dp_params"].items():
        assert torch.equal(v, ranks[1]["dp_params"][k]), k
    assert ranks[0]["dp_pixel"] == ranks[1]["dp_pixel"] and len(ranks[0]["dp_pixel"]) == 3
    assert ranks[0]["dp_rows"] != ranks[1]["dp_rows"]

    jeng, ref = jax_mesh_data_2
    assert jeng.mesh.shape["data"] == 2
    assert jeng.iterations == 3
    onp.testing.assert_allclose(onp.mean(ranks[0]["dp_pixel"]), ref["Pixel"], rtol=1e-5)
    assert_params_close(flax_to_state_dict(jeng.state.params), ranks[0]["dp_params"], steps=3)


def test_merged_eval_is_identical_on_both_ranks(sessions, tmp_path):
    """Each rank scores its stride of 5 items; the merged means are bitwise
    identical on both ranks and equal the one-process eval of the same
    weights; rank 0 alone writes: the epoch's two checkpoints and ONE best
    checkpoint, best_val.json and one TensorBoard run dir."""
    ranks, _ = _ranks(sessions, "two")
    assert ranks[0]["eval"] == ranks[1]["eval"]
    eng = Engine(_cfg(tmp_path, "single"))
    eng.model.load_state_dict(ranks[0]["dp_params"])
    want = eng.eval(_eval_loader(), "ev", crop=False).as_dict()
    assert want.keys() == ranks[0]["eval"].keys()
    for k, v in want.items():
        assert ranks[0]["eval"][k] == pytest.approx(v, rel=1e-12), k
    assert ranks[0]["saves"] == [None, "latest", "best_PSNR_ev"] and ranks[1]["saves"] == []
    assert [r["writer"] for r in ranks] == [True, False]
    files = ranks[0]["files"]
    assert files == ranks[1]["files"]
    assert [f for f in files if f.endswith(".pt")] == [
        "model_001_00000003.pt", "model_best_PSNR_ev.pt", "model_latest.pt"]
    assert "best_val.json" in files and not [f for f in files if f.endswith(".tmp")]
    assert len(ranks[0]["runs"]) == 1


def _pooled_replay(n_steps):
    """One process replays a two-rank pooled run of ``n_steps`` at global
    batch 4 from seed 9's weights: it picks each global batch, samples its
    noise parameters, noises rank r's rows 2r..2r+1 under the seed
    fold_in(fold_in(step seed, 1), r) on the plain path, and steps on the
    whole batch.  Returns the parameters and the losses."""
    torch.manual_seed(9)
    model = build_arch("unet", 4, 4, base_width=4, skip_mode="split")
    state = create_train_state(model)
    bank = load_camera_params(include=4)
    pool, losses = _pool(), []
    for j in range(n_steps):
        seed = fold_in(9, j)
        clean = pick_batch(pool, 4, seed)["clean"]
        params = sample_params_batch(torch.Generator().manual_seed(fold_in(seed, 0)), bank, 4)
        noisy = torch.cat([
            synthesize(torch.Generator().manual_seed(fold_in(fold_in(seed, 1), r)),
                       clean[2 * r:2 * r + 2], take_rows(params, slice(2 * r, 2 * r + 2)),
                       model="eld", clip=True) for r in range(2)])
        assert not torch.equal(noisy[:2] - clean[:2], noisy[2:] - clean[2:])
        state.optimizer.zero_grad(set_to_none=True)
        loss = (model(noisy) - clean).abs().mean()
        loss.backward()
        state.optimizer.step()
        losses.append(float(loss.detach()))
    return _cpu_state(model), losses


def test_pooled_two_ranks_equal_a_single_process_replay(sessions):
    """train_pool on two ranks (3 steps, calls of 2 and 1, global batch 4)
    against one process that picks each global batch, samples its noise
    parameters, noises rank r's rows 2r..2r+1 under the seed
    fold_in(fold_in(step seed, 1), r) on the plain path, and steps on the
    whole batch.  Both ranks report the same global losses."""
    ranks, _ = _ranks(sessions, "two")
    for k, v in ranks[0]["pool_params"].items():
        assert torch.equal(v, ranks[1]["pool_params"][k]), k
    assert ranks[0]["pool_history"] == ranks[1]["pool_history"]

    params, losses = _pooled_replay(3)
    assert_params_close(params, ranks[0]["pool_params"], steps=3)
    (_, first), (_, second) = ranks[0]["pool_history"]
    onp.testing.assert_allclose([first["Pixel"], first["PixelLast"], second["Pixel"]],
                                [onp.mean(losses[:2]), losses[1], losses[2]], rtol=1e-5)


# ---- two ranks on the graph path (the "graph" session) -----------------------

def test_graph_path_on_two_ranks_equals_eager_ddp_bit_for_bit(sessions):
    """On each rank the data-parallel trainers' graph path (the stand-in
    replaying by rerunning the call, the gradients averaged by one
    all-reduce of the call's flat buffer) trains exactly as capture=False's
    eager DDP path from the same weights: a paired per-step epoch (2 of
    its 3 steps replays), two synthetic per-step epochs (3 of 4) and a
    pooled epoch of three calls of K = 2 (2 of 3): every reported loss and
    the parameters.  The paired epoch also equals the "two" session's
    Engine bit for bit, and both ranks end equal.  A replay issues one
    gloo all-reduce a step for the gradients and one a call for the
    losses: DDP's own hooks add none."""
    ranks, _ = _ranks(sessions, "graph")
    eager_two, _ = _ranks(sessions, "two")
    for res in ranks:
        g, e = res["graph"], res["eager"]
        assert g["replays"] == [2, 3, 2] and e["replays"] == [0, 0, 0]
        assert g["paired_pixel"] == e["paired_pixel"] and g["syn_pixel"] == e["syn_pixel"]
        assert g["pool_history"] == e["pool_history"] and len(g["pool_history"]) == 3
        for key in ("paired_params", "syn_params", "pool_params"):
            for name, v in e[key].items():
                assert torch.equal(v, g[key][name]), (key, name)
                assert torch.equal(v, ranks[0]["graph"][key][name]), (key, name)
        for name, v in eager_two[0]["dp_params"].items():
            assert torch.equal(v, g["paired_params"][name]), name
        assert res["collectives"] == [1 + 1, 2 + 1]
        assert res["replays_after"] == [4, 3]


def test_graph_path_on_two_ranks_matches_jax_mesh_data_2(sessions, jax_mesh_data_2):
    """The graph path's paired epoch on two ranks against eld_tpu's
    mesh_data=2 Engine, by test_data_parallel_epoch_matches_jax_mesh_data_2's
    method and tolerance."""
    ranks, _ = _ranks(sessions, "graph")
    jeng, ref = jax_mesh_data_2
    got = ranks[0]["graph"]
    assert len(got["paired_pixel"]) == jeng.iterations == 3
    onp.testing.assert_allclose(onp.mean(got["paired_pixel"]), ref["Pixel"], rtol=1e-5)
    assert_params_close(flax_to_state_dict(jeng.state.params), got["paired_params"], steps=3)


def test_graph_path_seeds_each_ranks_noise_and_equals_a_single_process_replay(sessions):
    """A captured data-parallel call seeds rank r's noise with
    rank_noise_seed(step seed, r, 2): the last per-step step's and the
    last pooled call's seed buffers hold those seeds, different on the two
    ranks; and the pooled epoch (6 steps) equals a one process replay that
    noises each rank's rows under its own seed, as
    test_pooled_two_ranks_equal_a_single_process_replay holds the eager
    ranks."""
    ranks, _ = _ranks(sessions, "graph")
    for r, res in enumerate(ranks):
        want = [[rank_noise_seed(fold_in(9, 3), r, 2)],
                [rank_noise_seed(fold_in(9, j), r, 2) for j in (4, 5)]]
        assert [[v & ((1 << 64) - 1) for v in s] for s in res["seeds"]] == want
    assert ranks[0]["seeds"] != ranks[1]["seeds"]
    params, losses = _pooled_replay(6)
    got = ranks[0]["graph"]
    assert_params_close(params, got["pool_params"], steps=6)
    onp.testing.assert_allclose([h["Pixel"] for _, h in got["pool_history"]],
                                [onp.mean(losses[2 * c:2 * c + 2]) for c in range(3)], rtol=1e-5)
    assert [h["PixelLast"] for _, h in got["pool_history"]] == pytest.approx(losses[1::2],
                                                                            rel=1e-5)


def test_world_one_group_equals_no_group_bit_for_bit(sessions):
    """A world-1 gloo group with --multihost (DistributedDataParallel, the
    global-mean reduction, rank seeds) trains exactly as no group does: a
    per-step epoch, then a pooled one."""
    (res,), _ = _ranks(sessions, "one")
    assert res["shard"] == (0, 1) and res["dist_ddp"] and not res["plain_ddp"]
    assert res["dist_history"] == res["plain_history"]
    for k, v in res["plain_params"].items():
        assert torch.equal(v, res["dist_params"][k]), k


# ---- asynchronous checkpoint saves ------------------------------------------

@pytest.fixture
def gated_writes(monkeypatch):
    """Background checkpoint writes wait for the returned event; a write in
    the caller's thread (a synchronous save) does not."""
    gate = threading.Event()
    real = ckpt._write

    def write(payload, path):
        if threading.current_thread().name == "checkpoint-writer":
            assert gate.wait(30)
        real(payload, path)

    monkeypatch.setattr(ckpt, "_write", write)
    yield gate
    gate.set()
    ckpt.wait_for_saves()


def _trained(tmp_path, name, **kw):
    eng = Engine(_cfg(tmp_path, name, is_train=True, noise="", batch_size=2, **kw))
    eng.train(Loader(_PairedDataset(n=4), batch_size=2, num_workers=0))
    return eng


def test_async_save_writes_the_state_of_the_call(tmp_path, gated_writes):
    """The asynchronous file loads to the same tensors as a synchronous
    save of the same state, though two optimizer steps ran (in place)
    before the write landed."""
    eng = _trained(tmp_path, "a")
    sync = ckpt.save_checkpoint(eng.cfg.save_dir, eng.state, "sync")
    path = eng.save(label="async")
    assert not os.path.exists(path)
    eng.train(Loader(_PairedDataset(n=4), batch_size=2, num_workers=0))
    gated_writes.set()
    ckpt.wait_for_saves()
    a, b = (torch.load(p, weights_only=True) for p in (path, sync))
    assert (a["epoch"], a["iterations"]) == (b["epoch"], b["iterations"]) == (1, 2)
    for k, v in b["netG"].items():
        assert torch.equal(a["netG"][k], v), k
    assert not all(torch.equal(v, eng.model.state_dict()[k]) for k, v in a["netG"].items())
    for i, st in b["opt_g"]["state"].items():
        assert all(torch.equal(a["opt_g"]["state"][i][k], t) for k, t in st.items())
    assert a["opt_g"]["param_groups"] == b["opt_g"]["param_groups"]


def test_failed_async_write_raises_at_wait_and_at_the_next_save(tmp_path):
    """A background write that cannot create its file raises at
    wait_for_saves(), once; another raises at the next save."""
    eng = Engine(_cfg(tmp_path, "f"))
    os.makedirs(os.path.join(eng.cfg.save_dir, "model_latest.pt.tmp"))
    eng.save(label="latest")
    with pytest.raises((OSError, RuntimeError)):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()
    eng.save(label="latest")
    with pytest.raises((OSError, RuntimeError)):
        eng.save(label="other")
    ckpt.wait_for_saves()
    assert not os.path.exists(os.path.join(eng.cfg.save_dir, "model_other.pt"))


def test_load_waits_for_an_in_flight_save(tmp_path, gated_writes):
    eng = _trained(tmp_path, "w")
    path = eng.save(label="latest")
    assert not os.path.exists(path)
    threading.Timer(0.3, gated_writes.set).start()
    other = Engine(_cfg(tmp_path, "other"))
    other.load(path)
    assert (other.epoch, other.iterations) == (1, 2)
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k


def test_no_async_ckpt_is_synchronous(tmp_path, gated_writes):
    """--no-async-ckpt saves in the caller; the default saves in the
    background (the file lands only once the write is let through)."""
    argv = ["--device", "cpu", "--checkpoints_dir", str(tmp_path), "--no-verbose"]
    assert config_mod.parse(argv, dump=False).async_ckpt
    cfg = config_mod.parse(argv + ["--no-async-ckpt"], dump=False)
    assert not cfg.async_ckpt
    sync_path = Engine(dataclasses.replace(cfg, base_width=4, name="s")).save(label="latest")
    assert os.path.exists(sync_path)
    async_path = Engine(dataclasses.replace(cfg, base_width=4, name="a", async_ckpt=True)).save(
        label="latest")
    assert not os.path.exists(async_path)
    gated_writes.set()
    ckpt.wait_for_saves()
    assert os.path.exists(async_path)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
