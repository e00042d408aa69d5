"""The per-step train step and the eval forward as CUDA graphs: the host
side of their graph path, rehearsed on the CPU.

Nothing here can capture a CUDA graph (there is no card).  The
``fake_card`` fixture routes CPU tensors down the graph path with
stand-ins for the card's pieces (``test_torch_fake_card.py``): a graph
that counts its replays and remembers its registered generators, a
capture that runs the call's Python for real on the CPU, and streams
that do nothing.  So the first call of a shape runs eagerly, the
second "captures" (executing the call once, on the graph's own input
buffers and draws) and replays, and a replay does nothing.  What the card
adds (that a replay recomputes, bit for bit) is held by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 11.

Tolerances: the graph path against the eager path on the same CPU is
exact (the same ops on the same draws); against eld_tpu, float32 on the
CPU as in ``test_torch_train``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.train.steps import make_train_step as jax_make_train_step
from eld_tpu_torch.compat.jax_params import state_dict_to_flax
from eld_tpu_torch.config import Config
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.kernels import seed_int64
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.state import (
    create_train_state,
    load_optimizer_state,
    optimizer_state_dict,
    set_learning_rate,
)
from eld_tpu_torch.train.steps import (
    EAGER_ARM,
    HOST_COLLECTIVES,
    SPATIAL,
    StepRandom,
    fold_in,
    graph_replays,
    make_eval_forward,
    make_train_scan,
    make_train_step,
    rank_noise_seed,
    say_eager,
    step_random,
)
from tests.test_torch_fake_card import install_fake_card
from tests.test_torch_train import _jax_state, _paired_batches, assert_params_close

LR = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the graph path, with ``test_torch_fake_card``'s
    stand-ins (a replay does nothing); K1's wrapper counts its (CPU,
    plain) calls as launches.  Yields the capture's record: the memory
    pool of each capture."""
    yield install_fake_card(monkeypatch.setattr)


def _unet(seed=0, width=4, arch="unet"):
    torch.manual_seed(seed)
    return build_arch(arch, 4, 4, base_width=width, skip_mode="split")


def _u16(shape, seed):
    return torch.from_numpy(onp.random.default_rng(seed).integers(0, 65535, shape,
                                                                  dtype=onp.uint16))


def _bank():
    return load_camera_params(include=4)


def _synthetic(model, **kw):
    return make_train_step(model, noise_model="eld", bank=_bank(), **kw)


def _only(fn):
    (call,) = fn.graphs.values()
    return call


# ---- the per-step train step ----------------------------------------------------

def test_step_graph_copies_each_batch_into_its_buffers(fake_card):
    """The first step runs eagerly (no graph), the second captures into
    buffers of the runner's own and replays; every replay finds the
    step's batch, byte for byte, in those buffers, never the caller's
    tensor itself."""
    state = create_train_state(_unet(), lr=LR)
    step = _synthetic(state.model)
    batches = [{"clean": _u16((2, 16, 16, 4), i)} for i in range(4)]
    step(state, batches[0], fold_in(5, 0))
    call = _only(step)
    assert call.graph is None and call.binding is not None
    for i in range(1, 4):
        step(state, batches[i], fold_in(5, i))
    assert call.replays == call.graph.replays == 3
    for seen, batch in zip(call.graph.seen, batches[1:]):
        assert torch.equal(seen["clean"], batch["clean"])
    assert call.inputs["clean"].data_ptr() not in {b["clean"].data_ptr() for b in batches}


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_step_graph_draws_what_the_eager_step_draws(fake_card, impl):
    """The graph's StepRandom is its own, registered with the graph and
    reseeded from the step seed before each replay (fold_in(seed, 0 / 2 /
    3)): it draws what the process's ``step_random`` draws for that seed.
    K1's seed buffer holds ``seed_int64(rank_noise_seed(seed))``; the
    plain noise draws from a registered generator of its own seeded with
    ``rank_noise_seed(seed)``.  The capture (run for real here) gives the
    eager step's loss and parameters exactly."""
    seeds = [fold_in(2018, i) for i in range(2)]
    graph_state = create_train_state(_unet(), lr=LR)
    eager_state = create_train_state(_unet(), lr=LR)
    graph_step = _synthetic(graph_state.model, noise_impl=impl)
    eager_step = _synthetic(eager_state.model, noise_impl=impl, capture=False)
    batch = {"clean": _u16((2, 16, 16, 4), 7)}
    for seed in seeds:
        got = graph_step(graph_state, batch, seed)["Pixel"]
        want = eager_step(eager_state, batch, seed)["Pixel"]
        assert float(got) == float(want)
    for a, b in zip(graph_state.model.parameters(), eager_state.model.parameters()):
        assert torch.equal(a, b)
    call = _only(graph_step)
    assert call.seeds.tolist() == [seed_int64(rank_noise_seed(seeds[-1]))]
    (slot,) = call.slots
    assert [g.initial_seed() for g in slot.generators()] == [fold_in(seeds[-1], p)
                                                             for p in (0, 2, 3)]
    call._load_seeds([seeds[-1]])  # as before the step's replay
    ref = step_random("cpu", seeds[-1])
    for a, b in zip(slot.generators(), ref.generators()):
        assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    registered = list(slot.generators()) + call.noise
    assert call.graph.generators == registered
    assert len(call.noise) == (impl == "plain")
    if impl == "plain":
        assert call.noise[0].initial_seed() == rank_noise_seed(seeds[-1])


def test_step_graph_advances_step_and_launches_and_returns_copies(fake_card):
    """A replay runs no Python: the runner advances state.step and K1's
    launch count by one a step, as many as the eager path counts, and
    "Pixel" is a copy of the graph's loss, which the next replay (the
    Engine reads it one step late) does not change."""
    state = create_train_state(_unet(), lr=LR)
    step = _synthetic(state.model)
    batch = {"clean": _u16((2, 16, 16, 4), 1)}
    got = [step(state, batch, fold_in(3, i)) for i in range(4)]
    call = _only(step)
    assert state.step == 4 and steps.synthesize_kernel.launches == 4
    assert call.launches[steps.synthesize_kernel] == 1 and call.replays == 3
    for m in got[1:]:
        assert m["Pixel"] is not call.out[0]
    before = [float(m["Pixel"]) for m in got]
    call.out[0].fill_(9.0)  # the next replay's value
    assert [float(m["Pixel"]) for m in got] == before


def test_a_new_batch_shape_gets_its_own_graph(fake_card):
    """One graph per batch signature (keys, shapes, dtypes): a new shape
    starts with an eager step of its own, then a capture."""
    state = create_train_state(_unet(), lr=LR)
    step = _synthetic(state.model)
    small, large = _u16((2, 16, 16, 4), 1), _u16((3, 32, 32, 4), 2)
    for clean in (small, small, large, large, large, small):
        step(state, {"clean": clean}, 11)
    assert sorted(step.graphs) == [(("clean", (2, 16, 16, 4), torch.uint16),),
                                   (("clean", (3, 32, 32, 4), torch.uint16),)]
    assert [c.replays for c in step.graphs.values()] == [2, 2]
    assert graph_replays(step) == 4 and state.step == 6


def test_paired_step_graph_keys_both_inputs(fake_card):
    """A paired step's signature names both inputs, and both land in the
    graph's buffers."""
    state = create_train_state(_unet(), lr=LR)
    step = make_train_step(state.model)
    batches = [{"input": _u16((2, 16, 16, 4), i), "target": _u16((2, 16, 16, 4), 10 + i)}
               for i in range(3)]
    for i, batch in enumerate(batches):
        step(state, batch, i)
    call = _only(step)
    assert [k for k, _, _ in next(iter(step.graphs))] == ["input", "target"]
    for key in ("input", "target"):
        assert torch.equal(call.graph.seen[-1][key], batches[-1][key])


def test_a_loaded_optimizer_state_or_replaced_parameter_drops_the_step_graph(fake_card):
    """The graph holds the parameters and the optimizer's tensors: an
    optimizer state loaded over the old one, or a parameter replaced,
    drops it, and the next step runs eagerly again; a rate set in place
    keeps it."""
    state = create_train_state(_unet(), lr=LR)
    step = _synthetic(state.model)
    batch = {"clean": _u16((2, 16, 16, 4), 1)}
    step(state, batch, 1)
    step(state, batch, 2)
    call = _only(step)
    assert call.graph is not None
    set_learning_rate(state, 5e-5)
    step(state, batch, 3)
    assert call.graph is not None and call.replays == 2
    load_optimizer_state(state.optimizer, copy.deepcopy(optimizer_state_dict(state.optimizer)))
    step(state, batch, 4)
    assert call.graph is None and call.binding is not None  # the eager step after the drop
    step(state, batch, 5)
    assert call.graph is not None
    with torch.no_grad():
        state.model.conv1_1.weight = torch.nn.Parameter(state.model.conv1_1.weight.clone())
    state.optimizer = create_train_state(state.model, lr=LR).optimizer
    step(state, batch, 6)
    assert call.graph is None


def test_data_parallel_step_stays_eager_and_says_so_once(fake_card, capsys, monkeypatch):
    """Under data parallelism (a DistributedDataParallel ``forward``, any
    wrapper, or ``shard`` over several ranks) the step captures on the
    card when the group is NCCL's (the group and its backend query
    patched), and stays eager without one or with ``capture=False``, saying so once
    on stderr with its reason; so does the pooled trainer.  Without data
    parallelism the step captures and says nothing.  (The ranks'
    collectives are stubbed: one process stands in for rank 0 or 1.)"""
    monkeypatch.setattr(steps.dist, "all_reduce", lambda tensor, *a, **kw: None)
    steps._SAID.clear()
    said = "[i] {}: eager launches on the card {}"
    state = create_train_state(_unet(), lr=LR)
    wrapper = torch.nn.Sequential(state.model)
    batch = {"clean": _u16((2, 16, 16, 4), 1)}
    pool = {"input": _u16((3, 16, 16, 4), 2), "target": _u16((3, 16, 16, 4), 3)}
    for nccl in (False, True):
        if nccl:  # a group whose backend query says NCCL
            monkeypatch.setattr(steps.dist, "is_initialized", lambda: True)
            monkeypatch.setattr(steps.dist, "get_backend", lambda group=None: "nccl")
        for capture in (True, False):
            eager = not (nccl and capture)
            why = HOST_COLLECTIVES if capture else EAGER_ARM
            steps._SAID.clear()
            wrapped = _synthetic(state.model, forward=wrapper, capture=capture)
            ranked = _synthetic(state.model, shard=(0, 2), capture=capture)
            pooled = make_train_scan(state.model, shard=(1, 2), batch=2, steps_per_call=1,
                                     capture=capture)
            for i in range(3):
                wrapped(state, batch, i)
                ranked(state, batch, i)
                pooled(state, pool, [i])
            for fn in (wrapped, ranked, pooled):
                assert (fn.graphs == {}) == eager and graph_replays(fn) == (0 if eager else 2)
            err = capsys.readouterr().err
            for what in ("train step", "pooled trainer"):
                assert err.count(said.format(what, why)) == eager, (nccl, capture, err)
    plain = _synthetic(state.model)
    for i in range(2):
        plain(state, batch, i)
    assert len(plain.graphs) == 1 and capsys.readouterr().err == ""


@pytest.mark.parametrize("pooled", [False, True], ids=["per_step", "pooled"])
def test_data_parallel_graph_all_reduces_grads_each_step_and_losses_each_call(
        fake_card, monkeypatch, pooled):
    """At a stubbed world 2 over an NCCL group (the group and its backend
    query patched, the collective counting and leaving its tensor as it
    is), the graph arm's eager call and its capture each call
    ``dist.all_reduce`` once per step for the gradients (NCCL's average
    of the call's flat f32 buffer, every parameter's gradient in it) and
    once per call for the losses (the capture is replayed at once); a
    replay runs no Python and calls none."""
    calls = []

    def all_reduce(tensor, op=steps.dist.ReduceOp.SUM, *a, **kw):
        calls.append((tensor.dtype, tensor.numel(), tensor.data_ptr(), op))

    monkeypatch.setattr(steps.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(steps.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(steps.dist, "get_backend", lambda group=None: "nccl")
    state = create_train_state(_unet(), lr=LR)
    k = 3 if pooled else 1
    if pooled:
        fn = make_train_scan(state.model, noise_model="eld", bank=_bank(), shard=(1, 2),
                             batch=4, steps_per_call=k)
        pool = {"clean": _u16((6, 16, 16, 4), 1)}
        run = lambda c: fn(state, pool, [fold_in(3, k * c + j) for j in range(k)])  # noqa: E731
    else:
        fn = _synthetic(state.model, shard=(1, 2))
        run = lambda c: fn(state, {"clean": _u16((2, 16, 16, 4), c)}, fold_in(3, c))  # noqa: E731
    n_grads = sum(p.numel() for p in state.model.parameters())
    for c in range(4):
        before = len(calls)
        run(c)
        made = calls[before:]
        if c >= 2:  # replays
            assert made == []
            continue
        call = _only(fn)
        grads = made[:-1]
        assert len(grads) == k and made[-1][1] == k
        assert all(g == (torch.float32, n_grads, call.flat.data_ptr(), steps.dist.ReduceOp.AVG)
                   for g in grads)
        assert made[-1][3] == steps.dist.ReduceOp.SUM
    assert graph_replays(fn) == 3 and state.step == 4 * k


@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_cpu_tensors_step_eagerly_whatever_capture(arch):
    """A CUDA graph needs a card: on the CPU the step runs eagerly with
    either ``capture``, holds no graph, and gives the same result."""
    results = []
    for capture in (True, False):
        state = create_train_state(_unet(arch=arch), lr=LR)
        step = _synthetic(state.model, capture=capture)
        m = [float(step(state, {"clean": _u16((2, 32, 32, 4), i)}, i)["Pixel"])
             for i in range(2)]
        assert step.graphs == {} and graph_replays(step) == 0
        results.append((m, [p.detach().clone() for p in state.model.parameters()]))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


def test_step_graph_equals_eld_tpus_train_step(fake_card):
    """The graph path's first two steps (the eager step and the capture,
    run for real here) against eld_tpu's make_train_step from the same
    weights on the same paired f32 batches, L1: losses within rtol 1e-5,
    parameters within ``test_torch_train``'s tolerance."""
    tm = _unet()
    jm = jax_build_arch("unet", 4, 4, base_width=4, skip_mode="split")
    jstate = _jax_state(state_dict_to_flax(tm.state_dict()))
    jstep = jax_make_train_step(jm, loss="l1")
    state = create_train_state(tm, lr=LR)
    step = make_train_step(tm, loss="l1")
    for i, batch in enumerate(_paired_batches(n=2, seed=6)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(i))
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, i)
        onp.testing.assert_allclose(float(m["Pixel"]), float(jm_["Pixel"]), rtol=1e-5)
    assert _only(step).graph is not None and state.step == int(jstate.step) == 2
    assert_params_close(jstate.params, tm, steps=2)


# ---- the eval forward ---------------------------------------------------------------

@pytest.mark.parametrize("chop", [False, True], ids=["pad", "chop"])
def test_eval_forward_graph_per_shape_and_dtype(fake_card, chop):
    """One graph per input (shape, dtype); the first call of each runs
    eagerly (and equals the eager forward), the second captures and
    replays, the third replays with its input in the graph's buffer; all
    graphs of one forward share one memory pool."""
    model = _unet(arch="unet_s2d")
    fwd = make_eval_forward(model, chop=chop, autocast_dtype=torch.bfloat16)
    eager = make_eval_forward(model, chop=chop, autocast_dtype=torch.bfloat16, capture=False)
    gen = torch.Generator().manual_seed(0)
    a = [torch.rand((1, 72, 88, 4), generator=gen) for _ in range(3)]
    b = torch.rand((2, 64, 64, 4), generator=gen)
    assert torch.equal(fwd(a[0]), eager(a[0]))
    assert list(fwd.graphs) == [((1, 72, 88, 4), torch.float32)]
    assert _only(fwd).graph is None
    assert torch.equal(fwd(a[1]), eager(a[1]))  # the capture ran it for real here
    fwd(a[2])
    assert torch.equal(_only(fwd).graph.seen[-1]["x"], a[2])
    for x in (b, b, b.bfloat16(), b.bfloat16()):
        fwd(x)
    assert sorted(fwd.graphs, key=str) == sorted(
        [((1, 72, 88, 4), torch.float32), ((2, 64, 64, 4), torch.float32),
         ((2, 64, 64, 4), torch.bfloat16)], key=str)
    assert graph_replays(fwd) == 2 + 1 + 1 and eager.graphs == {}
    assert len(fake_card) == 3 and len({id(p) for p in fake_card}) == 1


def test_eval_forward_output_is_never_the_graphs_own(fake_card):
    """A replay returns a copy: the next replay (here, the graph's output
    overwritten in place) leaves an earlier result as it was."""
    fwd = make_eval_forward(_unet())
    x = torch.rand((1, 32, 32, 4), generator=torch.Generator().manual_seed(1))
    fwd(x)
    out = fwd(x)
    call = _only(fwd)
    assert out is not call.out[0] and out.data_ptr() != call.out[0].data_ptr()
    kept = out.clone()
    call.out[0].fill_(-1.0)
    assert torch.equal(out, kept) and not torch.equal(fwd(x), kept)


def test_eval_forward_graph_follows_the_parameters_it_holds(fake_card, tmp_path):
    """The graph is bound to the model's parameters: Adam's in-place
    update and ``load_checkpoint`` (which copies into the same tensors)
    keep it; a replaced parameter drops it, and the next call runs
    eagerly again."""
    model = _unet()
    state = create_train_state(model, lr=LR)
    fwd = make_eval_forward(model)
    x = torch.rand((1, 32, 32, 4), generator=torch.Generator().manual_seed(2))
    fwd(x)
    fwd(x)
    call = _only(fwd)
    state.optimizer.zero_grad()
    model(x).abs().mean().backward()
    state.optimizer.step()
    path = ckpt.save_checkpoint(str(tmp_path), state, "g", async_=False)
    ckpt.load_checkpoint(path, create_train_state(model, lr=LR))
    fwd(x)
    assert call.graph is not None and call.replays == 2
    model.conv10_1.weight = torch.nn.Parameter(model.conv10_1.weight.detach().clone())
    fwd(x)
    assert call.graph is None and call.binding is not None
    fwd(x)
    assert call.graph is not None and call.replays == 3


def test_cpu_tensors_forward_eagerly_whatever_capture():
    model = _unet()
    x = torch.rand((1, 40, 24, 4), generator=torch.Generator().manual_seed(3))
    outs = []
    for capture in (True, False):
        fwd = make_eval_forward(model, capture=capture)
        outs += [fwd(x), fwd(x)]
        assert fwd.graphs == {}
    assert all(torch.equal(outs[0], o) for o in outs[1:])


# ---- the Engine --------------------------------------------------------------------

def _engine(tmp_path, **kw):
    return Engine(Config(device="cpu", noise="eld", include=4, base_width=4, batch_size=2,
                         is_train=True, checkpoints_dir=str(tmp_path), name="g",
                         no_verbose=True, save_epoch_freq=1, **kw))


def test_engine_trains_and_evaluates_through_graphs_and_drops_them_on_load(fake_card,
                                                                           tmp_path):
    """Engine.train's per-step trainer and Engine.eval's forward take the
    graph path (one graph per shape, replays from the second call);
    ``release_graphs`` drops every graph the Engine holds, and ``load``
    (new optimizer state tensors) calls it."""
    eng = _engine(tmp_path)
    loader = [{"clean": onp.random.default_rng(i).integers(0, 65535, (2, 16, 16, 4),
                                                           dtype=onp.uint16)}
              for i in range(4)]
    eng.train(loader)
    assert eng.iterations == 4 and graph_replays(eng._train_step) == 3
    assert [h[0] for h in eng.history] == [0, 1, 2, 3]
    item = {"input": onp.random.default_rng(9).random((32, 32, 4), dtype=onp.float32),
            "target": onp.random.default_rng(10).random((32, 32, 4), dtype=onp.float32)}
    for _ in range(3):
        eng.eval_one(item, crop=False)
    assert graph_replays(eng._fwd) == 2
    eng.train_pool({"clean": _u16((4, 16, 16, 4), 3)}, steps=2, steps_per_call=2)
    assert eng._train_scans
    ckpt.wait_for_saves()
    eng.load()
    assert eng._train_scans == {} and eng._train_step.graphs == {} and eng._fwd.graphs == {}
    eng.train(loader)
    assert graph_replays(eng._train_step) == 3  # eager, capture, replays anew


# ---- what stays eager says so once -----------------------------------------------

@pytest.mark.parametrize("what,why", [("train step", HOST_COLLECTIVES),
                                      ("pooled trainer", HOST_COLLECTIVES),
                                      ("train step", EAGER_ARM),
                                      ("pooled trainer", EAGER_ARM),
                                      ("eval forward", SPATIAL)])
def test_each_eager_path_says_so_once(capsys, what, why):
    """Each path that stays eager on the card (data parallelism over gloo
    or with ``capture=False``, the spatial forward) says so on stderr once
    per process, whatever the number of calls; on the CPU nothing is
    said, and without a reason ``capture`` decides, silently."""
    steps._SAID.clear()
    card, cpu = torch.device("cuda"), torch.device("cpu")
    for _ in range(3):
        assert not steps._captures(card, True, why, what)
    assert not steps._captures(cpu, True, why, what)
    assert not steps._captures(card, False, why, what)
    assert steps._captures(card, True, None, what) and not steps._captures(cpu, True, None, what)
    assert not steps._captures(card, False, None, what)
    err = capsys.readouterr().err
    assert err == f"[i] {what}: eager launches on the card {why}\n"
    say_eager(what, why)
    assert capsys.readouterr().err == ""


def test_the_graphs_step_random_is_its_own(fake_card):
    """The graph's StepRandom is its own object (the process's is not
    registered with any graph); it is reseeded in place at each step."""
    state = create_train_state(_unet(), lr=LR)
    step = _synthetic(state.model)
    batch = {"clean": _u16((2, 16, 16, 4), 1)}
    step(state, batch, 1)
    (slot,) = _only(step).slots
    gens = slot.generators()
    step(state, batch, 2)
    assert isinstance(slot, StepRandom) and slot is not step_random("cpu", 2)
    assert slot.generators() == gens
