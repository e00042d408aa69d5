"""The pooled train call as one device program: K1's seed from a tensor,
the captured call's seed buffer and bookkeeping, the rate as a tensor,
and make_train_scan on the CPU against eld_tpu's.

Nothing here can capture a CUDA graph (there is no card): the captured
call's host side runs with a stand-in graph, and the card's own checks
are ``tests/test_torch_cuda.py``'s and ``chip_smoke.py`` phase 10's.
make_train_scan against eld_tpu's: float32 on the CPU from identical
weights, one call of K = 3 on a one-record paired pool without
augmentation (the only randomness is then the picks, all of the one
record), losses within rtol 1e-5 and parameters within
``test_torch_train``'s tolerance.
"""

import copy
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.train.state import TrainState as JaxTrainState
from eld_tpu.train.state import make_optimizer as jax_make_optimizer
from eld_tpu.train.steps import make_train_scan as jax_make_train_scan
from eld_tpu_torch.compat.jax_params import flax_to_state_dict, state_dict_to_flax
from eld_tpu_torch.config import Config
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.kernels import seed_int64, seed_tensor, synthesize_kernel
from eld_tpu_torch.noise.params import load_camera_params, sample_params_batch
from eld_tpu_torch.train import checkpoints as ckpt
from eld_tpu_torch.train.engine import Engine
from eld_tpu_torch.train.state import (
    create_train_state,
    get_learning_rate,
    load_optimizer_state,
    optimizer_state_dict,
    set_learning_rate,
)
from eld_tpu_torch.train.steps import (
    StepRandom,
    _binding,
    _GraphCall,
    fold_in,
    make_train_scan,
    pick_batch,
    rank_noise_seed,
    step_random,
)
from tests.test_torch_fake_card import _FakeGraph, _RecordingGraph, install_fake_card

LR = 1e-4
SEEDS = [0, 7, 0x1234_5678_9ABC_DEF0, (1 << 63) + 5, (1 << 64) - 1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unet(seed=0, width=4):
    torch.manual_seed(seed)
    return build_arch("unet", 4, 4, base_width=width, skip_mode="split")


def _u16(shape, seed):
    return onp.random.default_rng(seed).integers(0, 65535, shape, dtype=onp.uint16)


# ---- K1's seed as a tensor -------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: hex(s))
def test_kernel_wrapper_takes_a_seed_tensor(seed):
    """A one-element int64 seed tensor holds the seed's 64 bits (seeds of
    2^63 and above as negative int64) and gives the int seed's output."""
    t = seed_tensor(seed)
    assert t.dtype == torch.int64 and t.shape == (1,)
    assert int(t) & ((1 << 64) - 1) == seed and int(t) == seed_int64(seed)
    bank = load_camera_params(include=4)
    gen = torch.Generator().manual_seed(3)
    clean = torch.rand((2, 16, 16, 4), generator=gen)
    params = sample_params_batch(gen, bank, 2)
    assert torch.equal(synthesize_kernel(t, clean, params, "eld"),
                       synthesize_kernel(seed, clean, params, "eld"))


def test_kernel_wrapper_refuses_a_seed_tensor_it_cannot_read():
    bank = load_camera_params(include=4)
    gen = torch.Generator().manual_seed(3)
    clean = torch.rand((2, 16, 16, 4), generator=gen)
    params = sample_params_batch(gen, bank, 2)
    for bad in (torch.tensor([1], dtype=torch.int32), torch.tensor([1, 2]),
                torch.tensor([1], device="meta")):
        with pytest.raises(ValueError, match="seed tensor"):
            synthesize_kernel(bad, clean, params)


# ---- the captured call's host side ------------------------------------------

def _scan_state():
    model = _unet()
    return create_train_state(model, lr=LR)


def _pooled_call(k):
    """A pooled call's runner of K steps on the CPU, as make_train_scan
    builds it on a card (its work never runs here)."""
    return _GraphCall(None, torch.device("cpu"), bind=_binding, slots=k, steps=k)


def test_seed_buffer_and_slots_hold_the_eager_loops_seeds():
    """For a call of K at Engine step s, slot j's generators are seeded as
    the eager loop's (fold_in(seeds[j], 0 / 2 / 3)) and draw the same
    numbers, and element j of the seed buffer is K1's seed of step j,
    rank_noise_seed(fold_in(cfg.seed, s + j)), as int64 bits."""
    k, step = 4, 123
    seeds = [fold_in(2018, step + j) for j in range(k)]
    call = _pooled_call(k)
    call._load_seeds(seeds)
    want = [seed_int64(rank_noise_seed(s)) for s in seeds]
    assert call.seeds.tolist() == want
    assert [int(v) & ((1 << 64) - 1) for v in call.seeds] == [fold_in(s, 1) for s in seeds]
    for rng, s in zip(call.slots, seeds):
        assert [g.initial_seed() for g in rng.generators()] == [fold_in(s, p) for p in (0, 2, 3)]
        ref = StepRandom("cpu").reseed(s)
        for a, b in zip(rng.generators(), ref.generators()):
            assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    # the slots are the call's own: a second call reseeds the same objects
    slots = [g for rng in call.slots for g in rng.generators()]
    call._load_seeds([s + 1 for s in seeds])
    assert [g for rng in call.slots for g in rng.generators()] == slots


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_a_ranks_call_seeds_its_noise_with_the_ranks_seed(plain):
    """Under data parallelism a call's noise is its rank's: element j of
    the seed buffer (or the plain noise's generator j) holds
    rank_noise_seed(seeds[j], rank, world), as the eager path seeds it,
    so two ranks draw different noise; their slots (the global batch's
    parameters, picks and masks) are seeded alike."""
    k, mask = 3, (1 << 64) - 1
    seeds = [fold_in(2018, 40 + j) for j in range(k)]
    calls = [_GraphCall(None, torch.device("cpu"), bind=_binding, slots=k, steps=k,
                        plain_noise=plain, shard=(r, 2)) for r in range(2)]
    for r, call in enumerate(calls):
        call._load_seeds(seeds)
        want = [rank_noise_seed(s, r, 2) for s in seeds]
        assert [int(v) & mask for v in call.seeds] == want
        assert [g.initial_seed() for g in call.noise] == (want if plain else [])
        assert [[g.initial_seed() for g in rng.generators()] for rng in call.slots] == [
            [fold_in(s, p) for p in (0, 2, 3)] for s in seeds]
    assert not set(calls[0].seeds.tolist()) & set(calls[1].seeds.tolist())


def test_a_replay_advances_step_and_launches_by_k_and_returns_copies():
    """A replay runs no Python: the call advances state.step by K and the
    K1 launch count by the launches the graph holds, per call, and returns
    copies of the graph's outputs (mean, K losses), which the next replay
    overwrites."""
    k = 3
    state = _scan_state()
    pool = {"clean": torch.from_numpy(_u16((4, 16, 16, 4), 0))}
    call = _pooled_call(k)
    call.graph, call.launches = _FakeGraph(), {synthesize_kernel: k}
    call.binding = _binding(state, pool)
    call.out = (torch.tensor(0.5), torch.tensor([0.75, 0.5, 0.25]))
    before = synthesize_kernel.launches
    got = []
    for c in range(2):
        got.append(call(state, pool, [fold_in(9, 10 * c + j) for j in range(k)]))
    assert state.step == 2 * k and call.graph.replays == 2 == call.replays
    assert synthesize_kernel.launches - before == 2 * k
    for t in call.out:
        t.fill_(9.0)  # the next replay's values
    assert float(got[0][0]) == 0.5 and got[1][1].tolist() == [0.75, 0.5, 0.25]
    assert call.seeds.tolist() == [seed_int64(rank_noise_seed(fold_in(9, 10 + j)))
                                   for j in range(k)]


class _UnlinkedGraph(_RecordingGraph):
    """The stand-in without its link back to the call it holds, as a
    graph on the card has none."""

    def link(self, call, state, inputs):
        pass


def test_a_dropped_trainer_frees_its_graph_without_the_cyclic_collector(monkeypatch):
    """Nothing refers to a trainer but its holder: dropped, its graph goes
    at once (on the card, with its memory pool), not when the cyclic
    collector next runs, which may be in the middle of another capture."""
    install_fake_card(monkeypatch.setattr, _UnlinkedGraph)
    state = _scan_state()
    fn = make_train_scan(state.model, noise_model="eld", bank=load_camera_params(include=4),
                         batch=2, steps_per_call=2)
    pool = {"clean": torch.from_numpy(_u16((4, 16, 16, 4), 0))}
    for c in range(3):  # eager, capture, replay
        fn(state, pool, [fold_in(2, 2 * c + j) for j in range(2)])
    (call,) = fn.graphs.values()
    assert call.graph.replays == 2 and fn.losses.shape == (2,)
    graph, call = weakref.ref(call.graph), None
    collecting = gc.isenabled()
    gc.disable()
    try:
        del fn
        assert graph() is None
    finally:
        if collecting:
            gc.enable()


def test_a_new_pool_or_optimizer_state_drops_the_graph():
    """The graph holds the pool's, the parameters' and the optimizer's
    tensors: another pool, or an optimizer state loaded over the old one,
    drops it, and the call runs eagerly again (then captures anew)."""
    state = _scan_state()
    pool = {"clean": torch.from_numpy(_u16((4, 16, 16, 4), 0))}
    eager = []
    call = _pooled_call(2)
    call._eager = lambda st, pl: eager.append(pl) or {}
    call.graph, call.binding = _FakeGraph(), _binding(state, pool)
    call.out = (torch.tensor(0.0), torch.zeros(2))
    call(state, pool, [1, 2])
    assert not eager and call.graph is not None
    other = {"clean": pool["clean"].clone()}
    call(state, other, [1, 2])
    assert len(eager) == 1 and eager[0] is other and call.graph is None
    # a loaded optimizer state: new state tensors
    m = make_train_scan(state.model, batch=2, steps_per_call=1)
    m(state, {"input": pool["clean"], "target": pool["clean"]}, [5])  # Adam's state exists
    call.graph, call.binding = _FakeGraph(), _binding(state, other)
    load_optimizer_state(state.optimizer, copy.deepcopy(optimizer_state_dict(state.optimizer)))
    call(state, other, [1, 2])
    assert len(eager) == 2 and call.graph is None


def test_pick_batch_reuses_the_processs_generators():
    """pick_batch and the per-step path draw from one StepRandom per device
    (no new generators per step), reseeded from the step seed; a given
    StepRandom gives the same batch."""
    assert step_random("cpu", 1) is step_random("cpu", 2)
    pool = {"input": torch.from_numpy(_u16((6, 8, 8, 4), 1)),
            "target": torch.from_numpy(_u16((6, 8, 8, 4), 2))}
    a = pick_batch(pool, 5, 77)
    b = pick_batch(pool, 5, None, rng=StepRandom("cpu").reseed(77))
    for key in pool:
        assert torch.equal(a[key], b[key])


def test_pool_on_the_cpu_runs_the_eager_loop():
    """A CUDA graph needs a card: on the CPU the pooled call runs the eager
    loop whatever ``capture`` says, and captures nothing."""
    model = _unet()
    pool = {"input": torch.from_numpy(_u16((3, 16, 16, 4), 0)),
            "target": torch.from_numpy(_u16((3, 16, 16, 4), 1))}
    for capture in (True, False):
        fn = make_train_scan(model, batch=2, steps_per_call=2, capture=capture)
        m = fn(create_train_state(model), pool, [1, 2])
        assert fn.graphs == {} and fn.losses.shape == (2,)
        assert set(m) == {"Pixel", "PixelLast"} and float(m["PixelLast"]) == float(fn.losses[-1])


# ---- the rate as a tensor ----------------------------------------------------

def test_rate_tensor_is_written_in_place_and_read_back():
    """A rate held as a 0-dim tensor (the card's capturable Adam) is
    written in place, so a graph that captured it sees the new rate; a
    step at the tensor rate equals a step at the same float rate (to the
    rate's f32 rounding); a
    checkpoint stores it as a float, and loading keeps the tensor."""
    models = [_unet(), _unet()]
    opts = [torch.optim.Adam(models[0].parameters(), lr=torch.tensor(LR), foreach=False),
            torch.optim.Adam(models[1].parameters(), lr=LR, foreach=False)]
    states = [create_train_state(m) for m in models]
    for state, opt in zip(states, opts):
        state.optimizer = opt
    rate = opts[0].param_groups[0]["lr"]
    for state in states:
        assert get_learning_rate(state) == pytest.approx(LR)
        set_learning_rate(state, 5e-5)
    assert opts[0].param_groups[0]["lr"] is rate and float(rate) == pytest.approx(5e-5)
    x = torch.rand((2, 16, 16, 4), generator=torch.Generator().manual_seed(0))
    init = [p.detach().clone() for p in models[0].parameters()]
    for state in states:
        state.optimizer.zero_grad()
        state.model(x).abs().mean().backward()
        state.optimizer.step()
    # the tensor holds the rate in f32: the step (~5e-5) changes by its
    # rounding, a relative 6e-8, i.e. under 1e-10, and the parameter's own
    # rounding after the update then differs by at most one f32 ulp
    assert all(not torch.equal(p, q) for p, q in zip(models[0].parameters(), init))
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(a, b, rtol=2.0 ** -23, atol=1e-10)
    saved = optimizer_state_dict(opts[0])
    assert isinstance(saved["param_groups"][0]["lr"], float)
    set_learning_rate(states[0], 1.0)
    load_optimizer_state(opts[0], saved)
    assert opts[0].param_groups[0]["lr"] is rate
    assert float(rate) == pytest.approx(5e-5)


def test_cpu_optimizer_keeps_a_float_rate_and_loads_a_cards_checkpoint():
    """On the CPU the rate is a float and the optimizer not capturable
    (capturable needs a card); an opt_g saved on a card (capturable, its
    step counters beside the parameters) loads as this optimizer's own
    kind and trains on."""
    state = create_train_state(_unet(), lr=LR)
    group = state.optimizer.param_groups[0]
    assert isinstance(group["lr"], float) and not group["capturable"]
    x = torch.rand((2, 16, 16, 4), generator=torch.Generator().manual_seed(0))
    state.model(x).abs().mean().backward()
    state.optimizer.step()
    saved = optimizer_state_dict(state.optimizer)
    saved["param_groups"] = [{**g, "capturable": True} for g in saved["param_groups"]]
    load_optimizer_state(state.optimizer, saved)
    assert not state.optimizer.param_groups[0]["capturable"]
    state.optimizer.zero_grad()
    state.model(x).abs().mean().backward()
    state.optimizer.step()
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())


# ---- make_train_scan on the CPU against eld_tpu's ---------------------------

def test_train_scan_on_the_cpu_equals_eld_tpus():
    """One call of K = 3 over a one-record paired uint16 pool, augmentation
    off, f32, L1: the port's losses and parameters against eld_tpu's
    make_train_scan from the same weights."""
    k = 3
    rng = onp.random.default_rng(4)
    pool = {"input": rng.integers(0, 65535, (1, 32, 32, 4), dtype=onp.uint16),
            "target": rng.integers(0, 65535, (1, 32, 32, 4), dtype=onp.uint16)}
    tm = _unet()
    jm = jax_build_arch("unet", 4, 4, base_width=4, skip_mode="split")
    tx = jax_make_optimizer(LR, 0.9, 0.0)
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(tm.state_dict()))
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32), tx=tx)
    jfn = jax_make_train_scan(jm, loss="l1", batch=2, steps_per_call=k, augment=False,
                              donate=False)
    jstate, jm_ = jfn(jstate, {key: jnp.asarray(v) for key, v in pool.items()},
                      jax.random.PRNGKey(0))

    state = create_train_state(tm, lr=LR)
    m = make_train_scan(tm, loss="l1", batch=2, steps_per_call=k, augment=False)(
        state, {key: torch.from_numpy(v) for key, v in pool.items()},
        [fold_in(2018, j) for j in range(k)])
    onp.testing.assert_allclose(float(m["Pixel"]), float(jm_["Pixel"]), rtol=1e-5)
    onp.testing.assert_allclose(float(m["PixelLast"]), float(jm_["PixelLast"]), rtol=1e-5)
    assert state.step == int(jstate.step) == k
    ref, got = flax_to_state_dict(jstate.params), tm.state_dict()
    close = total = 0
    for name, v in ref.items():
        d = (got[name] - v).abs()
        assert float(d.max()) <= 2 * LR * k, name
        close += int((d <= 1e-6).sum())
        total += d.numel()
    assert close / total >= 0.999


# ---- the Engine's graph cache -------------------------------------------------

def test_engine_drops_its_pooled_trainers_on_load(tmp_path):
    """The per-(K, batch) trainers, and on a card the graphs they hold,
    live across epochs on one pool; Engine.load (a resume: new optimizer
    state tensors) drops them."""
    eng = Engine(Config(device="cpu", noise="eld", include=4, base_width=4, batch_size=2,
                        is_train=True, checkpoints_dir=str(tmp_path), name="g",
                        no_verbose=True, save_epoch_freq=1))
    pool = {"clean": torch.from_numpy(_u16((4, 16, 16, 4), 3))}
    eng.train_pool(pool, steps=3, steps_per_call=2)
    fns = dict(eng._train_scans)
    assert sorted(fns) == [(1, 2), (2, 2)]
    eng.train_pool(pool, steps=2, steps_per_call=2)
    assert eng._train_scans[(2, 2)] is fns[(2, 2)]
    ckpt.wait_for_saves()
    eng.load()
    assert eng._train_scans == {} and eng.iterations == 5
