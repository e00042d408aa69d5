"""Stand-ins for the card's CUDA graph machinery, so that the host side of
the graph path (``train/steps.py::_GraphCall``) runs on the CPU.

``install_fake_card(setattr)`` routes CPU tensors down the graph path: a
graph that counts its replays and remembers its registered generators, a
capture that runs the call's Python for real on the CPU, streams that do
nothing, and K1's wrapper and the plain versions of every other kernel
entry point registered with ``_build.counted`` (each module's
``plain_forward`` and ``plain_backward``: the conv epilogue, Restormer's
attention, LayerNorm and depthwise convolutions) counting their CPU calls
as launches of that entry point, K1's stand-in registered as a counted
entry point too.
With ``_RecordingGraph`` a replay does nothing; with ``_ReplayingGraph``
it runs the captured call's Python again on the graph's buffers and
draws and writes its outputs into the graph's own, as a replay on the
card recomputes them.  ``setattr`` is pytest's ``monkeypatch.setattr``
in a test, or the builtin in a process of its own (the gloo ranks of
``test_torch_parallel.py``, which import no JAX).

The tests here hold the replaying stand-in to the eager path: a graph
path that replays by rerunning must train exactly as ``capture=False``.
"""

import contextlib
import inspect
import sys

import numpy as onp
import pytest
import torch

from eld_tpu_torch import _build
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.params import load_camera_params
from eld_tpu_torch.train import steps
from eld_tpu_torch.train.state import create_train_state


class _FakeGraph:
    """Stands in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _RecordingGraph(_FakeGraph):
    """The stand-in, plus the generators registered with it and a snapshot
    of the runner's input buffers at each replay."""

    def __init__(self):
        super().__init__()
        self.generators, self.seen = [], []
        self.call = self.state = self.inputs = None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def link(self, call, state, inputs):
        """The call captured into this graph, its state and the inputs the
        capture read (the call's own buffers, or the bound pool)."""
        self.call, self.state, self.inputs = call, state, inputs

    def replay(self):
        super().replay()
        if self.call is not None:
            self.seen.append({k: v.clone() for k, v in self.call.inputs.items()})


class _ReplayingGraph(_RecordingGraph):
    """A replay runs the captured call's Python again, on the inputs the
    capture read and the draws its slots now hold, and writes the results
    into the graph's outputs; ``state.step`` and the kernels' launch
    counts are left to the runner, as after a replay on the card.  The
    replay that follows the capture in the same call reruns nothing: the
    capture ran that call's work for real here, where the card's executes
    none."""

    def link(self, call, state, inputs):
        super().link(call, state, inputs)
        self.captured = True

    def replay(self):
        super().replay()
        if self.captured:
            self.captured = False
            return
        state = self.state
        step, launches = (state.step if state is not None else 0), _build.launch_counts()
        for out, new in zip(self.call.out, self.call._run(state, self.inputs)):
            out.copy_(new)
        if state is not None:
            state.step = step
        for entry, n in launches.items():
            entry.launches = n


class _FakeStream:
    def wait_stream(self, other):
        pass


def install_fake_card(setattr, graph=_RecordingGraph):
    """Patch ``steps`` and ``torch.cuda`` (through ``setattr``) so that CPU
    tensors take the graph path with ``graph`` standing in for
    ``torch.cuda.CUDAGraph``.  Returns the memory pool of each capture."""
    real_captures, real_kernel = steps._captures, steps.synthesize_kernel
    real_capture = steps._GraphCall._capture
    pools = []

    def counting_kernel(*args, **kw):
        counting_kernel.launches += 1
        return real_kernel(*args, **kw)

    def counting(plain, entry):
        def run(*args):
            entry.launches += 1
            return plain(*args)
        return run

    @contextlib.contextmanager
    def capture(g, pool=None, capture_error_mode=None):
        pools.append(pool)
        yield

    def capture_and_link(self, state, inputs):
        real_capture(self, state, inputs)
        self.graph.link(self, state, self.inputs if self.static else inputs)

    setattr(steps, "_captures", lambda device, *a: real_captures(torch.device("cuda"), *a))
    setattr(steps, "synthesize_kernel", counting_kernel)
    for entry in _build.COUNTED:  # a kernel's CPU runs count as its entry point's launches
        module = sys.modules[entry.__module__]
        for plain in ("plain_forward", "plain_backward"):
            if hasattr(module, plain):
                setattr(module, plain, counting(getattr(module, plain), entry))
    setattr(_build, "COUNTED", list(_build.COUNTED))  # the registration below is undone
    _build.counted(counting_kernel)
    setattr(steps._GraphCall, "_capture", capture_and_link)
    setattr(torch.cuda, "CUDAGraph", graph)
    setattr(torch.cuda, "graph", capture)
    setattr(torch.cuda, "graph_pool_handle", lambda: object())
    setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    setattr(torch.Tensor, "record_stream", lambda self, s: None)
    return pools


# ---- the replaying stand-in against the eager path ----------------------------

def _unet(arch="unet"):
    torch.manual_seed(0)
    return build_arch(arch, 4, 4, base_width=4, skip_mode="split")


def _u16(shape, seed):
    return torch.from_numpy(onp.random.default_rng(seed).integers(0, 65535, shape,
                                                                  dtype=onp.uint16))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, as in the other ``test_torch_*``
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_replaying_stand_in_trains_as_the_eager_step(monkeypatch, impl):
    """Five synthetic steps: the eager one, the capture (replayed at once)
    and three replays that rerun the call's Python on the graph's buffers
    and reseeded draws; every loss and the parameters equal
    capture=False's exactly, and the runner counts the steps and K1's
    launches as the eager path does."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    bank = load_camera_params(include=4)
    runs = []
    for capture in (True, False):
        state = create_train_state(_unet(), lr=1e-4)
        step = steps.make_train_step(state.model, noise_model="eld", bank=bank,
                                     noise_impl=impl, capture=capture)
        steps.synthesize_kernel.launches = 0
        losses = [float(step(state, {"clean": _u16((2, 16, 16, 4), i)}, steps.fold_in(4, i))
                        ["Pixel"]) for i in range(5)]
        runs.append((losses, [p.detach().clone() for p in state.model.parameters()],
                     state.step, steps.synthesize_kernel.launches, steps.graph_replays(step)))
    (lg, pg, sg, ng, rg), (le, pe, se, ne, re_) = runs
    assert (rg, re_) == (4, 0) and sg == se == 5 and ng == ne == (5 if impl == "auto" else 0)
    assert lg == le
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))


def test_replaying_stand_in_trains_the_pool_as_the_eager_loop(monkeypatch):
    """Four pooled calls of K = 2 (eager, capture, two replays) against
    the eager loop: every call's K losses and the parameters exactly."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)
    bank = load_camera_params(include=4)
    pool = {"clean": _u16((6, 32, 32, 4), 1)}
    runs = []
    for capture in (True, False):
        state = create_train_state(_unet("unet_s2d"), lr=1e-4)
        fn = steps.make_train_scan(state.model, noise_model="eld", bank=bank, batch=2,
                                   steps_per_call=2, capture=capture)
        losses = []
        for c in range(4):
            fn(state, pool, [steps.fold_in(8, 2 * c + j) for j in range(2)])
            losses.append(fn.losses.clone())
        runs.append((losses, [p.detach().clone() for p in state.model.parameters()],
                     steps.graph_replays(fn)))
    (lg, pg, rg), (le, pe, re_) = runs
    assert (rg, re_) == (3, 0)
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))


# ---- launch counts through the registry ------------------------------------------

def test_a_replayed_graph_counts_an_entry_point_registered_outside_the_package(monkeypatch):
    """A kernel entry point registered with ``_build.counted`` here, in a
    test, is counted through an eager call, a capture (replayed at once) and
    a replay: the capture records the launches the graph holds and restores
    the count, each replay adds them, and ``_GraphCall`` names no counted
    entry point."""
    install_fake_card(monkeypatch.setattr, _ReplayingGraph)

    @_build.counted
    def toy_kernel(x):
        toy_kernel.launches += 1
        return x * 2

    def run(state, inputs, draws, grads):
        return (toy_kernel(toy_kernel(inputs["x"])),)

    call = steps._GraphCall(run, torch.device("cpu"), bind=lambda state, inputs: [],
                            static=True)
    counts, outs = [], []
    for c in range(3):  # eager, capture (replayed at once), replay
        before = toy_kernel.launches
        (out,) = call(None, {"x": torch.full((3,), float(c))})
        counts.append(toy_kernel.launches - before)
        outs.append(out.tolist())
    assert counts == [2, 2, 2] and call.replays == 2
    assert call.launches[toy_kernel] == 2
    assert outs == [[0.0] * 3, [4.0] * 3, [8.0] * 3]
    source = inspect.getsource(steps._GraphCall)
    assert toy_kernel in _build.COUNTED
    assert not [entry.__name__ for entry in _build.COUNTED if entry.__name__ in source]
