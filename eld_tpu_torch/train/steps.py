"""Train and eval steps (counterpart of ``eld_tpu/train/steps.py``).

The flagship path is the synthetic-noise step: a batch of clean patches
arrives on the device; per-image noise parameters are sampled there, the
fused noise kernel synthesizes the noisy input, and the U-Net forward,
backward and Adam step follow.  Noise is applied outside autograd (it
needs no gradient), as in the JAX step.  Without a noise model the step
takes paired {"input", "target"} batches (the ``train_real`` path).

``make_train_scan`` is the pooled form: K steps per call over a patch
pool that lives on the device, each step picking and augmenting its own
batch there.  ``make_eval_forward`` is the inference forward with the
edge-pad to the arch's alignment, or the 4-tile chop.

On a card all three run as CUDA graphs (``_GraphCall``), as eld_tpu
``jax.jit``s each one into one XLA program: the step and the forward one
graph per input shape, the pooled call one per (K, batch).  The first
call of a shape runs eagerly, the second captures and replays, every
later one replays.  Under data parallelism over an NCCL group the train
paths capture too, the gradient all-reduce inside the graph; over a
gloo group they stay eager (its collectives run on the host), and
``capture=False`` keeps any path eager on a card; a path that stays
eager says so once.

Randomness is a pure function of the step seed, which the Engine derives
from (cfg.seed, iteration) with ``fold_in``, so a resumed run sees the
same noise and the same picks.  Each step seed is split the same way
everywhere: ``fold_in(seed, 0)`` samples the noise parameters, 1 seeds
the noise, 2 the pool picks and 3 the augmentation masks.  A step draws
through a ``StepRandom`` (the generators of 0, 2 and 3) and the noise
seed, an int or, in a captured call, a one-element int64 tensor on the
card that the noise kernel reads when it runs.

Data parallelism (``shard=(rank, world)``, one rank per card): every rank
draws the GLOBAL batch's randomness from the step seed (the noise
parameters, and in the pool the picks and the augmentation masks) and
keeps its own rows (``parallel.mesh.rank_rows``), so the global batch is
the one-process run's.  The noise of a rank's rows is seeded with
``rank_noise_seed``.  The gradients are averaged over the ranks: on the
eager path by the DistributedDataParallel wrapper the step calls, in a
CUDA graph by one explicit all-reduce of a flat buffer between the
backward and Adam (``_GraphCall._mean_grads``), as XLA puts the psum
inside eld_tpu's mesh program.  The reported loss is the mean over
ranks, reduced once per call.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as onp
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from eld_tpu_torch import _build
from eld_tpu_torch.models.losses import init_loss
from eld_tpu_torch.noise.kernels import seed_int64, synthesize_kernel
from eld_tpu_torch.noise.model import synthesize
from eld_tpu_torch.noise.params import CameraParamsBank, sample_params_batch, take_rows
from eld_tpu_torch.ops.chop import forward_chop
from eld_tpu_torch.parallel.mesh import rank_rows
from eld_tpu_torch.train.state import TrainState
from eld_tpu_torch.utils.logging import span

NOISE_IMPLS = ("auto", "kernel", "plain")
_MASK64 = (1 << 64) - 1
# the same f32 reciprocals as PatchStore's normalization
_INV_U16 = float(onp.float32(1.0 / 65535.0))
_INV_U8 = float(onp.float32(1.0 / 255.0))


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that scrambles bits."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed derived from (seed, data), like ``jax.random.fold_in``."""
    return _mix64(_mix64(int(seed) & _MASK64) ^ (int(data) & _MASK64))


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """uint16/uint8 batches are normalized on the device (a quarter / half
    the bytes of f32 cross the host link)."""
    if x.dtype == torch.uint16:
        return x.to(torch.float32) * _INV_U16
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * _INV_U8
    return x


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    """Autocast to ``dtype`` (none for None), without the weight-cast cache,
    as CUDA graph capture needs: the U-Net casts each weight once a forward,
    so the cache saves nothing."""
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype, cache_enabled=False)


def rank_noise_seed(seed: int, rank: int = 0, world: int = 1) -> int:
    """The noise seed of ``rank``'s rows at step seed ``seed``:
    ``fold_in(seed, 1)`` in a one-rank run, and ``fold_in(fold_in(seed, 1),
    rank)`` under data parallelism, so each rank draws its own stream.
    Not ``seed + rank * c``: additive seeding is what made the TPU kernel
    replay streams (eld_tpu/noise/kernels.py:78-85)."""
    noise = fold_in(seed, 1)
    return noise if world == 1 else fold_in(noise, rank)


class StepRandom:
    """The generators one step draws from, on one device: the noise
    parameters, the pool picks and the augmentation masks, reseeded from
    the step seed by ``reseed`` (``fold_in(seed, 0)``, 2 and 3)."""

    def __init__(self, device):
        self.params = torch.Generator(device=device)
        self.pick = torch.Generator(device=device)
        self.augment = torch.Generator(device=device)

    def reseed(self, seed: int) -> "StepRandom":
        self.params.manual_seed(fold_in(seed, 0))
        self.pick.manual_seed(fold_in(seed, 2))
        self.augment.manual_seed(fold_in(seed, 3))
        return self

    def generators(self) -> Tuple[torch.Generator, ...]:
        return self.params, self.pick, self.augment


_STEP_RANDOM: Dict[torch.device, StepRandom] = {}


def step_random(device, seed: int) -> StepRandom:
    """The process's ``StepRandom`` for ``device``, reseeded from ``seed``:
    the per-step path and ``pick_batch`` reuse one set of generators per
    device instead of making new ones every step."""
    device = torch.device(device)
    rng = _STEP_RANDOM.get(device)
    if rng is None:
        rng = _STEP_RANDOM[device] = StepRandom(device)
    return rng.reseed(seed)


def global_mean(values: torch.Tensor, world: int = 1) -> torch.Tensor:
    """The mean over the ranks of each rank's ``values``, one all-reduce;
    ``values`` itself in a one-rank run."""
    if world == 1:
        return values
    out = values.detach().clone()
    dist.all_reduce(out)
    return out / world


def _make_local_step(loss, noise_model, bank, k_mode, noise_impl, autocast_dtype, forward, shard):
    """``step(state, batch, rng, noise_seed, grads=None) -> loss``: one
    optimizer step on this rank's rows, drawing its noise parameters from
    ``rng`` (a ``StepRandom`` seeded from the step seed) and its noise from
    ``noise_seed`` (``rank_noise_seed`` of it: an int, or in a CUDA graph a
    one-element int64 tensor on the card for K1 and a generator seeded
    with it for the plain noise); returns the rank's own loss (detached,
    on the device).  ``grads(model)``, where given, averages the
    gradients over the ranks before Adam, and the step then calls
    ``state.model`` itself, not ``forward`` (a CUDA graph's data-parallel
    step: DDP's hooks do nothing when its wrapper is not called)."""
    synthetic = noise_model is not None
    if synthetic and bank is None:
        raise ValueError("synthetic training needs a CameraParamsBank")
    if noise_impl not in NOISE_IMPLS:
        raise ValueError(f"noise_impl must be one of {NOISE_IMPLS}, got {noise_impl!r}")
    loss_fn = init_loss(loss)
    rank, world = shard

    def make_noisy(rng, noise_seed, clean):
        n = clean.shape[0] * world  # the global batch's parameters, then this rank's rows
        nparams = sample_params_batch(rng.params, bank, n, k_mode=k_mode)
        if world > 1:
            nparams = take_rows(nparams, rank_rows(rank, world, n))
        if noise_impl == "plain":
            # a graph's plain noise has a generator of its own; otherwise the
            # parameters are drawn, and their generator is reseeded for the noise
            gen = (noise_seed if isinstance(noise_seed, torch.Generator)
                   else rng.params.manual_seed(int(noise_seed)))
            return synthesize(gen, clean, nparams, model=noise_model, clip=True)
        return synthesize_kernel(noise_seed, clean, nparams, model=noise_model, clip=True)

    def step(state: TrainState, batch, rng: StepRandom, noise_seed, grads=None) -> torch.Tensor:
        if synthetic:
            clean = to_f32(batch["clean"]).contiguous()
            with torch.no_grad():
                noisy = make_noisy(rng, noise_seed, clean)
            target = clean
        else:
            noisy = to_f32(batch["input"])
            target = to_f32(batch["target"])

        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with _autocast(noisy.device, autocast_dtype):
            pred = (state.model if forward is None or grads is not None else forward)(noisy)
        loss_val = loss_fn(pred.float(), target)
        loss_val.backward()
        if grads is not None:
            grads(state.model)
        state.optimizer.step()
        state.step += 1
        return loss_val.detach()

    return step


def make_train_step(
    model: nn.Module,
    loss: str = "l1",
    noise_model: Optional[str] = None,
    bank: Optional[CameraParamsBank] = None,
    k_mode: str = "overridden",
    noise_impl: str = "auto",
    autocast_dtype: Optional[torch.dtype] = None,
    forward: Optional[nn.Module] = None,
    shard: tuple = (0, 1),
    capture: bool = True,
):
    """Build ``step(state, batch, seed) -> metrics``; updates ``state`` in place.

    With ``noise_model`` the batch is {"clean": (N, H, W, C)} and the noisy
    input is synthesized on the batch's device; otherwise {"input",
    "target"}.  ``noise_impl``: "auto" launches the fused kernel for CUDA
    tensors and runs the plain version for CPU tensors; "kernel" is the
    same (a CPU tensor has no kernel); "plain" runs the plain PyTorch
    version on any device.  ``autocast_dtype`` (e.g. torch.bfloat16) runs
    the U-Net under autocast over f32 parameters.

    ``shard=(rank, world)``: the batch holds this rank's N rows of a global
    batch of N * world, ``forward`` is the DistributedDataParallel wrapper
    of ``state.model`` the eager step calls (default: ``state.model``),
    and "Pixel" is the mean over the ranks (see the module docstring).

    On a card the step is one CUDA graph per batch signature (the keys,
    shapes and dtypes; ``_GraphCall``), as eld_tpu's is one ``jax.jit``
    program per shape: the first step of a signature runs eagerly, the
    second captures and replays, every later one copies its batch into
    the graph's input buffers and replays.  The same seed gives the same
    noise parameters and noise as the eager step, and "Pixel" is a copy
    of the graph's loss.  Under data parallelism (a ``forward`` wrapper or
    ``shard[1] > 1``) over an NCCL group the graph holds the gradient
    all-reduce and the loss's mean over the ranks too.  The step stays
    eager for CPU tensors, under data parallelism over a group that is
    not NCCL (said once) and with ``capture=False`` (the A/B against the
    graph).  The returned function's ``graphs`` holds the graphs by
    signature.
    """
    step = _make_local_step(loss, noise_model, bank, k_mode, noise_impl, autocast_dtype,
                            forward, shard)
    parallel = forward is not None or shard[1] > 1
    graphs: Dict[tuple, _GraphCall] = {}

    def run(state: TrainState, batch, draws, grads=None):
        ((rng, noise_seed),) = draws
        return (global_mean(step(state, batch, rng, noise_seed, grads), shard[1]),)

    def reported(state: TrainState, batch, seed: int):
        dev = next(iter(batch.values())).device
        if _captures(dev, capture, _eager_reason(parallel, capture), "train step"):
            key = tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())
            call = graphs.get(key)
            if call is None:
                call = graphs[key] = _GraphCall(run, dev, bind=_state_binding, slots=1, steps=1,
                                                static=True, plain_noise=noise_impl == "plain",
                                                shard=shard, all_reduce=parallel)
            (loss,) = call(state, batch, [seed])
            return {"Pixel": loss}
        (loss,) = run(state, batch, [(step_random(dev, seed), rank_noise_seed(seed, *shard))])
        return {"Pixel": loss}

    reported.graphs = graphs
    return reported


def augment_masks(generator: torch.Generator, n: int):
    """Three independent fair coins per sample: (H-flip, W-flip, transpose),
    each a bool tensor of shape (n,) on the generator's device."""
    return tuple(torch.rand((3, n), generator=generator, device=generator.device) < 0.5)


def augment_batch(imgs: Sequence[torch.Tensor], flip_h: torch.Tensor, flip_w: torch.Tensor,
                  transpose: torch.Tensor):
    """Per-sample joint flip/flip/transpose of (N, H, W, C) batches, given
    the three (N,) bool masks (eld_tpu's ``_augment_batch`` draws the same
    masks from its key).  The transpose applies to square patches only.
    Packed CFA planes flip without a channel reorder, as in the reference."""
    def where(mask, a, b):
        return torch.where(mask.reshape(-1, 1, 1, 1), a, b)

    out = [where(flip_h, x.flip(1), x) for x in imgs]
    out = [where(flip_w, x.flip(2), x) for x in out]
    if imgs[0].shape[1] == imgs[0].shape[2]:
        out = [where(transpose, x.transpose(1, 2), x) for x in out]
    return [x.contiguous() for x in out]


def _gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool[idx].  A uint16 pool is gathered through an int16 view of the
    same bytes, which is exact: CUDA's index kernels do not cover the
    unsigned 16-bit type in every torch release."""
    if pool.dtype == torch.uint16:
        return pool.view(torch.int16)[idx].view(torch.uint16)
    return pool[idx]


def pick_batch(pool: Dict[str, torch.Tensor], batch: int, seed: Optional[int],
               rows: Optional[slice] = None, augment: bool = True,
               rng: Optional[StepRandom] = None):
    """One step's batch from a device-resident pool: ``batch`` rows picked
    uniformly with replacement, the same rows from every entry (paired
    pools stay aligned), converted to f32, then jointly augmented (unless
    ``augment`` is false; the picks are the same either way).  With
    ``rows`` only those rows of the picked batch (a data-parallel rank's)
    are gathered and augmented.  The picks and masks come from ``rng``,
    already seeded from the step seed, or else from the process's
    generators reseeded from ``seed`` (``step_random``)."""
    first = next(iter(pool.values()))
    dev = first.device
    if rng is None:
        rng = step_random(dev, seed)
    idx = torch.randint(0, first.shape[0], (batch,), generator=rng.pick, device=dev)
    if rows is not None:
        idx = idx[rows]
    out = {k: to_f32(_gather_rows(v, idx)) for k, v in pool.items()}
    if not augment:
        return out
    masks = augment_masks(rng.augment, batch)
    if rows is not None:
        masks = tuple(m[rows] for m in masks)
    return dict(zip(out, augment_batch(list(out.values()), *masks)))


# why a path on the card stays eager (``say_eager``)
HOST_COLLECTIVES = ("under data parallelism over a process group that is not NCCL (gloo's "
                    "collectives run on the host, which a CUDA graph cannot hold)")
EAGER_ARM = ("under data parallelism with capture=False (the eager arm: DistributedDataParallel "
             "averages the gradients)")
SPATIAL = ("under --mesh_spatial (the halo-sharded forward crosses cards; it is not captured "
           "in a CUDA graph)")
_SAID: set = set()


def say_eager(what: str, why: str):
    """Say on stderr, once per process, that ``what`` issues every launch
    from Python on the card, and ``why``."""
    msg = f"[i] {what}: eager launches on the card {why}"
    if msg not in _SAID:
        _SAID.add(msg)
        print(msg, file=sys.stderr)


def nccl_group() -> bool:
    """Whether the default process group is NCCL's, whose collectives run
    on the card and so can be captured in a CUDA graph."""
    return dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl"


def _eager_reason(parallel: bool, capture: bool) -> Optional[str]:
    """Why a data-parallel train path stays eager on the card: its group
    is not NCCL's, or ``capture`` is off (None: not data-parallel, or it
    captures)."""
    if not parallel:
        return None
    if not capture:
        return EAGER_ARM
    return None if nccl_group() else HOST_COLLECTIVES


def _captures(device: torch.device, capture: bool, eager_reason: Optional[str],
              what: str) -> bool:
    """Whether a call of ``what`` on ``device`` runs as a CUDA graph: on a
    card with ``capture`` set and no ``eager_reason``, which is said once."""
    if device.type != "cuda":
        return False
    if eager_reason is not None:
        say_eager(what, eager_reason)
        return False
    return capture


def graph_replays(fn) -> int:
    """The CUDA graph replays of a train step, pooled trainer or eval
    forward built here, over all its graphs."""
    return sum(call.replays for call in fn.graphs.values())


def _binding(state: TrainState, pool: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The tensors a captured train call reads and writes in place: the
    pool, the parameters, the optimizer's state and rate tensors.  A graph
    is valid while these are the same tensors on the same storage."""
    out = list(pool.values()) + list(state.model.parameters())
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            out.append(group["lr"])
        for p in group["params"]:
            out += [v for v in state.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
    return out


def _state_binding(state: TrainState, inputs) -> List[torch.Tensor]:
    """A step's binding: its batch is copied into the graph's buffers, so
    only the parameters and the optimizer's tensors are bound."""
    return _binding(state, {})


def _same_binding(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(x is y and x.data_ptr() == y.data_ptr()
                                    for x, y in zip(a, b))


class _GraphCall:
    """One call on one card as one CUDA graph (PyTorch's whole-network
    capture), replayed by one launch: the mechanism of the pooled call,
    the per-step train step and the eval forward.

    ``run(state, inputs, draws, grads)`` does the call's work and returns
    a tuple of tensors; ``draws`` holds one (StepRandom, noise seed) per
    step of the call (``slots`` of them; none for the forward), and
    ``grads`` is ``_mean_grads`` for a data-parallel train call
    (``all_reduce``), else None.  ``bind(state,
    inputs)`` lists the tensors the graph reads and writes in place
    (``_binding``): a graph is valid while they are the same tensors on
    the same storage, and a call that finds them replaced drops it.
    ``static``: the inputs are copied into buffers of the call's own
    before each replay (a step's batch, a forward's frame); otherwise the
    graph reads the caller's tensors (the pool, part of the binding).

    The graph's randomness is re-drawn at every replay: step j draws from
    the generators of slot j, registered with the graph and reseeded on
    the host from ``seeds[j]`` before the replay, and K1 reads its seed
    ``rank_noise_seed(seeds[j], *shard)`` from element j of a device buffer,
    filled by one copy from pinned memory per call (the plain noise
    instead draws from a registered generator seeded with it).  So step j
    of a replay draws exactly what the eager path draws for ``seeds[j]``.

    The first call for a binding runs eagerly on a side stream, a real
    call with its own seeds; the next captures (executing nothing) and
    replays, and every later call replays.  A replay runs no Python, so
    the call advances ``state.step`` by ``steps`` and each counted kernel
    entry point's ``.launches`` (``_build.counted``) by the launches the
    graph holds, ``launches``: what the capture counted over the call's
    Python, after which it restores the counts.  A call
    returns copies of the graph's outputs, which the next replay
    overwrites.  ``pool``: a memory pool shared with other graphs that
    replay one at a time on one stream (None: the graph's own).  A capture
    or replay that fails raises.  Each part of a call is a span of its own
    in a profiler's trace (``eld.graph.*``, ``utils/logging.py``).

    ``shard=(rank, world)`` and ``all_reduce``: a data-parallel train
    call.  Its noise seeds are the rank's, and each step averages the
    gradients over the ranks through ``_mean_grads``, one NCCL all-reduce
    that the graph holds.  The eager call makes the first collective (the
    communicator exists before any capture) and the flat buffer the
    graph binds.
    """

    def __init__(self, run, device: torch.device, bind, slots: int = 0, steps: int = 0,
                 static: bool = False, plain_noise: bool = False, pool=None,
                 shard: tuple = (0, 1), all_reduce: bool = False):
        self.run, self.device, self.bind = run, device, bind
        self.steps, self.static, self.pool = steps, static, pool
        self.shard, self.all_reduce = shard, all_reduce
        self.flat: Optional[torch.Tensor] = None  # the gradients, one f32 buffer (all_reduce)
        self.slots = [StepRandom(device) for _ in range(slots)]
        self.noise = [torch.Generator(device=device) for _ in range(slots)] if plain_noise else []
        card = device.type == "cuda"
        self.seeds_host = torch.empty(slots, dtype=torch.int64, pin_memory=card and slots > 0)
        self.seeds = torch.empty(slots, dtype=torch.int64, device=device)
        # recorded after each copy from the pinned buffer (None off the card,
        # where the copy is synchronous)
        self.copied = torch.cuda.Event() if card and slots else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.binding: Optional[List[torch.Tensor]] = None
        self.inputs: Dict[str, torch.Tensor] = {}  # the static input buffers
        self.out: Tuple[torch.Tensor, ...] = ()  # the graph's outputs
        self.launches: Dict = {}  # {counted entry point: its launches in the graph}
        self.replays = 0

    def reset(self):
        """Drop the graph (and its memory); the next call runs eagerly."""
        self.graph, self.binding, self.inputs, self.out = None, None, {}, ()
        self.flat = None

    def _draws(self):
        seeds = self.noise or [self.seeds[j:j + 1] for j in range(len(self.slots))]
        return list(zip(self.slots, seeds))

    def _run(self, state, inputs):
        return self.run(state, inputs, self._draws(), self._mean_grads if self.all_reduce else None)

    def _mean_grads(self, model: nn.Module):
        """Average ``model``'s gradients over the ranks in place, as XLA's
        psum does inside eld_tpu's mesh program: copy them into the call's
        flat f32 buffer, scale each rank's part by 1/world and sum the parts
        by one all-reduce, copy back.  DDP reduces the same gradients with
        the same operations: it multiplies its bucket by 1/world before
        its sum.  NCCL scales inside the collective (its average, a
        pre-multiplied sum, is one kernel even at world 1, where its plain
        sum is no device work); gloo has no average, so the buffer is
        scaled first."""
        grads = [p.grad for p in model.parameters()]
        if self.flat is None:
            self.flat = torch.empty(sum(g.numel() for g in grads), dtype=torch.float32,
                                    device=self.device)
        # views of the buffer with each (dense) gradient's own strides, the
        # channels-last ones included, so the copies batch into few kernels
        views, offset = [], 0
        for g in grads:
            views.append(self.flat.as_strided(g.shape, g.stride(), offset))
            offset += g.numel()
        torch._foreach_copy_(views, grads)
        if dist.get_backend() == "nccl":
            dist.all_reduce(self.flat, op=dist.ReduceOp.AVG)
        else:
            dist.all_reduce(self.flat.mul_(1.0 / self.shard[1]))
        torch._foreach_copy_(grads, views)

    def _load_seeds(self, seeds: Sequence[int]):
        """Reseed slot j from ``seeds[j]`` and copy the noise seeds
        ``rank_noise_seed(seeds[j], *shard)`` into the graph's seed buffer
        (or seed the plain noise's generators with them)."""
        with span("eld.graph.seeds"):
            noise_seeds = [rank_noise_seed(s, *self.shard) for s in seeds]
            for rng, seed in zip(self.slots, seeds):
                rng.reseed(seed)
            for gen, seed in zip(self.noise, noise_seeds):
                gen.manual_seed(seed)
            if self.copied is not None:
                self.copied.synchronize()  # the last call's copy has read the pinned buffer
            self.seeds_host.numpy()[:] = [seed_int64(s) for s in noise_seeds]
            self.seeds.copy_(self.seeds_host, non_blocking=True)
            if self.copied is not None:
                self.copied.record()

    def __call__(self, state: Optional[TrainState], inputs: Dict[str, torch.Tensor],
                 seeds: Sequence[int] = ()):
        with span("eld.graph.bind"):
            if self.binding is not None and not _same_binding(self.binding,
                                                              self.bind(state, inputs)):
                self.reset()
        if self.slots:
            self._load_seeds(seeds)
        if self.binding is None:
            return self._eager(state, inputs)
        if self.graph is None:
            self._capture(state, inputs)
        with span("eld.graph.replay"):
            for key, buf in self.inputs.items():
                buf.copy_(inputs[key])
            self.graph.replay()
        self.replays += 1
        if state is not None:
            state.step += self.steps
        for entry, n in self.launches.items():
            entry.launches += n
        with span("eld.graph.outputs"):
            return tuple(t.clone() for t in self.out)

    def _eager(self, state, inputs):
        main = torch.cuda.current_stream(self.device)
        with span("eld.graph.eager"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self._run(state, inputs)
            main.wait_stream(side)
            self.binding = self.bind(state, inputs)  # after the call: Adam's state exists
        with span("eld.graph.outputs"):
            for t in out:
                t.record_stream(main)  # read on the main stream after this call
        return out

    def _capture(self, state, inputs):
        with span("eld.graph.capture"):
            if self.static:
                # the graph's own input buffers, which each replay refills
                self.inputs = {key: v.clone() for key, v in inputs.items()}
                inputs = self.inputs
            graph = torch.cuda.CUDAGraph()
            for rng in self.slots:
                for gen in rng.generators():
                    graph.register_generator_state(gen)
            for gen in self.noise:
                graph.register_generator_state(gen)
            step = state.step if state is not None else 0
            before = _build.launch_counts()
            try:
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                    out = self._run(state, inputs)
                self.launches = {entry: entry.launches - n for entry, n in before.items()}
            finally:
                # the capture ran the call's Python, not its device work
                if state is not None:
                    state.step = step
                for entry, n in before.items():
                    entry.launches = n
            self.graph, self.out = graph, out


def _mean_and(losses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return losses.mean(), losses


def make_train_scan(
    model: nn.Module,
    loss: str = "l1",
    noise_model: Optional[str] = None,
    bank: Optional[CameraParamsBank] = None,
    k_mode: str = "overridden",
    batch: int = 16,
    steps_per_call: int = 10,
    augment: bool = True,
    autocast_dtype: Optional[torch.dtype] = None,
    forward: Optional[nn.Module] = None,
    shard: tuple = (0, 1),
    capture: bool = True,
):
    """K train steps per call over a device-resident patch pool.

    Returns ``fn(state, pool, seeds) -> metrics``: ``pool`` is
    {"clean": (P, H, W, C)} for synthetic training or {"input", "target"}
    of equal P for paired training, usually uint16 (``pool_to_device``);
    ``seeds`` holds one seed per step.  Step j picks and augments its batch
    with ``pick_batch(pool, batch, seeds[j], augment=augment)`` and then is
    exactly ``make_train_step``'s step on that batch with ``seeds[j]``.
    ``augment=False`` keeps the picked patches as they are (the synthetic
    demo's scan-vs-per-step A/B, whose per-step arm never augments).  Metrics
    are the mean and the last of the K losses, left on the device; the
    returned function's ``losses`` holds the last call's K losses.
    ``batch`` is the global batch; under ``shard=(rank, world)`` each step
    keeps the rank's rows of it, and the K losses are averaged over the
    ranks in one all-reduce per call.

    On a card, the K steps of a call are one CUDA graph (``_GraphCall``:
    the picks, augmentation, noise parameters, K1, the forward, backward
    and Adam of every step, replayed by one launch, the pool read in place
    and another pool dropping the graph): the first call runs eagerly, the
    second captures and replays, every later one replays, so a call costs
    the host one launch and its seeds, as eld_tpu's ``lax.scan`` does.
    The same seeds give the same picks, masks, parameters and noise as the
    eager loop.  Under data parallelism (a ``forward`` wrapper or
    ``shard[1] > 1``, i.e. ``--multihost``) over an NCCL group the graph
    holds each step's gradient all-reduce and the losses' mean over the
    ranks too, as eld_tpu's mesh ``jax.jit`` holds its psum.  The eager
    loop runs for CPU tensors and under data parallelism over a group
    that is not NCCL (gloo's collectives run on the host), which it says
    once.  ``capture=False`` runs the eager loop on a card too (the A/B
    against the graph).  A capture or replay that fails raises.
    """
    step = _make_local_step(loss, noise_model, bank, k_mode, "auto", autocast_dtype, forward,
                            shard)
    rows = rank_rows(*shard, batch) if shard[1] > 1 else None
    parallel = forward is not None or shard[1] > 1
    graphs: Dict[torch.device, _GraphCall] = {}

    def run(state: TrainState, pool, draws: Iterable[Tuple[StepRandom, object]], grads=None):
        """The K steps, each drawing from its (StepRandom, noise seed)."""
        losses = [step(state, pick_batch(pool, batch, None, rows, augment, rng=rng), rng,
                       noise_seed, grads)
                  for rng, noise_seed in draws]
        return global_mean(torch.stack(losses), shard[1])

    def multi(state: TrainState, pool: Dict[str, torch.Tensor], seeds: Sequence[int]):
        if len(seeds) != steps_per_call:
            raise ValueError(f"{len(seeds)} seeds for {steps_per_call} steps per call")
        dev = next(iter(pool.values())).device
        if _captures(dev, capture, _eager_reason(parallel, capture), "pooled trainer"):
            call = graphs.get(dev)
            if call is None:
                call = graphs[dev] = _GraphCall(
                    lambda st, pl, draws, grads: _mean_and(run(st, pl, draws, grads)), dev,
                    bind=_binding, slots=steps_per_call, steps=steps_per_call, shard=shard,
                    all_reduce=parallel)
            mean, losses = call(state, pool, seeds)
            return {"Pixel": mean, "PixelLast": losses[-1]}, losses
        # the process's StepRandom, reseeded from each step's seed just before its step
        losses = run(state, pool, ((step_random(dev, s), rank_noise_seed(s, *shard))
                                   for s in seeds))
        return {"Pixel": losses.mean(), "PixelLast": losses[-1]}, losses

    return _Trainer(multi, graphs)


class _Trainer:
    """``make_train_scan``'s function: ``graphs`` the card's graphs by
    device, ``losses`` the last call's K losses.  An object rather than a
    closure that names itself, so that nothing refers to a dropped trainer
    and its graphs and their memory go with its last reference."""

    def __init__(self, call, graphs: Dict[torch.device, "_GraphCall"]):
        self._call, self.graphs = call, graphs
        self.losses: Optional[torch.Tensor] = None

    def __call__(self, state: TrainState, pool: Dict[str, torch.Tensor],
                 seeds: Sequence[int]) -> Dict[str, torch.Tensor]:
        metrics, self.losses = self._call(state, pool, seeds)
        return metrics


def edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Replicate-pad the (H, W) dims of an NHWC batch up to (hp, wp), on
    the NCHW view."""
    h, w = x.shape[1], x.shape[2]
    if (hp, wp) == (h, w):
        return x
    padded = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="replicate")
    return padded.permute(0, 2, 3, 1)


def make_eval_forward(model: nn.Module, chop: bool = False,
                      autocast_dtype: Optional[torch.dtype] = None, capture: bool = True):
    """Inference ``fwd(x) -> pred`` on NHWC batches, without autograd.

    Without ``chop`` the frame is edge-padded on H and W up to the arch's
    alignment and the output cropped back, so full frames that are not a
    multiple of it (SID's 1424x2128 is 16- but not 32-aligned) run.  With
    ``chop`` the 4-tile forward runs, its tiles on the same alignment.
    ``autocast_dtype`` runs the model under autocast (``--bf16``).

    On a card the forward is one CUDA graph per input (shape, dtype)
    (``_GraphCall``), as eld_tpu's is one ``jax.jit`` program per shape:
    the first call of a shape runs eagerly (and sets up cuDNN's plans),
    the second captures and replays, every later one copies its input
    into the graph's buffer and replays.  The output is a copy, never the
    graph's own.  All graphs of one forward share one memory pool (they
    replay one at a time on one stream).  A graph is bound to the model's
    parameters and buffers: in-place updates (Adam's, a checkpoint load)
    keep it, replaced tensors drop it.  ``capture=False`` stays eager; the
    returned function's ``graphs`` holds the graphs by (shape, dtype)."""
    base = model.alignment()
    graphs: Dict[tuple, _GraphCall] = {}
    pool = []  # the forward's memory pool, made at its first graph

    def apply(t):
        with _autocast(t.device, autocast_dtype):
            return model(t)

    def forward(x: torch.Tensor) -> torch.Tensor:
        if chop:
            return forward_chop(apply, x, base=base)
        h, w = x.shape[1], x.shape[2]
        hp, wp = -(-h // base) * base, -(-w // base) * base
        if (hp, wp) == (h, w):
            return apply(x)
        return apply(edge_pad(x, hp, wp))[:, :h, :w]

    def run(state, inputs, draws, grads):
        return (forward(inputs["x"]),)

    def bind(state, inputs):
        return list(model.parameters()) + list(model.buffers())

    @torch.no_grad()
    def fwd(x: torch.Tensor) -> torch.Tensor:
        if not _captures(x.device, capture, None, "eval forward"):
            return forward(x)
        key = (tuple(x.shape), x.dtype)
        call = graphs.get(key)
        if call is None:
            if not pool:
                pool.append(torch.cuda.graph_pool_handle())
            call = graphs[key] = _GraphCall(run, x.device, bind=bind, static=True, pool=pool[0])
        return call(None, {"x": x})[0]

    fwd.graphs = graphs
    return fwd
