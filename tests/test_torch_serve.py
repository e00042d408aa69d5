"""The port's serving path against eld_tpu's: export artifacts
(``eld_tpu_torch.export``), ``export_model``, ``denoise`` and the
``prefetched_map`` it decodes through.

Float32 on the CPU, U-Net base width 8.  Tolerances: an artifact against
the eager forward 1e-5 (the same graph, traced); int8 values equal to
JAX's ``quantize_params`` except at most 1e-4 of entries, which may differ
by one (a weight within an ulp of a rounding boundary), scales rtol 1e-6;
the int8 artifact's denoised PSNR within 0.05 dB of the f32 artifact's
(eld_tpu's bar, tests/test_export.py); denoise against eld_tpu's on one
``.pt``: the packed output within 1e-4 (18 f32 conv layers in another
summation order) and the PNG codes equal except at most 0.1%, which may
differ by one (see test_torch_isp.py).
"""

import copy
import json
import os
import threading
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from eld_tpu.export import quantize_params as jax_quantize_params
from eld_tpu.export import save_denoiser as jax_save_denoiser
from eld_tpu.models import build_arch as jax_build_arch
from eld_tpu.models.unet import UNetSeeInDark as JaxUNet
from eld_tpu.tools import denoise as jax_denoise
from eld_tpu_torch import export
from eld_tpu_torch.compat.jax_params import UNET_MAP, state_dict_to_flax
from eld_tpu_torch.data.loader import prefetched_map
from eld_tpu_torch.models import build_arch
from eld_tpu_torch.noise.model import synthesize
from eld_tpu_torch.noise.params import NoiseParams, load_camera_params
from eld_tpu_torch.ops.chop import forward_chop
from eld_tpu_torch.ops.metrics import psnr
from eld_tpu_torch.tools import denoise, export_model
from eld_tpu_torch.train.state import create_train_state
from eld_tpu_torch.train.steps import make_eval_forward, make_train_step
from eld_tpu_torch.utils.images import load_png
from tests.tiff_fixture import make_dng


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch beside XLA's CPU thread pool (see
    test_torch_noise.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch="unet", seed=0):
    torch.manual_seed(seed)
    return build_arch(arch, 4, 4, base_width=8, skip_mode="split").eval()


def _pt(tmp_path, model, name="model_latest.pt"):
    path = str(tmp_path / name)
    torch.save({"netG": model.state_dict(), "epoch": 3, "iterations": 30}, path)
    return path


# ---- artifacts ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_artifact_round_trip_and_symbolic_batch(tmp_path, arch):
    """The artifact equals the eager forward for batches of 1 and 3 (one
    export, symbolic batch), on any device it is loaded on."""
    model = _model(arch)
    path = str(tmp_path / "a.eldx")
    meta = export.save_denoiser(path, model, 64, 96, extra_meta={"arch": arch})
    assert meta["param_count"] == sum(p.numel() for p in model.parameters())
    fn, meta2 = export.load_denoiser(path, "cpu")
    assert meta2 == meta == export.read_meta(path) and meta["arch"] == arch
    for n in (1, 3):
        x = torch.from_numpy(onp.random.default_rng(n).random((n, 64, 96, 4), dtype=onp.float32))
        with torch.no_grad():
            want = model(x)
        got = fn(x)
        assert got.shape == (n, 64, 96, 4) and got.dtype == torch.float32
        onp.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) == {"meta.json", "model.pt2"}


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_bf16_artifact_matches_the_autocast_eval_forward(tmp_path, quantize):
    """--bf16 through explicit casts computes what the Engine's bf16
    eval forward (autocast over f32 parameters) computes: the casts round
    each operand as autocast does (equal on the CPU); within 4e-3, two
    bf16 ulps of these outputs (|y| < 0.5)."""
    model = _model()
    path = str(tmp_path / "bf16.eldx")
    export.save_denoiser(path, model, 32, 48, bf16=True, quantize=quantize)
    fn, meta = export.load_denoiser(path, "cpu")
    assert meta["bf16"] is True
    x = torch.from_numpy(onp.random.default_rng(5).random((2, 32, 48, 4), dtype=onp.float32))
    net = export.serving_module(model, quantize=quantize).net if quantize else model
    want = make_eval_forward(net, autocast_dtype=torch.bfloat16)(x)
    got = fn(x)
    assert got.dtype == torch.float32
    assert float(want.abs().max()) < 0.5
    onp.testing.assert_allclose(got.numpy(), want.float().numpy(), rtol=0, atol=4e-3)


def test_chop_artifact_equals_forward_chop(tmp_path):
    model = _model()
    path = str(tmp_path / "chop.eldx")
    export.save_denoiser(path, model, 96, 64, chop=True, symbolic_batch=False)
    fn, meta = export.load_denoiser(path, "cpu")
    assert meta["chop"] is True and meta["symbolic_batch"] is False
    x = torch.from_numpy(onp.random.default_rng(2).random((1, 96, 64, 4), dtype=onp.float32))
    with torch.no_grad():
        want = forward_chop(model, x, base=16)
    onp.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["unet", "unet_s2d"])
def test_int8_weights_equal_jax_quantize_params(arch):
    """Per-output-channel int8 on the weights carried to Flax: the values
    and scales of eld_tpu's quantize_params, out-channel axis 0 for the
    convs and 1 for the transposed convs (upv*); conv10_1 (Flax's top-level
    Conv_0) and every bias stay f32."""
    model = _model(arch, seed=3)
    jq = jax_quantize_params(jax.tree_util.tree_map(jnp.asarray,
                                                    state_dict_to_flax(model.state_dict())))
    net = export.quantize_model(copy.deepcopy(model))
    carried = {}
    for tname in UNET_MAP:
        mod = getattr(net, tname)
        assert mod.bias.dtype == torch.float32 and isinstance(mod.bias, torch.nn.Parameter)
        if tname in export.KEEP_F32:
            assert isinstance(mod.weight, torch.nn.Parameter)
            assert mod.weight.dtype == torch.float32
            carried[f"{tname}.weight"] = mod.weight
        else:
            q = mod.parametrizations.weight.original0
            assert q.dtype == torch.int8 and "weight" not in mod._parameters
            carried[f"{tname}.weight"] = q.float()
        carried[f"{tname}.bias"] = mod.bias
    ours = state_dict_to_flax(carried)
    for tname, (fpath, _) in UNET_MAP.items():
        ref, got = jq, ours
        for part in fpath.split("/"):
            ref, got = ref[part], got[part]
        assert not isinstance(ref["bias"], tuple)
        if tname in export.KEEP_F32:
            assert not isinstance(ref["kernel"], tuple)
            onp.testing.assert_array_equal(got["kernel"], onp.asarray(ref["kernel"]))
            continue
        q_ref, s_ref = (onp.asarray(a) for a in ref["kernel"])
        diff = onp.abs(got["kernel"] - q_ref.astype(onp.float32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, tname
        scale = getattr(net, tname).parametrizations.weight.original1.numpy()
        onp.testing.assert_allclose(scale.ravel(), s_ref.ravel(), rtol=1e-6)


def _trained(steps=200):
    """A width-8 U-Net trained briefly on blocky scenes under 'g' noise, so
    its PSNR is a denoising number (eld_tpu's int8 gate does the same)."""
    rng = onp.random.default_rng(0)
    clean = torch.from_numpy(onp.stack([
        onp.kron(rng.random((4, 4, 4)).astype(onp.float32), onp.ones((8, 8, 1), onp.float32))
        * 0.6 + 0.2 for _ in range(16)]))
    model = _model(seed=1).train()
    state = create_train_state(model, lr=2e-3)
    step = make_train_step(model, noise_model="g", bank=load_camera_params(include=4))
    for i in range(steps):
        sel = torch.from_numpy(onp.random.default_rng(1000 + i).integers(0, 16, 8))
        step(state, {"clean": clean[sel]}, i)
    return model.eval()


def test_int8_artifact_psnr_gate(tmp_path):
    """The int8 artifact is smaller, and its denoised PSNR is within
    0.05 dB of the f32 artifact's on held-out noisy scenes."""
    model = _trained()
    paths = {q: str(tmp_path / f"{q}.eldx") for q in ("f32", "int8")}
    for q, path in paths.items():
        export.save_denoiser(path, model, 32, 32, quantize=None if q == "f32" else q)
    assert os.path.getsize(paths["int8"]) < 0.45 * os.path.getsize(paths["f32"])
    fns = {q: export.load_denoiser(path, "cpu")[0] for q, path in paths.items()}
    one = torch.ones(1)
    p = NoiseParams(K=one * 2.0, g_scale=one * 25.0, G_scale=one, G_shape=one * 0.1,
                    R_scale=one, color_bias=torch.zeros(1, 4),
                    saturation_level=one * 15583.0, ratio=one * 200.0)
    hold = onp.random.default_rng(99)
    deltas = []
    for i in range(4):
        ref = torch.from_numpy(onp.kron(hold.random((4, 4, 4)).astype(onp.float32),
                                        onp.ones((8, 8, 1), onp.float32)) * 0.6 + 0.2)[None]
        noisy = synthesize(torch.Generator().manual_seed(50 + i), ref, p, "g")
        out = {q: fn(noisy).clamp(0, 1) for q, fn in fns.items()}
        deltas.append(abs(float(psnr(out["f32"], ref, 1.0)) - float(psnr(out["int8"], ref, 1.0))))
    assert max(deltas) <= 0.05, deltas


def test_version_guard_and_jax_artifacts_refused(tmp_path):
    model = _model()
    path = str(tmp_path / "a.eldx")
    export.save_denoiser(path, model, 32, 32)

    def rewrite(patch, name):
        with zipfile.ZipFile(path) as z:
            blob, meta = z.read("model.pt2"), json.loads(z.read("meta.json"))
        meta.update(patch)
        out = str(tmp_path / name)
        with zipfile.ZipFile(out, "w") as z:
            z.writestr("meta.json", json.dumps(meta))
            z.writestr("model.pt2", blob)
        return out

    future = rewrite({"version": 99}, "future.eldx")
    for fn in (export.read_meta, lambda p: export.load_denoiser(p, "cpu")):
        with pytest.raises(ValueError, match="version 99"):
            fn(future)
    with pytest.raises(ValueError, match="not an eldx"):
        export.load_denoiser(rewrite({"format": "other"}, "alien.eldx"), "cpu")

    jax_path = str(tmp_path / "jax.eldx")
    jm = jax_build_arch("unet", 4, 4, base_width=8, skip_mode="split")
    jax_save_denoiser(jax_path, jm, jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax(model.state_dict())), 32, 32, platforms=("cpu",))
    for fn in (export.read_meta, lambda p: export.load_denoiser(p, "cpu")):
        with pytest.raises(ValueError, match="export_model"):
            fn(jax_path)
    assert export.load_denoiser(path, "cpu")[1]["version"] == export.ARTIFACT_VERSION


def test_serving_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """export_model, denoise and load_denoiser run on --device cuda unless
    asked for the CPU; without a card they raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt = _pt(tmp_path, _model())
    raw = _dng(tmp_path / "a.dng")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--model_path", pt, "--base_width", "8", "--out",
                           str(tmp_path / "a.eldx")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise.main(["--input", raw, "--ratio", "100", "--model_path", pt,
                      "--base_width", "8", "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_denoiser("unused.eldx")


# ---- export_model -----------------------------------------------------------

def test_export_model_cli_from_pt(tmp_path):
    """From the port's .pt (the Engine's layout) to an artifact equal to the
    eager forward; an orbax .ckpt is refused."""
    model = _model()
    pt = _pt(tmp_path, model)
    out = str(tmp_path / "m.eldx")
    meta = export_model.main(["--model_path", pt, "--base_width", "8", "--height", "32",
                              "--width", "48", "--device", "cpu", "--out", out])
    assert (meta["epoch"], meta["iterations"], meta["arch"]) == (3, 30, "unet")
    fn, _ = export.load_denoiser(out, "cpu")
    x = torch.from_numpy(onp.random.default_rng(4).random((2, 32, 48, 4), dtype=onp.float32))
    with torch.no_grad():
        onp.testing.assert_allclose(fn(x).numpy(), model(x).numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="orbax"):
        export_model.main(["--model_path", str(tmp_path / "model_latest.ckpt"),
                           "--device", "cpu", "--out", out])


# ---- denoise ----------------------------------------------------------------

def _dng(path, h=72, w=80, seed=0):
    """A dark frame: packed values ~[0, 0.0025], unsaturated at x100-x300."""
    mosaic = (512 + onp.random.default_rng(seed).random((h, w)) * 40).astype(onp.uint16)
    path.write_bytes(make_dng(mosaic, iso=1600, exposure=0.04))
    return str(path)


def _raw_dir(tmp_path):
    d = tmp_path / "raws"
    d.mkdir()
    for i in range(3):
        _dng(d / f"a{i}.dng", 64, 64, seed=10 + i)
    _dng(d / "b0.dng", 72, 80, seed=20)
    return str(d)


def assert_png_codes_close(a, b):
    codes = load_png(a).astype(onp.int16) - load_png(b).astype(onp.int16)
    assert onp.abs(codes).max() <= 1 and (codes != 0).mean() <= 1e-3


def test_denoise_equals_eld_tpu_on_one_pt(tmp_path, monkeypatch):
    """Both CLIs on one .pt over DNG fixtures of two geometries (packed
    32x32, and 36x40, which pads to 48x48), --batch 2, --crf off and on:
    the same records, the packed output within 1e-4, the PNGs within one
    code.  eld_tpu's Flax template init (~25 s eager) is skipped:
    its .pt importer needs no template."""
    monkeypatch.setattr(JaxUNet, "init",
                        lambda self, *a, **k: {"params": None})
    pt = _pt(tmp_path, _model(seed=5))
    raws = _raw_dir(tmp_path)
    for crf in ([], ["--crf"]):
        argv = ["--input", raws, "--ratio", "200", "--model_path", pt, "--base_width", "8",
                "--batch", "2", "--save_raw"] + crf
        ref = jax_denoise.main(argv + ["--out", str(tmp_path / f"jax{len(crf)}")])
        got = denoise.main(argv + ["--out", str(tmp_path / f"ours{len(crf)}"),
                                   "--device", "cpu"])
        assert [r["input"] for r in got] == [r["input"] for r in ref] and len(got) == 4
        for a, b in zip(got, ref):
            assert os.path.basename(a["output"]) == os.path.basename(b["output"])
            assert a["ratio"] == b["ratio"] == 200.0
            za, zb = onp.load(a["raw_output"]), onp.load(b["raw_output"])
            onp.testing.assert_allclose(za["packed"], zb["packed"], rtol=0, atol=1e-4)
            for k in ("wb", "ccm"):
                onp.testing.assert_array_equal(za[k], zb[k])
            assert_png_codes_close(a["output"], b["output"])


def test_denoise_pipelined_equals_synchronous(tmp_path):
    """--io_threads 2 (decode-ahead, background writes) gives exactly the
    outputs of --io_threads 0, in the same order; names are collision-safe
    (IMG.dng beside IMG.npz)."""
    pt = _pt(tmp_path, _model())
    raws = _raw_dir(tmp_path)
    onp.savez(os.path.join(raws, "a0.npz"),
              mosaic=(512 + onp.random.default_rng(7).random((64, 64)) * 40).astype(onp.uint16),
              black_level=onp.float32(512), iso=1600.0, exposure=0.04)
    runs = {}
    for threads in ("0", "2"):
        runs[threads] = denoise.main(["--input", raws, "--ratio", "100", "--model_path", pt,
                                      "--base_width", "8", "--batch", "2", "--io_threads",
                                      threads, "--device", "cpu", "--save_raw",
                                      "--out", str(tmp_path / f"o{threads}")])
    names = [os.path.basename(r["output"]) for r in runs["0"]]
    assert "a0_denoised.png" in names and "a0_denoised_2.png" in names and len(names) == 5
    for a, b in zip(runs["0"], runs["2"]):
        assert a["input"] == b["input"]
        onp.testing.assert_array_equal(load_png(a["output"]), load_png(b["output"]))
        za, zb = onp.load(a["raw_output"]), onp.load(b["raw_output"])
        for k in ("packed", "wb", "ccm"):
            onp.testing.assert_array_equal(za[k], zb[k])


def test_denoise_from_artifact_geometry_and_saturation(tmp_path, capsys):
    """Through an artifact: a smaller frame is edge-padded to its static
    geometry and cropped back, a larger one exits naming the re-export,
    baked flags are refused, and a fully saturated input serves finite
    pixels."""
    model = _model()
    art = str(tmp_path / "a.eldx")
    export.save_denoiser(art, model, 48, 48)
    small = _dng(tmp_path / "small.dng", 48, 64)  # packed 24x32
    res = denoise.main(["--input", small, "--ratio", "100", "--artifact", art,
                        "--device", "cpu", "--out", str(tmp_path / "o"), "--save_raw"])
    assert load_png(res[0]["output"]).shape == (24, 32, 3)
    assert onp.load(res[0]["raw_output"])["packed"].shape == (24, 32, 4)
    with pytest.raises(SystemExit, match="re-export"):
        denoise.main(["--input", _dng(tmp_path / "big.dng", 128, 160), "--ratio", "100",
                      "--artifact", art, "--device", "cpu", "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit):
        denoise.main(["--input", small, "--ratio", "100", "--artifact", art, "--chop",
                      "--device", "cpu", "--out", str(tmp_path / "o")])
    bright = tmp_path / "bright.dng"
    bright.write_bytes(make_dng((onp.random.default_rng(9).random((64, 64)) * 4000 + 8000)
                                .astype(onp.uint16)))
    res = denoise.main(["--input", str(bright), "--ratio", "300", "--artifact", art,
                        "--device", "cpu", "--out", str(tmp_path / "o")])
    assert onp.isfinite(load_png(res[0]["output"])).all()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["count"] == 1


@pytest.mark.parametrize("threads", ["0", "2"])
def test_a_failed_write_fails_the_run(tmp_path, monkeypatch, capsys, threads):
    """A write that raises fails denoise before its summary line, on the
    synchronous and on the pipelined path, also when it is the run's last
    write (one frame: only the final wait can see it)."""
    def broken(path, img):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(denoise, "save_png", broken)
    pt = _pt(tmp_path, _model())
    with pytest.raises(OSError, match="disk full"):
        denoise.main(["--input", _dng(tmp_path / "one.dng"), "--ratio", "100", "--model_path", pt,
                      "--base_width", "8", "--io_threads", threads, "--device", "cpu",
                      "--out", str(tmp_path / "o")])
    assert '"count"' not in capsys.readouterr().out


def test_writes_in_flight_are_bounded():
    """With the limit reached, submit waits until a write finishes."""
    writes = denoise.Writes(threads=1, limit=2)
    gate, done = threading.Event(), []

    def job(i):
        gate.wait(10)
        done.append(i)

    submitter = threading.Thread(target=lambda: [writes.submit(job, i) for i in range(4)])
    submitter.start()
    time.sleep(0.3)
    assert submitter.is_alive() and done == []  # the third submit waits
    gate.set()
    submitter.join(10)
    assert not submitter.is_alive()
    writes.close()
    assert sorted(done) == [0, 1, 2, 3]


def test_prefetched_map_runs_nothing_past_a_failure():
    """A failing call is raised at its position, and no call starts on an
    item past it beyond the one already running (one worker: the item right
    after the failing one may have started)."""
    started, release = [], threading.Event()

    def fn(i):
        started.append(i)
        if i == 1:
            raise KeyError("item 1")
        if i == 2:
            release.wait(10)
        return i

    it = prefetched_map(fn, range(10), workers=1, window=10)
    with pytest.raises(KeyError):
        list(it)
    release.set()
    time.sleep(0.3)
    assert started in ([0, 1], [0, 1, 2])
    assert list(prefetched_map(lambda i: i * i, range(5), workers=2, window=2)) == \
        [0, 1, 4, 9, 16]
    assert list(prefetched_map(lambda i: i + 1, range(3), workers=0, window=2)) == [1, 2, 3]
