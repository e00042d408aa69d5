"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Each check runs in a fresh
process, and module names are compared by their whole top-level name
(``eld_tpu_torch`` is the port and allowed; ``eld_tpu`` is not)."""

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _top_level_after(code: str) -> set:
    script = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_named_file_load_no_jax():
    loaded = _top_level_after(
        "import runpy; runpy.run_path('benchmark/run.py', run_name='not_main')\n"
        "from eldbench import calibrate, cell, compare, manifest, ranks, reference, scenes, "
        "stats, trace, yardstick\n"
        "m = manifest.load()\n"
        "[manifest.cell(w['name']) for w in m['workloads']]\n"
        "[manifest.reader(x['name']) for x in m['per_layer']]\n"
        "[cell.arch(manifest.cell(w['name'])) for w in m['workloads']]\n"
        "from eld_tpu_torch.tools import train_syn\n"
        "from eld_tpu_torch.train import engine\n"
        "from eld_tpu_torch.parallel import launch, multihost\n"
        "from eld_tpu_torch import config")
    assert "eld_tpu_torch" in loaded and "eldbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "eld_tpu"}, loaded & {"jax", "eld_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        "from eldbench import reference, compare, scenes, yardstick, manifest\n"
        "import os\n"
        "[manifest.arch(f[:-3]) for f in os.listdir(os.path.join(manifest.HERE, 'archs')) "
        "if f.endswith('.py')]")
    assert not loaded & {"eld_tpu_torch", "eld_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compares_whole_names():
    loaded = _top_level_after(
        "import types; sys.modules['eld_tpu_torch_x'] = types.ModuleType('x')\n"
        "sys.modules['jaxtyping'] = types.ModuleType('y')\n"
        "from eldbench import cell\n"
        "assert cell.forbidden_modules() == [], cell.forbidden_modules()\n"
        "sys.modules['eld_tpu.noise'] = types.ModuleType('z')\n"
        "assert cell.forbidden_modules() == ['eld_tpu'], cell.forbidden_modules()")
    assert "eldbench" in loaded
