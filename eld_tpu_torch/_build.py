"""Build the package's CUDA sources with nvcc at first use, load with ctypes.

Each library is compiled from ``csrc/`` into ``build/eld_tpu_torch/`` at the
repository root, under a name that carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
The sources have a plain C interface and include no PyTorch headers, so
a build takes seconds.  ``start`` runs
one on a thread of its own, so that nvcc works while the caller sets up,
and ``load`` waits for it.  There is no fallback: a missing nvcc, a
failed build or a failed load raises, at ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

from eld_tpu_torch._paths import BUILD_DIR, CSRC_DIR

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_STARTED: Dict[str, threading.Thread] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels of eld_tpu_torch need the CUDA toolkit to build")
    return nvcc


def library_path(name: str, sources: Sequence[str]) -> str:
    """Where the library built from ``sources`` lives (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, sources: Sequence[str]) -> str:
    """Compile ``sources`` (file names under csrc/) into a shared library
    unless an up-to-date one exists; returns its path."""
    out = library_path(name, sources)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def start(name: str, sources: Sequence[str]) -> None:
    """Begin ``build`` on a thread of its own, once per process.  A failed
    build is left for ``load``, which builds again and raises."""
    if name in _LOADED or name in _STARTED:
        return

    def run():
        try:
            build(name, sources)
        except Exception:  # noqa: BLE001 - load() builds again and raises
            pass

    thread = _STARTED[name] = threading.Thread(target=run, name=f"build {name}")
    thread.start()


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build if needed (after a started build) and load the library once
    per process."""
    lib = _LOADED.get(name)
    if lib is None:
        thread = _STARTED.get(name)
        if thread is not None:
            thread.join()
        lib = _LOADED[name] = ctypes.CDLL(build(name, sources))
    return lib
