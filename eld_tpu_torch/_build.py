"""Build the package's CUDA sources with nvcc at first use, load with ctypes,
and count the launches of the port's hand-written kernels.

A hand-written kernel is its ``csrc/*.cu`` source, with a plain C
interface, and a wrapper module that declares one ``Library``: its name,
its sources, the C signature of each entry point and the entry that names
a CUDA error.  The wrapper's entry point of the port is registered with
``counted``, so that a replayed CUDA graph adds the launches it holds
(``train/steps.py::_GraphCall``) without naming the kernel.

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
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

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


class Library:
    """One CUDA library of the port: ``name`` and ``sources`` (file names
    under csrc/) as ``build`` takes them, ``signatures`` the (restype,
    argtypes) of each C entry point, and ``error_entry`` the entry that
    turns a CUDA error code into its string (bound here as well)."""

    def __init__(self, name: str, sources: Sequence[str],
                 signatures: Mapping[str, Tuple[Optional[type], Sequence[type]]],
                 error_entry: str):
        self.name, self.sources = name, tuple(sources)
        self.signatures = {**signatures, error_entry: (ctypes.c_char_p, [ctypes.c_int])}
        self.error_entry = error_entry
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def source_paths(self) -> Tuple[str, ...]:
        """The sources' paths from the repository's root."""
        return tuple(f"eld_tpu_torch/csrc/{src}" for src in self.sources)

    def start(self) -> None:
        """Begin building the library on a thread of its own (``start``)."""
        start(self.name, self.sources)

    def load(self) -> ctypes.CDLL:
        """Build (first use, after a started build) and bind the library,
        once per process."""
        if self._lib is None:
            self._lib = self.bind(load(self.name, self.sources))
        return self._lib

    def bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """Set the entry points' C signatures on ``lib``, a loaded build of
        these sources or of another with the same C interface."""
        for entry, (restype, argtypes) in self.signatures.items():
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = restype, list(argtypes)
        return lib

    def check(self, lib: ctypes.CDLL, rc: int, what: str) -> None:
        """Raise a ``RuntimeError`` naming the CUDA error ``rc`` that an
        entry point of ``lib``, a bound build, returned for ``what``;
        nothing for 0."""
        if rc != 0:
            error = getattr(lib, self.error_entry)(rc).decode()
            raise RuntimeError(f"{self.name} {what} launch failed: {error} ({rc})")


# the kernel entry points of the port whose launches are counted
COUNTED: List[Callable] = []


def counted(entry: Callable) -> Callable:
    """Register ``entry``, a kernel's entry point of the port: it counts the
    launches it makes on a card in ``entry.launches``, from 0, and a replayed
    CUDA graph adds the launches it holds."""
    entry.launches = 0
    COUNTED.append(entry)
    return entry


def launch_counts() -> Dict[Callable, int]:
    """Each registered entry point's launches so far."""
    return {entry: entry.launches for entry in COUNTED}
