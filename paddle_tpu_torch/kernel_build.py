"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``paddle_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, loaded with :mod:`ctypes`.  Nothing is built when this module
is imported: a kernel is built at its first launch (or by
:func:`build_all`, which starts one ``nvcc`` per source at once), into
``build/kernels/`` at the root of the checkout.  The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, List, Optional

__all__ = ["CudaKernel", "KernelFunction", "build_all", "nvcc_path",
           "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "port's kernels")


class CudaKernel:
    """One ``csrc/<source>`` library and the C functions it exports.

    ``functions`` maps each exported name to its ctypes ``argtypes``
    (``c_void_p`` for every pointer and the stream); every function
    returns an ``int`` (the launch's ``cudaError_t``).  Wrappers launch
    through a :class:`KernelFunction` of the library, which counts."""

    def __init__(self, source: str, functions: Dict[str, List]):
        self.source = source
        self.functions = dict(functions)
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def lib_path(self) -> str:
        with open(self.source_path, "rb") as f:
            digest = hashlib.sha1(f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR,
                            f"lib{stem}-{digest.hexdigest()[:12]}.so")

    def _nvcc_cmd(self, out: str) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, self.source_path]

    def start_build(self) -> Optional[tuple]:
        """Start ``nvcc`` in the background unless the library exists;
        returns ``(process, tmp_path, final_path)`` or None."""
        final = self.lib_path()
        if os.path.exists(final):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(self._nvcc_cmd(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, final

    def finish_build(self, started: Optional[tuple]) -> None:
        if started is None:
            return
        proc, tmp, final = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):\n"
                f"{out}")
        os.replace(tmp, final)   # atomic: a reader never sees half a file

    def load(self):
        """Build (if needed) and load the library; returns the CDLL."""
        if self._lib is None:
            t0 = time.perf_counter()
            self.finish_build(self.start_build())
            self.build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(self.lib_path())
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


class KernelFunction:
    """One ``__global__`` kernel of a :class:`CudaKernel` library: its C
    entry point and its own launch count.  Calling it
    loads the library, runs the entry point, raises if the launch's
    ``cudaError_t`` is not 0, and only then adds one to ``launches``."""

    def __init__(self, library: CudaKernel, symbol: str, name: str):
        if symbol not in library.functions:
            raise ValueError(f"{library.source} exports no {symbol}")
        self.library = library
        self.symbol = symbol
        self.name = name
        self.launches = 0

    def __call__(self, *args) -> None:
        err = getattr(self.library.load(), self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with "
                               f"cudaError_t {err}")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Build every kernel's library in parallel (one ``nvcc`` each, all
    started together), then load them."""
    kernels = list(kernels)
    t0 = time.perf_counter()
    started = [k.start_build() if k._lib is None else None for k in kernels]
    errors = []
    for k, s in zip(kernels, started):
        try:   # wait for every nvcc, even after one failed
            k.finish_build(s)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    elapsed = time.perf_counter() - t0
    for k in kernels:
        if k._lib is None:
            k.load()
            k.build_seconds = elapsed
