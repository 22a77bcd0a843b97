"""Build the port's CUDA sources into shared libraries at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into
``build/repro_torch/<name>-<hash>.so`` under the repository root, named by a
hash of the source and flags, so an unchanged source is compiled once per
checkout.  Nothing here runs at import time: the CPU tests import every
module on hosts that have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "source_path", "library_path", "compile_source",
           "load"]

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc (the CUDA compiler) was not found on PATH or "
                       f"under {cuda_home}/bin; the BBCSR kernels cannot be "
                       "built on this host")


def source_path(name: str) -> pathlib.Path:
    return _CSRC / f"{name}.cu"


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(source_path(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"{name}-{digest}.so"


def compile_source(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library path and nvcc's output (register and shared-memory use, from
    ``-Xptxas -v``; empty when the library was already built)."""
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                               str(source_path(name))],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source_path(name)}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = compile_source(name)
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
