"""Build the port's CUDA sources into shared libraries at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into
``build/repro_torch/<name>-<hash>.so`` under the repository root, named by a
hash of the source and flags, so an unchanged source is compiled once per
checkout.  Nothing here runs at import time: the CPU tests import every
module on hosts that have no CUDA toolkit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "source_path", "library_path",
           "compile_source", "compile_all", "load", "on_cpu", "launch"]

# every CUDA source of the port, by name (csrc/<name>.cu)
SOURCES = ("bbcsr", "segment_sum", "segment_or", "embedding_bag",
           "flash_attention")

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
                       f"under {cuda_home}/bin; the port's kernels cannot be "
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


def compile_all(names=SOURCES) -> dict:
    """Compile the named sources at once, one nvcc process each, all
    started together.  Returns {name: (library path, nvcc output)}."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(compile_source, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = compile_source(name)
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def on_cpu(tensors, what: str) -> bool:
    """True when every tensor lies on the CPU (the caller then takes the
    plain version), False when all lie on one CUDA device; a mix, or
    another device, raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands span devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev.type == "cpu"


def launch(fn, device: torch.device, *args, what: str) -> None:
    """Call the C entry ``fn`` on ``device``'s current stream (passed last)
    and raise if it returns a CUDA error.  The stream comes from torch's raw
    accessor (the one its own generated kernels use): building a
    ``torch.cuda.Stream`` costs several microseconds a call, which a small
    batch's launch would pay on the host."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
