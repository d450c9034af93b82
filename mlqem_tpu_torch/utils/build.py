"""Build-on-first-use for the port's CUDA sources and host libraries.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``mlqem_tpu_torch/_build/`` and loaded with ``ctypes``; nothing includes
PyTorch's headers. The library's file name holds a hash of the source, the
headers of ``csrc/`` (``*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. ``nvcc`` is
found through ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``.
Host C++ sources (the JAX package's ``native/encoders.cpp``, read by path)
are built the same way with the host compiler (``c++`` or ``g++`` on
``PATH``) by :func:`build_host_library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

HOST_FLAGS = ("-O3", "-shared", "-fPIC")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built with it")


def source_paths(name: str) -> List[str]:
    """``csrc/<name>.cu`` and the headers it may include."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return [os.path.join(CSRC_DIR, f) for f in [f"{name}.cu", *headers]]


def _hashed_path(name: str, paths: List[str], flags) -> str:
    """``_build/lib<name>-<hash>.so``, the hash over the flags and the
    content of ``paths``."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build(out: str, cmd: List[str], timeout: int) -> ctypes.CDLL:
    """Run ``cmd -o <tmp>`` unless ``out`` exists, move the result to
    ``out`` and load it. The compiler's output is kept beside the library
    as ``<library>.log``; a compiler that fails raises."""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [*cmd, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        with open(f"{out}.log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed on "
                               f"{cmd[-3]} (rc {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to, for its current content."""
    return _hashed_path(name, source_paths(name), NVCC_FLAGS)


def build_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless already built, then load it
    (``-Xptxas -v`` puts registers, shared memory and spills in the
    library's ``.log``)."""
    return _build(library_path(name),
                  [find_nvcc(), *NVCC_FLAGS,
                   os.path.join(CSRC_DIR, f"{name}.cu")], timeout=600)


def find_host_compiler() -> Optional[str]:
    """The host C++ compiler on ``PATH``, or None."""
    for cc in ("c++", "g++"):
        path = shutil.which(cc)
        if path:
            return path
    return None


def build_host_library(src: str, name: str) -> Optional[ctypes.CDLL]:
    """Compile the host C++ source ``src`` into ``_build/lib<name>-<hash>
    .so`` unless already built, then load it; None where there is no host
    compiler. A compiler that fails raises."""
    out = _hashed_path(name, [src], HOST_FLAGS)
    if os.path.exists(out):
        return ctypes.CDLL(out)
    cc = find_host_compiler()
    if cc is None:
        return None
    return _build(out, [cc, *HOST_FLAGS, src], timeout=120)
