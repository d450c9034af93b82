"""Build-on-first-use for the port's CUDA sources.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``mlqem_tpu_torch/_build/`` and loaded with ``ctypes``; nothing includes
PyTorch's headers. The library's file name holds a hash of the source, the
headers of ``csrc/`` (``*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. ``nvcc`` is
found through ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

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


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to, for its current content."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_paths(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless already built, then load it.

    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<library>.log``.
    """
    out = library_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        with open(f"{out}.log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)
