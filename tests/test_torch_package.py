"""The port's package: imports, exports, kernel sources and their build."""
import ast
import os

import pytest

import mlqem_tpu_torch
from mlqem_tpu_torch.utils import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mlqem_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mlqem_tpu"}


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"):
            yield "__import__"


def test_port_imports_no_jax():
    paths = list(_modules())
    assert len(paths) >= 15
    for path in paths:
        bad = set(_imported_roots(path)) & (FORBIDDEN | {"__import__"})
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_ast_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nfrom jax import numpy as jnp\n"
                 "import mlqem_tpu.ops\n")
    assert {"jax", "mlqem_tpu"} <= set(_imported_roots(str(p)))


def test_exports():
    for name in ("KickedIsingEngine", "configurable_device", "get_device",
                 "NoiseModel"):
        assert hasattr(mlqem_tpu_torch, name)


def test_kernel_source_and_build_flags():
    src = os.path.join(build.CSRC_DIR, "evolve.cu")
    assert os.path.isfile(src)
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int evolve_fused_launch' in text
    assert "sincosf(" in text and "__sinf" not in text
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
    path = build.library_path("evolve")
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")


def test_build_dir_is_ignored_and_sources_are_packaged():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert "mlqem_tpu_torch/_build/" in ignored
    with open(os.path.join(ROOT, "setup.py")) as f:
        assert '"mlqem_tpu_torch": ["csrc/*.cu"]' in f.read()


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
