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


def _device_defaults(path):
    """(function, default) of every ``device`` argument with a constant
    default in a module."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args.args + node.args.kwonlyargs
        defaults = ([None] * (len(node.args.args) - len(node.args.defaults))
                    + node.args.defaults + node.args.kw_defaults)
        for arg, default in zip(args, defaults):
            if arg.arg == "device" and isinstance(default, ast.Constant):
                yield node.name, default.value
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and getattr(
                node.target, "id", None) == "device" and isinstance(
                node.value, ast.Constant):
            yield "dataclass field", node.value.value


def test_entry_points_default_to_the_card():
    """No entry point of the port falls back to the CPU: every ``device``
    argument with a default defaults to "cuda"."""
    found = {}
    for path in _modules():
        for fn, default in _device_defaults(path):
            found[(os.path.relpath(path, ROOT), fn)] = default
    assert len(found) >= 40
    bad = {k: v for k, v in found.items() if v != "cuda"}
    assert not bad, bad
    for fn in ("__init__", "scalability_sweep", "single_ising_parity",
               "run_tableau", "truncation_convergence", "vqe_dataset",
               "train_vqe_processor", "vqe_mitigation_study",
               "h2_dissociation_curve", "entry", "make_mesh",
               "sharded_statevector_fn", "dryrun_multichip",
               "mesh_label_runs", "sharded_sv_runs", "write_demo1",
               "write_demo2", "write_paper_parity"):
        assert fn in {f for _, f in found}


def test_exports():
    for name in ("KickedIsingEngine", "configurable_device", "get_device",
                 "NoiseModel", "Circuit", "IsingLabelPipeline",
                 "make_ising_template", "LightconeIsing",
                 "BaseEstimator", "IdealEstimator", "NoisyEstimator",
                 "TrajectoryEstimator", "CountsBackend", "Job",
                 "EstimatorResult", "LinearExtrapolator",
                 "PolynomialExtrapolator", "RichardsonExtrapolator",
                 "ZNEEstimator", "ZNEStrategy", "zne", "twirl_circuit",
                 "sample_twirled_circuits", "stack_circuits", "tensorize",
                 "PauliSum", "ExpValueEntry", "generate_exp_val_dataset",
                 "ExpValDataset", "MLQEMException", "RandomForestRegressor",
                 "LinearRegression", "MLP1", "MLP2", "MLP3",
                 "ExpValCircuitGraphModel", "ExpValCircuitGraphModel2",
                 "ExpValCircuitGraphModel3", "ExpValCircuitGraphModel4",
                 "NgemEnsembleModel", "train_model", "train_gnn",
                 "train_mlp", "predict", "learning", "ngem",
                 "ModelProcessor", "TorchModelProcessor", "ZNEProcessor",
                 "EmptyProcessor", "GNNProcessor", "train_gnn_mitigation",
                 "tomography_sweep", "improvement_factor", "rmse",
                 "PauliPropagatorIsing", "StabilizerState",
                 "batch_expectations", "truncation_convergence", "finetune",
                 "calibration_drift", "scalability_sweep",
                 "single_ising_parity", "paper_parity_study", "VQE",
                 "VQEResult", "exact_minimum_eigenvalue", "spsa_minimize",
                 "load_h2_problems", "vqe_dataset", "train_vqe_processor",
                 "vqe_mitigation_study", "h2_dissociation_curve",
                 "PUBLISHED_H2", "make_mesh", "pad_to_multiple", "spawn",
                 "sharded_statevector_fn", "sharded_z_expectations",
                 "dryrun_multichip", "check_demo1", "check_demo2",
                 "check_paper_parity"):
        assert hasattr(mlqem_tpu_torch, name)
    assert set(mlqem_tpu_torch.__all__) <= set(dir(mlqem_tpu_torch))
    # the state carriers from the JAX package
    from mlqem_tpu_torch import convert
    for name in ("device_from_jax_dict", "engine_tables_from_numpy",
                 "circuit_tensor_from_numpy", "template_from_numpy",
                 "pipeline_tables_from_numpy", "noise_table_from_numpy",
                 "density_from_numpy", "state_dict_from_flax",
                 "forest_from_jax", "linear_from_jax"):
        assert callable(getattr(convert, name))


def _check_kernel_source(name, entry, trig=True):
    src = os.path.join(build.CSRC_DIR, f"{name}.cu")
    assert os.path.isfile(src)
    with open(src) as f:
        text = f.read()
    assert f'extern "C" int {entry}' in text
    assert text.startswith("// ") and "Replaces mlqem_tpu/ops/pallas/" in text
    # the device code may sit in headers of csrc/ that the source includes
    for header in build.source_paths(name)[1:]:
        if f'#include "{os.path.basename(header)}"' in text:
            with open(header) as f:
                text += f.read()
    assert ("sincosf(" in text) == trig
    for fast in ("__sinf", "__cosf", "__sincosf", "__expf", "use_fast_math"):
        assert fast not in text
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
    path = build.library_path(name)
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")


def test_kernel_source_and_build_flags():
    _check_kernel_source("evolve", "evolve_fused_launch")


def test_frame_kernel_source_and_build_flags():
    _check_kernel_source("frame_evolve", "evolve_frame_marginals_launch")


def test_step_and_wht_kernel_sources_and_build_flags():
    _check_kernel_source("fused_step", "fused_trotter_step_launch")
    _check_kernel_source("wht", "wht_planes_launch", trig=False)


def test_wide_step_kernel_source_and_build_flags():
    _check_kernel_source("fused_step_wide", "fused_trotter_step_wide_launch")
    _check_kernel_source("fused_step_wide", "step_masks_launch")


def test_build_dir_is_ignored_and_sources_are_packaged():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert "mlqem_tpu_torch/_build/" in ignored
    with open(os.path.join(ROOT, "setup.py")) as f:
        assert ('"mlqem_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]'
                in f.read())


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
