"""The port's runners of the JAX package's tutorials 01-04 (``docs/tutorials/``) at ``fast=True`` on
the CPU: each runs end to end and prints its script's headline line.

The other runners: ``tests/test_torch_tutorials_more.py`` and
``tests/test_torch_demo_runners.py``.
"""
import importlib

import pytest

RUNNERS = {
    "t01_ngem": ("01_ngem.py",
                 "ngem ensemble RMSE: noisy"),
    "t02_data_generation": ("02_data_generation.py",
                            "ising[device]: rmse(noisy, ideal) = "),
    "t03_experiments_on_lima_backend": ("03_experiments_on_lima_backend.py",
                                        "mimic vs zne rmse:"),
    "t04_ngem_vqe": ("04_ngem_vqe.py",
                     "error: noisy "),
}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_prints_its_headline(runner, capsys, tmp_path):
    script, headline = RUNNERS[runner]
    main = importlib.import_module(
        f"mlqem_tpu_torch.tutorials.{runner}").main
    kwargs = {"out_dir": str(tmp_path)} if runner == "z01_mlp_debug" else {}
    main(device="cpu", fast=True, **kwargs)
    out = capsys.readouterr().out
    assert headline in out, (script, out)
