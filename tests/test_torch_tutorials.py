"""The port's runners of the JAX package's tutorials and demos
(``docs/tutorials/``, ``docs/demos/``) at ``fast=True`` on the CPU: each
runs end to end and prints its script's headline line.

a3 spawns 4 gloo ranks.
"""
import importlib

import pytest

from port_fixtures import bounded_rank_wait, one_torch_thread  # noqa: F401

RUNNERS = {
    "t01_ngem": ("01_ngem.py",
                 "ngem ensemble RMSE: noisy"),
    "t02_data_generation": ("02_data_generation.py",
                            "ising[device]: rmse(noisy, ideal) = "),
    "t03_experiments_on_lima_backend": ("03_experiments_on_lima_backend.py",
                                        "mimic vs zne rmse:"),
    "t04_ngem_vqe": ("04_ngem_vqe.py",
                     "error: noisy "),
    "t05_stability_over_time": ("05_stability_over_time.py",
                                "drifted device (t=100): zero-shot rmse"),
    "t06_scalability": ("06_scalability.py",
                        "widest config: "),
    "t07_generalization": ("07_generalization.py",
                           "generalization gap (extrap - interp):"),
    "a1_simulation_engines": ("a1_simulation_engines.py",
                              "100q stabilizer <Z_0>:"),
    "a2_scale_100q": ("a2_scale_100q.py",
                      "demo1 (lightcone): rmse noisy"),
    "a3_multichip_sharding": ("a3_multichip_sharding.py",
                              "sharded <Z_q>:"),
    "z01_mlp_debug": ("z01_mlp_debug.py",
                      "test RMSE: noisy"),
    "demo1_rf_mimic_zne_100q": ("demo1_rf_mimic_zne_100q.py",
                                "RMSE mimic : "),
    "demo2_ising_4q": ("demo2_ising_4q.py",
                       "RMSE mitigated : "),
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
