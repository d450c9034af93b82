"""The port's runners of the JAX package's tutorials a3 and z01 and the two demos
(``docs/tutorials/``, ``docs/demos/``) at ``fast=True`` on
the CPU: each runs end to end and prints its script's headline line.

a3 spawns 4 gloo ranks.
"""
import importlib

import pytest

RUNNERS = {
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
