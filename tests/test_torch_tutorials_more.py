"""The port's runners of the JAX package's tutorials 05-07, a1 and a2 (``docs/tutorials/``) at ``fast=True`` on
the CPU: each runs end to end and prints its script's headline line.
"""
import importlib

import pytest

RUNNERS = {
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
