"""The port's demo1 and demo2 artifact writers at ``--fast`` on the CPU,
held to the structure and sanity checks of their gates (``full=False``);
the full gate refuses a ``--fast`` demo1 artifact. demo1 runs at the
smallest size its ``full=False`` gate takes: one Trotter step and one
error realization on each arm."""
import json

import pytest

from mlqem_tpu_torch.workflows.artifacts import main as write_artifact
from mlqem_tpu_torch.workflows.schemas import check_demo1, check_demo2

from port_fixtures import one_torch_thread  # noqa: F401

WRITERS = {
    "demo1": (check_demo1, "demo1_100q_simulated.json",
              ("demo1_100q_simulated_per_step.png",
               "demo1_100q_simulated_per_step_vs_ideal.png"),
              ["--steps", "1", "--twirls", "1", "--twirls-amp", "1"]),
    "demo2": (check_demo2, "demo2_4q_simulated.json", (), []),
}


@pytest.mark.parametrize("name", list(WRITERS))
def test_fast_writer_passes_its_gate(name, tmp_path):
    check, json_name, pngs, size = WRITERS[name]
    out = write_artifact([name, "--fast", "--device", "cpu", "--out",
                          str(tmp_path)] + size)
    with open(tmp_path / json_name) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(out))
    check(written, full=False)
    for png in pngs:
        assert (tmp_path / png).stat().st_size > 0
    if name == "demo1":
        assert written["protocol"]["fast"] is True
        with pytest.raises(ValueError, match="protocol.fast"):
            check(written, full=True)
    else:
        assert len(written["runs"]) == 1
