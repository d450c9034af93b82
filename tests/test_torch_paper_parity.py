"""Port vs JAX package: the paper-parity study
(``workflows/paper_parity.py``) at the JAX package's smoke sizes.

The study's noisy labels are shot-sampled, so the port is handed JAX's
labels (its exact ideal labels are first held to JAX's within 1e-5); the
forest and OLS arms of ``single_ising_parity`` are then held within 1e-5,
and each package reads the part files the other wrote.
"""
import json
import os

import numpy as np
import pytest

from mlqem_tpu.circuits.circuit import Circuit as JCircuit
from mlqem_tpu.device.registry import get_device as j_get_device
from mlqem_tpu.workflows import datasets as jd
from mlqem_tpu.workflows import paper_parity as jpar

from mlqem_tpu_torch.workflows import datasets as td
from mlqem_tpu_torch.workflows import paper_parity as tpar

from port_fixtures import one_torch_thread  # noqa: F401

LABEL_TOL = 1e-5
JDEV = j_get_device("fake_lima")


PARITY = dict(settings=("incoherent",), seeds=(0,), protocol="v2",
              num_train=40, max_steps=10, num_test_steps=10, run_zne=False,
              arms=("random_forest", "ols"))


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """JAX's and the port's paper_parity_study at the JAX package's smoke
    sizes, each writing its part files; the port takes JAX's labels."""
    tmp = tmp_path_factory.mktemp("parity")
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    want = jpar.paper_parity_study(parts_dir=jdir, **PARITY)
    real = td._zq_labels
    checked = []

    def jax_labels(circuits, device_model, nm, shots, seed, ideal=True,
                   ideal_shots=None, device="cuda"):
        jcircs = [JCircuit.from_dict(c.to_dict()) for c in circuits]
        jnm = jpar._experiment_noise("incoherent", JDEV, None,
                                     protocol="v2")[0]
        want = jd._zq_labels(jcircs, JDEV, jnm, shots, seed, ideal=ideal,
                             ideal_shots=ideal_shots)
        # the v2 protocol's ideal labels are exact on both sides
        assert ideal_shots is None
        np.testing.assert_allclose(
            real(circuits, device_model, nm, shots, seed, device=device)[0],
            want[0], atol=LABEL_TOL, rtol=0)
        checked.append(len(circuits))
        return want

    mp = pytest.MonkeyPatch()
    mp.setattr(td, "_zq_labels", jax_labels)
    try:
        got = tpar.paper_parity_study(parts_dir=tdir, device="cpu", **PARITY)
    finally:
        mp.undo()
    assert checked == [40, 11]                   # train set, test sweep
    return {"want": want, "got": got, "jdir": jdir, "tdir": tdir}


def _same_study(got, want, tol):
    assert got.keys() == want.keys()
    for k in ("schema", "protocol", "seeds"):
        assert got[k] == want[k], k
    g, w = got["settings"]["incoherent"], want["settings"]["incoherent"]
    assert g.keys() == w.keys()
    for k in ("noise_scale", "num_twirls", "num_train", "published",
              "improvement_published"):
        assert g[k] == w[k], k
    for k in ("ours_mean", "ours_std", "improvement_ours"):
        assert g[k].keys() == w[k].keys()
        for m in w[k]:
            assert g[k][m] == pytest.approx(w[k][m], abs=tol), (k, m)


def test_single_ising_parity_matches_jax(parity_runs):
    """The (setting, seed) result single_ising_parity returns, as each
    package wrote it to its part file: forest and OLS within 1e-5."""
    name = "v2_incoherent_s0.json"
    with open(os.path.join(parity_runs["tdir"], name)) as f:
        got = json.load(f)
    with open(os.path.join(parity_runs["jdir"], name)) as f:
        want = json.load(f)
    assert got.keys() == want.keys()
    assert set(got["ours"]) == {"noisy", "random_forest", "ols"}
    for k in ("setting", "protocol", "arms_version", "num_train",
              "noise_scale", "num_twirls", "seed", "published"):
        assert got[k] == want[k], k
    for m, v in want["ours"].items():
        assert got["ours"][m] == pytest.approx(v, abs=LABEL_TOL), m
    assert got["ours"]["random_forest"] < got["ours"]["noisy"]
    _same_study(parity_runs["got"], parity_runs["want"], LABEL_TOL)


def test_each_package_reads_the_others_parts(parity_runs):
    """The part files share names and schema: each package's study reads
    the other's parts instead of recomputing them."""
    from_j = tpar.paper_parity_study(parts_dir=parity_runs["jdir"],
                                     device="cpu", **PARITY)
    _same_study(from_j, parity_runs["want"], 0.0)
    from_t = jpar.paper_parity_study(parts_dir=parity_runs["tdir"], **PARITY)
    _same_study(from_t, parity_runs["got"], 0.0)
