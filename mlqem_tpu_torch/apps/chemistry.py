"""H2 dissociation problem set.

Counterpart of ``mlqem_tpu/apps/chemistry.py``. The reference's H2 VQE
sweeps (``docs/tutorials/vqe_rf_h2.py:226-246``) read 5-term qubit
Hamiltonians per bond length from ``h2-hamiltonian-qubit-params.txt``; the
JAX package ships the same data as a fixture, which this module reads by
path. Terms, in order: II, XX, IZ (Z on qubit 0), ZZ, ZI (Z on qubit 1).
"""
from __future__ import annotations

import os
from typing import List, Tuple

from ..circuits.observables import PauliSum

_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "mlqem_tpu", "apps", "fixtures",
    "h2_hamiltonian_qubit_params.txt")


def load_h2_problems(path: str = _FIXTURE
                     ) -> List[Tuple[float, float, PauliSum]]:
    """[(bond_length_angstrom, fci_energy, hamiltonian)] per bond length."""
    with open(path) as f:
        entries = f.read().split("\n\n")
    out = []
    for entry in entries:
        if not entry.strip():
            continue
        lines = entry.strip().split("\n")
        length = float(lines[0].split(" ")[0])
        fci = float(lines[1].split(" ")[-1])
        c_ii, c_xx, c_z0, c_zz, c_z1 = (float(x.strip().split(" ")[0])
                                        for x in lines[2:7])
        ham = PauliSum([("II", c_ii), ("XX", c_xx), ("IZ", c_z0),
                        ("ZZ", c_zz), ("ZI", c_z1)])
        out.append((length, fci, ham))
    return out
