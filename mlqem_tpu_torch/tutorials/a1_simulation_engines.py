"""Tutorial a1: the simulation engines.

Runner of ``docs/tutorials/a1_simulation_engines.py``: the exact
statevector, the density matrix under a real calibration, the TFIM
Trotter family, and 100-qubit Clifford circuits on the stabilizer
tableau.
"""
from ..circuits.circuit import Circuit
from ..circuits.families import (IsingModel, IsingOptions,
                                 generate_composed_clifford)
from ..circuits.observables import PauliSum, single_z
from ..device.registry import get_device
from ..ops.stabilizer import StabilizerState
from ..primitives.estimator import IdealEstimator, NoisyEstimator
from . import run


def main(device="cuda", fast=False):
    bell = Circuit(2).h(0).cx(0, 1)
    ideal = IdealEstimator(device=device)
    print("Bell <ZZ>:", ideal.run(bell, PauliSum("ZZ")).result().values[0])
    # density matrix under a real calibration noise model
    dev = get_device("fake_lima")   # real ibmq_lima calibration snapshot
    noisy = NoisyEstimator(dev, shots=10000, device=device)
    print("noisy Bell <ZZ>:",
          noisy.run(bell, PauliSum("ZZ")).result().values[0])
    # the TFIM Trotter family (the paper's workhorse)
    qc = IsingModel.make_circs_sweep(IsingOptions.config_4q_paper(), 3, "Z",
                                     measure=False)
    for q in range(4):
        i = ideal.run(qc, single_z(q, 4)).result().values[0]
        n = noisy.run(qc, single_z(q, 4)).result().values[0]
        print(f"  q{q}: ideal {i:+.4f}  noisy {n:+.4f}")
    # 100-qubit Clifford circuits on the stabilizer tableau
    big = generate_composed_clifford(20, 5, 4, seed=1)   # 100 qubits
    st = StabilizerState.from_circuit(big, device=device)
    print("100q stabilizer <Z_0>:", st.expectation(single_z(0, 100)))


if __name__ == "__main__":
    run(main)
