"""Tutorial 06: Clifford scalability on the stabilizer tableau.

Runner of ``docs/tutorials/06_scalability.py``: circuits/s of composed
Clifford circuits from 5 to 400 qubits.
"""
from ..workflows.transfer import scalability_sweep
from . import run


def main(device="cuda", fast=False):
    widths = (5, 20, 50, 100) if fast else (5, 20, 50, 100, 200, 400)
    rows = scalability_sweep(qubit_counts=widths, depths=(1, 4, 7),
                             circuits_each=2 if fast else 8, device=device)
    print(f"{'n_qubits':>8} {'depth':>5} {'circuits/sec':>12}")
    for r in rows:
        print(f"{r['n_qubits']:>8} {r['depth']:>5} "
              f"{r['circuits_per_sec']:>12.1f}")
    widest = max(rows, key=lambda r: (r["n_qubits"], r["depth"]))
    print(f"widest config: {widest['n_qubits']}q depth {widest['depth']} "
          f"at {widest['circuits_per_sec']:.1f} circuits/sec")


if __name__ == "__main__":
    run(main)
