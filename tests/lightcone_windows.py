"""The bond lists of real light-cone windows, shared by the frame-pass
tests on the CPU (``test_torch_kicked_ising.py``) and on the card
(``test_torch_cuda.py``). It imports only the port."""
from mlqem_tpu_torch import LightconeIsing, configurable_device


def window_bonds(steps, q, chain=100):
    """(w, bonds) of qubit q's light-cone window on a chain of ``chain``
    qubits, as the engine makes it: the local bonds in the chain's
    application order, which start at bond (1, 2) where the window starts
    at an odd qubit."""
    lc = LightconeIsing(configurable_device(chain, seed=0), nq=chain,
                        steps=steps, device="cpu", noise=False)
    tw = lc.window_tables(q)
    return tw["w"], tw["bonds"]
