"""The plain reference of the benchmark's cells.

Plain NumPy and PyTorch, independent of the program: it imports nothing of
``mlqem_tpu_torch`` (nor ``jax`` or ``mlqem_tpu``), works the noise out
again from the calibration numbers (:mod:`.noise`) and simulates the
kicked-Ising Trotter circuits gate by gate with explicit Pauli errors
(:mod:`.sim`).
"""
