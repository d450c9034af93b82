"""apps of mlqem_tpu_torch: the H2 problem set and VQE."""
