"""device of mlqem_tpu_torch."""
