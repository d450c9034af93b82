"""transpile of mlqem_tpu_torch."""
