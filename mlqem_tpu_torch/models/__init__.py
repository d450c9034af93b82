"""models of mlqem_tpu_torch."""
