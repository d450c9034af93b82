"""data of mlqem_tpu_torch."""
