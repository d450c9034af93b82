"""utils of mlqem_tpu_torch."""
