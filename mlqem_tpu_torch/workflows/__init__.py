"""workflows of mlqem_tpu_torch."""
