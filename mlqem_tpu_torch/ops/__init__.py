"""ops of mlqem_tpu_torch."""
