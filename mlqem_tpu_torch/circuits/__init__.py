"""circuits of mlqem_tpu_torch."""
