"""primitives of mlqem_tpu_torch."""
