"""parallel of mlqem_tpu_torch."""
