"""mitigation of mlqem_tpu_torch."""
