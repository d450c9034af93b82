"""kernels of mlqem_tpu_torch."""
