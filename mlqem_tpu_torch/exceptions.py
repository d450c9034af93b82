"""Framework exception (``blackwater/exception.py`` parity)."""


class MLQEMException(Exception):
    """Base exception of the mlqem_tpu_torch framework."""
