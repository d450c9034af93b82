"""Reads the program's own spans (``mlqem_tpu_torch.utils.profiling.
span_totals()``: count, host and device seconds by path), which the
program records while the traced run's profiler runs. A program that
records no such spans gives None."""
from __future__ import annotations

from typing import Optional


def per_span_ms(field: str, path: str, per: str) -> Optional[float]:
    """The summed ``field`` ("host_s" or "device_s") of the spans whose
    path ends in ``path``, in ms, ÷ the count of the spans whose path ends
    in ``per``; None where either is missing or a device time was not
    recorded."""
    from mlqem_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    spans = totals()

    def ends(p, suffix):
        return p == suffix or p.endswith("/" + suffix)

    n = sum(t["count"] for p, t in spans.items() if ends(p, per))
    vals = [t[field] for p, t in spans.items() if ends(p, path)]
    if not n or not vals or any(v is None for v in vals):
        return None
    return sum(vals) / n * 1e3
