"""Categorical draws over a small support, from a ``torch.Generator``."""
from __future__ import annotations

from typing import Sequence

import torch


def sample_small_categorical(probs: torch.Tensor, shape: Sequence[int],
                             generator: torch.Generator) -> torch.Tensor:
    """int32 draws of ``shape`` from ``probs[..., K]``, K small.

    One uniform per draw and K-1 fused comparisons against the CDF
    (index = #{cdf_k < u}), so nothing of size ``shape × K`` is built.
    ``probs.shape[:-1]`` must broadcast against ``shape`` from the right.
    The draws come from ``generator`` on its own device.
    """
    p = probs.to(dtype=torch.float32)
    cdf = torch.cumsum(p, dim=-1)
    cdf = cdf / cdf[..., -1:]
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    idx = torch.zeros(tuple(shape), dtype=torch.int32, device=u.device)
    for k in range(p.shape[-1] - 1):
        idx += u > cdf[..., k]
    return idx
