"""mlqem_tpu_torch — the kicked-Ising label generator in PyTorch and CUDA.

A port of the JAX package ``mlqem_tpu`` to PyTorch, with the fused
evolution as a hand-written CUDA kernel for Hopper (``csrc/evolve.cu``).
It mirrors the JAX package's module paths and imports neither JAX nor
``mlqem_tpu``.

Quick start::

    from mlqem_tpu_torch import KickedIsingEngine, configurable_device

    eng = KickedIsingEngine(configurable_device(10, seed=0), nq=10,
                            steps=4, device="cuda")
    ideal, noisy = eng.generate(J_values, seed=0)   # numpy [B, 10] each
"""

from .device.model import DeviceModel
from .device.noise import NoiseModel
from .device.registry import configurable_device, get_device
from .ops.kicked_ising import KickedIsingEngine

__all__ = ["DeviceModel", "KickedIsingEngine", "NoiseModel",
           "configurable_device", "get_device"]
