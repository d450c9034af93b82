"""RL scaffolding (reference ``blackwater/rl`` parity — abstract interfaces).

Counterpart of ``mlqem_tpu/rl/``, with the same surface.

The reference ships these as unimplemented stubs (``rl/agent.py:18-35``,
``rl/env.py:9-14``); the same abstract surface is provided here for
forward-compatibility of NGS experiments.
"""
from .agent import ActionResult, Agent
from .env import Environment

__all__ = ["ActionResult", "Agent", "Environment"]
