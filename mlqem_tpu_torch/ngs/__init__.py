"""NGS scaffolding (``blackwater/library/ngs`` parity).

Counterpart of ``mlqem_tpu/ngs/``, with the same surface.

The reference's NGS module is an unimplemented skeleton
(``library/ngs/ngs.py:12-38``, ``library/ngs/model.py:5-10``); the same
surface ships here so downstream experiments have a stable import path.
"""
from ..rl.agent import ActionResult, Agent
from ..rl.env import Environment


class NGSEnvironment(Environment):
    """NGS environment over (circuit, noise-model) states."""

    def __init__(self, circuit=None, noise_model=None):
        self.circuit = circuit
        self.noise_model = noise_model

    def get_state(self):
        return (self.circuit, self.noise_model)


class NGSAgent(Agent):
    """NGS agent skeleton."""

    def __init__(self, environment: NGSEnvironment, model=None):
        self.environment = environment
        self.model = model

    def select_action(self, state):
        raise NotImplementedError

    def optimize_model(self, *args, **kwargs):
        raise NotImplementedError

    def perform_action(self, action) -> ActionResult:
        raise NotImplementedError


class NGSModel:
    """Model skeleton for NGS (``library/ngs/model.py`` parity)."""
