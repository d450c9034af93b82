"""Abstract RL environment (``blackwater/rl/env.py`` parity)."""
from __future__ import annotations


class Environment:
    """Abstract environment."""

    def get_state(self):
        raise NotImplementedError
