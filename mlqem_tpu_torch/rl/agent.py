"""Abstract RL agent (``blackwater/rl/agent.py`` parity)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class ActionResult:
    """Result of performing an action in an environment."""

    state: Any
    reward: float
    done: bool = False
    info: Optional[dict] = None


class Agent:
    """Abstract agent: subclass and implement the three hooks."""

    def select_action(self, state):
        raise NotImplementedError

    def optimize_model(self, *args, **kwargs):
        raise NotImplementedError

    def perform_action(self, action) -> ActionResult:
        raise NotImplementedError
