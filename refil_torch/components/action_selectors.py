"""Action selection, port of ``refil_tpu/components/action_selectors.py``
(``epsilon_greedy``; ``multinomial`` waits for the pi_logits configs)."""
from __future__ import annotations

from typing import Optional

import torch


def epsilon_greedy(agent_qs: torch.Tensor, avail_actions: torch.Tensor, epsilon: float,
                   generator: Optional[torch.Generator] = None,
                   pick_random: Optional[torch.Tensor] = None,
                   random_actions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-agent ε-greedy over available actions: Bernoulli(ε) per agent
    chooses a uniform draw over the available actions, else the argmax of the
    availability-masked Q-values.

    agent_qs, avail_actions (B, Na, A). ``pick_random`` (B, Na) bool and
    ``random_actions`` (B, Na) int are explicit draws; missing ones come from
    ``generator``. Returns (B, Na) int64 actions.
    """
    B, Na, A = agent_qs.shape
    greedy = agent_qs.masked_fill(~avail_actions, float("-inf")).argmax(dim=-1)
    if random_actions is None:
        random_actions = torch.multinomial(avail_actions.reshape(B * Na, A).float(), 1,
                                           generator=generator).reshape(B, Na)
    if pick_random is None:
        pick_random = torch.rand((B, Na), generator=generator,
                                 device=agent_qs.device) < epsilon
    return torch.where(pick_random, random_actions.to(greedy.dtype), greedy)

