"""Action selection, port of ``refil_tpu/components/action_selectors.py``
(``epsilon_greedy``; ``multinomial`` waits for the pi_logits configs)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def epsilon_greedy(agent_qs: torch.Tensor, avail_actions: torch.Tensor,
                   epsilon: Union[float, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   pick_random: Optional[torch.Tensor] = None,
                   random_actions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-agent ε-greedy over available actions: Bernoulli(ε) per agent
    chooses a uniform draw over the available actions, else the argmax of the
    availability-masked Q-values.

    agent_qs, avail_actions (B, Na, A); ``epsilon`` a float or a 0-d tensor
    on the Q-values' device. ``pick_random`` (B, Na) bool and
    ``random_actions`` (B, Na) int are explicit draws; missing ones come from
    ``generator``. Returns (B, Na) int64 actions. Nothing here waits for the
    device, so a CUDA graph can capture it.
    """
    B, Na, A = agent_qs.shape
    greedy = agent_qs.masked_fill(~avail_actions, float("-inf")).argmax(dim=-1)
    if random_actions is None:
        # argmax of avail / Exp(1): the draw torch.multinomial makes for one
        # sample (same numbers from the same generator state), without its
        # host-side checks of the probabilities, which wait for the device
        probs = avail_actions.float()
        noise = torch.empty_like(probs).exponential_(generator=generator)
        random_actions = (probs / noise).argmax(dim=-1)
    if pick_random is None:
        pick_random = torch.rand((B, Na), generator=generator,
                                 device=agent_qs.device) < epsilon
    return torch.where(pick_random, random_actions.to(greedy.dtype), greedy)
