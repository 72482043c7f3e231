"""Action selection, port of ``refil_tpu/components/action_selectors.py``:
``epsilon_greedy`` over Q-values and ``multinomial`` over policy
probabilities."""
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


def multinomial(agent_probs: torch.Tensor, avail_actions: torch.Tensor,
                test_greedy: bool = True, test_mode: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A sample from the availability-masked probabilities (B, Na, A); in
    test mode with ``test_greedy``, their argmax. The sample is the argmax
    of log(max(p, 1e-20)) plus Gumbel noise, as ``jax.random.categorical``
    draws it; ``gumbel`` (B, Na, A) is that noise given explicitly, else
    -log(Exp(1)) from ``generator``. Returns (B, Na) int64 actions; nothing
    here waits for the device."""
    masked = agent_probs.masked_fill(~avail_actions, 0.0)
    if test_mode and test_greedy:
        return masked.argmax(dim=-1)
    if gumbel is None:
        noise = torch.empty_like(masked, dtype=torch.float32).exponential_(generator=generator)
        gumbel = -torch.log(noise)
    return (torch.log(masked.clamp(min=1e-20)) + gumbel).argmax(dim=-1)


SELECTOR_REGISTRY = {"epsilon_greedy": epsilon_greedy, "multinomial": multinomial}
