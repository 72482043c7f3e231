"""Action selection, port of ``refil_tpu/components/action_selectors.py``:
``epsilon_greedy`` over Q-values and ``multinomial`` over policy
probabilities.

``shard`` (a ``parallel.mesh.MeshContext``): the Q-values are this rank's
rows of a global batch ``shard.n_data`` times larger, and every draw is made
at the global shape and cut to those rows, so the ranks together draw what
one process selecting for the whole batch draws."""
from __future__ import annotations

from typing import Optional, Union

import torch


def _rows(x: torch.Tensor, shard) -> torch.Tensor:
    """A draw made at the global batch shape, cut to this rank's rows."""
    return x if shard is None else shard.shard(x)


def epsilon_greedy(agent_qs: torch.Tensor, avail_actions: torch.Tensor,
                   epsilon: Union[float, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   pick_random: Optional[torch.Tensor] = None,
                   random_actions: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
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
    Bd = B if shard is None else B * shard.n_data
    greedy = agent_qs.masked_fill(~avail_actions, float("-inf")).argmax(dim=-1)
    if random_actions is None:
        # argmax of avail / Exp(1): the draw torch.multinomial makes for one
        # sample (same numbers from the same generator state), without its
        # host-side checks of the probabilities, which wait for the device
        probs = avail_actions.float()
        noise = torch.empty((Bd, Na, A), device=probs.device).exponential_(generator=generator)
        random_actions = (probs / _rows(noise, shard)).argmax(dim=-1)
    if pick_random is None:
        pick_random = _rows(torch.rand((Bd, Na), generator=generator,
                                       device=agent_qs.device), shard) < epsilon
    return torch.where(pick_random, random_actions.to(greedy.dtype), greedy)


def multinomial(agent_probs: torch.Tensor, avail_actions: torch.Tensor,
                test_greedy: bool = True, test_mode: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
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
        B, Na, A = masked.shape
        Bd = B if shard is None else B * shard.n_data
        noise = torch.empty((Bd, Na, A), device=masked.device).exponential_(generator=generator)
        gumbel = -torch.log(_rows(noise, shard))
    return (torch.log(masked.clamp(min=1e-20)) + gumbel).argmax(dim=-1)


SELECTOR_REGISTRY = {"epsilon_greedy": epsilon_greedy, "multinomial": multinomial}
