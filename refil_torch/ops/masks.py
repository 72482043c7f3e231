"""Mask algebra for entity-set attention and REFIL's imagined factorization.

Port of ``refil_tpu/ops/masks.py``. Masks are *blocking* masks: ``True``
means blocked / inactive / cannot-see. All ops are boolean.

Randomness: ``build_imagine_masks`` takes the random bipartition either as
explicit draws (``group_probs`` (B,1,1) float, ``groupA`` (B,1,Ne) bool, so a
test can feed it the JAX package's draws) or draws it from a
``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def entitymask2attnmask(entity_mask: torch.Tensor) -> torch.Tensor:
    """(..., Ne) inactive-mask -> (..., Ne, Ne) attention block-mask: pair
    (i, j) is unblocked iff both i and j are active."""
    active = ~entity_mask
    return ~(active[..., :, None] & active[..., None, :])


def agentmask2attnmask(entity_mask: torch.Tensor, n_agents: int) -> torch.Tensor:
    """(..., Ne) inactive-mask -> (..., Na, Ne) agent-rows attention block-mask."""
    active = ~entity_mask
    agent_active = active[..., :n_agents]
    return ~(agent_active[..., :, None] & active[..., None, :])


class ImagineMasks(NamedTuple):
    """``within``/``interact`` include the obs_mask (agent ×3 pass);
    ``w_noobs``/``i_noobs`` exclude it but include entity activity (mixer)."""

    within: torch.Tensor
    interact: torch.Tensor
    w_noobs: torch.Tensor
    i_noobs: torch.Tensor


def draw_imagine_groups(batch_size: int, n_entities: int, generator: torch.Generator,
                        device) -> tuple:
    """The random bipartition of ``build_imagine_masks``: p ~ U(0,1) per batch
    element, then groupA ~ Bernoulli(p) per entity."""
    group_probs = torch.rand((batch_size, 1, 1), generator=generator, device=device)
    u = torch.rand((batch_size, 1, n_entities), generator=generator, device=device)
    return group_probs, u < group_probs


def build_imagine_masks(
    obs_mask: torch.Tensor,
    entity_mask: torch.Tensor,
    n_agents: int,
    agent_rows: bool = False,
    gt_mask: Optional[torch.Tensor] = None,
    use_gt_factors: bool = False,
    use_rand_gt_factors: bool = False,
    generator: Optional[torch.Generator] = None,
    group_probs: Optional[torch.Tensor] = None,
    groupA: Optional[torch.Tensor] = None,
) -> ImagineMasks:
    """Random entity bipartition -> within/interaction attention masks
    (``refil_tpu/ops/masks.py:62-146``).

    One partition per episode, evaluated on t=0 activity only. ``within`` =
    pairs in the same group, ``interact`` = pairs across groups.
    ``use_gt_factors`` replaces the partition with ``gt_mask``;
    ``use_rand_gt_factors`` ORs the random within-mask with ``gt_mask``.

    Args:
      obs_mask: (B, T, Ne, Ne) bool. entity_mask: (B, T, Ne) bool.
      gt_mask: (B, T, Na, Ne) bool, required for the gt paths.
      agent_rows: (B, T, Na, Ne) masks if True, else square (B, T, Ne, Ne).
      group_probs, groupA: explicit draws; else drawn from ``generator``.
    """
    B, T, Ne = entity_mask.shape
    if agent_rows:
        to_attn = lambda em: agentmask2attnmask(em, n_agents)  # noqa: E731
    else:
        to_attn = entitymask2attnmask

    em0 = entity_mask[:, 0:1]  # (B, 1, Ne)
    active0 = to_attn(em0)

    if use_gt_factors:
        if gt_mask is None:
            raise ValueError("use_gt_factors requires gt_mask")
        within = gt_mask.bool()
        interact = ~within
    else:
        if groupA is None:
            if generator is None:
                raise ValueError("build_imagine_masks needs a generator or explicit draws")
            group_probs, groupA = draw_imagine_groups(B, Ne, generator, entity_mask.device)
        groupA = groupA.bool()
        groupA_m = groupA | em0
        groupB_m = (~groupA) | em0
        maskA = to_attn(groupA_m)
        maskB = to_attn(groupB_m)
        interact = (~maskA) | (~maskB)
        within = ~interact
        if use_rand_gt_factors:
            if gt_mask is None:
                raise ValueError("use_rand_gt_factors requires gt_mask")
            within = within | gt_mask.bool()
            interact = ~within

    w_noobs = within | active0
    i_noobs = interact | active0
    obs_rows = obs_mask[:, :, :n_agents, :] if agent_rows else obs_mask
    within_obs = within | obs_rows
    interact_obs = interact | obs_rows

    tgt_rows = n_agents if agent_rows else Ne
    if use_gt_factors or use_rand_gt_factors:
        w_noobs = w_noobs.expand(B, max(T, w_noobs.shape[1]), tgt_rows, Ne)
        i_noobs = i_noobs.expand(B, max(T, i_noobs.shape[1]), tgt_rows, Ne)
    else:
        w_noobs = w_noobs.expand(B, T, tgt_rows, Ne)
        i_noobs = i_noobs.expand(B, T, tgt_rows, Ne)
    return ImagineMasks(within=within_obs, interact=interact_obs, w_noobs=w_noobs,
                        i_noobs=i_noobs)


def hypernet_attn_mask(entity_mask: torch.Tensor, n_agents: int) -> torch.Tensor:
    """Default hypernet attention mask: agent rows x entity cols, pair
    unblocked iff both active."""
    return agentmask2attnmask(entity_mask, n_agents)
