"""Batched Group Matching environment in torch, port of
``refil_tpu/envs/group_matching.py``.

N agents on a ring of ``n_states`` cells, actions {left, stay, right}, each
replaced by a random action with probability ``rand_trans``; a hidden random
partition into ``n_groups``; reward -0.1 per step + 2.5·Δ(groups piled on one
cell); solved when every group is piled up.

Kept exactly as the reference has them:
  * agents are shuffled and sliced by unsorted random partition points, so
    groups can be empty and can overlap: membership is an (N, G) bool matrix;
  * empty groups count as matched;
  * ``gt_mask`` uses each agent's first containing group;
  * the time-limit flag is set whether or not the episode also solved.

``transition`` is a pure function of explicit draws (``rand_u`` uniforms,
``rand_a`` replacement actions); ``reset``/``step`` take those draws
explicitly or draw them from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .base import register_env, warn_unused_env_args


class GroupMatchingState(NamedTuple):
    locs: torch.Tensor  # (B, N) int64 cell of each agent
    member: torch.Tensor  # (B, N, G) bool group membership
    prev_matches: torch.Tensor  # (B,) int64 number of piled groups
    t: torch.Tensor  # (B,) int64 episode step


@register_env("group_matching")
class GroupMatching:
    def __init__(self, entity_scheme: bool = True, n_agents: int = 4, n_states: int = 10,
                 n_groups: int = 2, rand_trans: float = 0.1, episode_limit: int = 50,
                 fixed_scen: bool = False, device="cpu", **unused):
        if not entity_scheme:
            raise ValueError("GroupMatching only supports the entity scheme")
        warn_unused_env_args("GroupMatching", unused, accepted=("seed",))
        self.n_agents = n_agents
        self.n_states = n_states
        self.n_groups = n_groups
        self.rand_trans = rand_trans
        self.episode_limit = episode_limit
        self.fixed_scen = fixed_scen
        self.n_actions = 3  # left, stay, right
        self.device = torch.device(device)

    def env_info(self) -> Dict:
        return {
            "entity_shape": self.n_states + self.n_groups + self.n_agents,
            "n_actions": self.n_actions,
            "n_agents": self.n_agents,
            "n_entities": self.n_agents,
            "gt_mask_avail": True,
            "episode_limit": self.episode_limit,
        }

    @staticmethod
    def membership_from_partitions(perm: torch.Tensor, partitions: torch.Tensor) -> torch.Tensor:
        """perm (B, N) shuffled agent ids; partitions (B, G+1) slice points.
        member[b, i, g]: agent i's position p in the shuffle satisfies
        partitions[g] <= p < partitions[g+1]."""
        B, N = perm.shape
        pos = torch.empty_like(perm)
        pos.scatter_(1, perm, torch.arange(N, device=perm.device).expand(B, N).contiguous())
        p = pos[:, :, None]
        return (p >= partitions[:, None, :-1]) & (p < partitions[:, None, 1:])

    @staticmethod
    def matches(locs: torch.Tensor, member: torch.Tensor, n_states: int) -> torch.Tensor:
        """Number of groups piled on one cell; empty groups count as matched."""
        cells = torch.arange(n_states, device=locs.device)
        at = locs[:, :, None] == cells  # (B, N, S)
        counts = (member[:, :, :, None] & at[:, :, None, :]).sum(dim=1)  # (B, G, S)
        group_size = member.sum(dim=1)  # (B, G)
        return (counts.max(dim=2).values == group_size).sum(dim=1)

    @staticmethod
    def transition(locs, actions, rand_u, rand_a, rand_trans: float, n_states: int):
        """Movement given explicit draws: where rand_u < rand_trans the action
        is replaced by rand_a."""
        ac = torch.where(rand_u < rand_trans, rand_a.to(locs.dtype), actions.to(locs.dtype))
        return torch.remainder(locs + ac - 1, n_states)

    def draw_reset(self, batch_size: int, generator: Optional[torch.Generator]):
        """(perm (B, N), partitions (B, G+1), locs (B, N)) from ``generator``."""
        B, N, G, dev = batch_size, self.n_agents, self.n_groups, self.device
        if self.fixed_scen:
            perm = torch.arange(N, device=dev).expand(B, N)
            pts = torch.round(torch.linspace(0, N, G + 1, dtype=torch.float64)).long()
            partitions = pts.to(dev).expand(B, G + 1)
        else:
            perm = torch.rand((B, N), generator=generator, device=dev).argsort(dim=1)
            mid = torch.randint(0, N, (B, G - 1), generator=generator, device=dev)
            zeros = torch.zeros((B, 1), dtype=torch.long, device=dev)
            partitions = torch.cat([zeros, mid, torch.full_like(zeros, N)], dim=1)
        locs = torch.randint(0, self.n_states, (B, N), generator=generator, device=dev)
        return perm, partitions, locs

    def draw_step(self, batch_size: int, generator: Optional[torch.Generator]):
        """(rand_u (B, N), rand_a (B, N)) from ``generator``."""
        shape = (batch_size, self.n_agents)
        rand_u = torch.rand(shape, generator=generator, device=self.device)
        rand_a = torch.randint(0, self.n_actions, shape, generator=generator, device=self.device)
        return rand_u, rand_a

    def reset(self, batch_size: int, generator: Optional[torch.Generator] = None,
              test: bool = False, index=None, draws=None):
        perm, partitions, locs = draws if draws is not None else self.draw_reset(
            batch_size, generator)
        perm, partitions, locs = (torch.as_tensor(x, device=self.device).long()
                                  for x in (perm, partitions, locs))
        member = self.membership_from_partitions(perm, partitions)
        state = GroupMatchingState(
            locs=locs, member=member, prev_matches=self.matches(locs, member, self.n_states),
            t=torch.zeros((batch_size,), dtype=torch.long, device=self.device))
        return state, self.observe(state)

    def step(self, state: GroupMatchingState, actions: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None):
        B = state.locs.shape[0]
        rand_u, rand_a = draws if draws is not None else self.draw_step(B, generator)
        locs = self.transition(state.locs, actions, torch.as_tensor(rand_u, device=self.device),
                               torch.as_tensor(rand_a, device=self.device), self.rand_trans,
                               self.n_states)
        matches = self.matches(locs, state.member, self.n_states)
        reward = -0.1 + 2.5 * (matches - state.prev_matches).float()
        solved = matches == self.n_groups
        t = state.t + 1
        at_limit = t == self.episode_limit
        info = {"solved": solved, "episode_limit": at_limit}
        new_state = GroupMatchingState(locs=locs, member=state.member, prev_matches=matches, t=t)
        return new_state, self.observe(new_state), reward, solved | at_limit, info

    def observe(self, state: GroupMatchingState) -> Dict[str, torch.Tensor]:
        B, N = state.locs.shape
        dev = state.locs.device
        locs_oh = torch.nn.functional.one_hot(state.locs, self.n_states).float()
        agent_ids = torch.eye(N, device=dev).expand(B, N, N)
        entities = torch.cat([locs_oh, state.member.float(), agent_ids], dim=2)
        # each agent's first containing group (0 if it is in none)
        first_grp = state.member.long().argmax(dim=2)  # (B, N)
        # gt_unblocked[b, j, i] = member[b, j, first_grp[b, i]]
        gt_unblocked = state.member.gather(2, first_grp[:, None, :].expand(B, N, N))
        return {
            "entities": entities,
            "obs_mask": torch.zeros((B, N, N), dtype=torch.bool, device=dev),
            "entity_mask": torch.zeros((B, N), dtype=torch.bool, device=dev),
            "gt_mask": ~gt_unblocked.transpose(1, 2),
            "avail_actions": torch.ones((B, N, self.n_actions), dtype=torch.bool, device=dev),
        }
