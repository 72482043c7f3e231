"""Multi-agent controllers, port of ``refil_tpu/controllers/mac.py``.

A controller owns the agent module (the JAX one threads parameters); the
learner's target network is a deep copy of it.

* ``EntityMAC`` (entity scheme): the entities, optionally concatenated with
  each agent's last action one-hot written into the first ``n_agents``
  entity rows.
* ``BasicMAC`` (flat scheme): each agent's observation ++ its last action
  one-hot (``obs_last_action``) ++ its id one-hot (``obs_agent_id``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..modules.agents import AGENT_REGISTRY


def compute_dtype(args) -> Optional[torch.dtype]:
    """The activation dtype of ``compute_dtype``; None keeps float32."""
    return torch.bfloat16 if getattr(args, "compute_dtype", "float32") == "bfloat16" else None


class EntityMAC:
    def __init__(self, args, env_info: Dict[str, Any], device, generator=None):
        self.args = args
        self.device = torch.device(device)
        self.n_agents = env_info["n_agents"]
        self.n_actions = env_info["n_actions"]
        self.n_entities = env_info["n_entities"]
        self.entity_shape = env_info["entity_shape"]
        self.gt_mask_avail = bool(env_info.get("gt_mask_avail", False))
        self.entity_last_action = bool(getattr(args, "entity_last_action", False))
        self.input_shape = self.entity_shape + (self.n_actions if self.entity_last_action else 0)
        self.is_imagine = "imagine" in args.agent
        if args.agent not in AGENT_REGISTRY or args.agent in FLAT_AGENTS:
            raise ValueError(f"entity_mac takes an entity-scheme agent, not {args.agent!r}; "
                             f"they are {sorted(set(AGENT_REGISTRY) - set(FLAT_AGENTS))}")
        self.agent = AGENT_REGISTRY[args.agent](
            input_shape=self.input_shape,
            attn_embed_dim=args.attn_embed_dim,
            rnn_hidden_dim=args.rnn_hidden_dim,
            n_actions=self.n_actions,
            n_agents=self.n_agents,
            attn_n_heads=args.attn_n_heads,
            pooling_type=getattr(args, "pooling_type", None),
            gt_obs_mask=bool(getattr(args, "gt_obs_mask", False)),
            dtype=compute_dtype(args),
            use_kernel=bool(getattr(args, "use_pallas_attention", True)),
            use_gru_kernel=bool(getattr(args, "use_pallas_gru", True)),
            generator=generator,
        ).to(self.device)

    def parameters(self):
        return self.agent.parameters()

    def init_hidden(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((batch_size, self.n_agents, self.args.rnn_hidden_dim),
                           device=self.device)

    # --- input building ---
    def _concat_last_action(self, entities: torch.Tensor, last_oh: torch.Tensor):
        """entities (B, T, Ne, D); last_oh (B, T, Na, A) -> features ++ one-hot,
        zeros in the non-agent rows."""
        B, T, Ne, _ = entities.shape
        ent_acs = torch.zeros((B, T, Ne, self.n_actions), dtype=entities.dtype,
                              device=entities.device)
        ent_acs[:, :, :self.n_agents] = last_oh.to(entities.dtype)
        return torch.cat([entities, ent_acs], dim=3)

    def build_step_inputs(self, obs: Dict[str, torch.Tensor],
                          last_actions_onehot: Optional[torch.Tensor]):
        """One timestep with a T=1 axis; ``last_actions_onehot`` (B, Na, A)."""
        entities = obs["entities"][:, None]
        if self.entity_last_action:
            entities = self._concat_last_action(entities, last_actions_onehot[:, None])
        gt = obs["gt_mask"][:, None] if (self.gt_mask_avail and "gt_mask" in obs) else None
        return entities, obs["obs_mask"][:, None], obs["entity_mask"][:, None], gt

    def build_episode_inputs(self, batch: Dict[str, torch.Tensor]):
        """Whole-episode inputs; the last-action block at t is
        actions_onehot[t-1], zeros at t=0."""
        entities = batch["entities"]
        if self.entity_last_action:
            ao = batch["actions_onehot"]
            last = torch.cat([torch.zeros_like(ao[:, :1]), ao[:, :-1]], dim=1)
            entities = self._concat_last_action(entities, last)
        gt = batch.get("gt_mask") if self.gt_mask_avail else None
        return entities, batch["obs_mask"], batch["entity_mask"], gt

    # --- forwards ---
    def forward_step(self, obs, last_actions_onehot, hidden):
        """One rollout step: (q (B, Na, A), new hidden)."""
        entities, om, em, gt = self.build_step_inputs(obs, last_actions_onehot)
        q, h = self.agent(entities, om, em, hidden, gt_mask=gt)
        return q[:, 0], h

    def forward_episode(self, batch, imagine: bool = False, generator=None,
                        imagine_draws=None, use_gt_factors: bool = False,
                        use_rand_gt_factors: bool = False):
        """Learner path. With ``imagine``: (q (3B, T, Na, A), (W, I) masks);
        else q (B, T, Na, A)."""
        entities, om, em, gt = self.build_episode_inputs(batch)
        hidden = self.init_hidden(entities.shape[0])
        if imagine:
            q, _, groups = self.agent(entities, om, em, hidden, imagine=True,
                                      generator=generator, imagine_draws=imagine_draws,
                                      gt_mask=gt, use_gt_factors=use_gt_factors,
                                      use_rand_gt_factors=use_rand_gt_factors)
            return q, groups
        q, _ = self.agent(entities, om, em, hidden, gt_mask=gt)
        return q


FLAT_AGENTS = ("ff", "rnn")


class BasicMAC:
    """Flat-scheme controller (``refil_tpu/controllers/mac.py:BasicMAC``)."""

    def __init__(self, args, env_info: Dict[str, Any], device, generator=None):
        self.args = args
        self.device = torch.device(device)
        self.n_agents = env_info["n_agents"]
        self.n_actions = env_info["n_actions"]
        self.obs_shape = env_info["obs_shape"]
        self.obs_last_action = bool(getattr(args, "obs_last_action", True))
        self.obs_agent_id = bool(getattr(args, "obs_agent_id", True))
        self.input_shape = (self.obs_shape + (self.n_actions if self.obs_last_action else 0)
                            + (self.n_agents if self.obs_agent_id else 0))
        self.is_imagine = False
        if args.agent not in FLAT_AGENTS:
            raise ValueError(f"basic_mac takes a flat-scheme agent {FLAT_AGENTS}, not "
                             f"{args.agent!r}")
        self.agent = AGENT_REGISTRY[args.agent](
            input_shape=self.input_shape, rnn_hidden_dim=args.rnn_hidden_dim,
            n_actions=self.n_actions,
            use_gru_kernel=bool(getattr(args, "use_pallas_gru", True)),
            generator=generator,
        ).to(self.device)

    def parameters(self):
        return self.agent.parameters()

    def init_hidden(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((batch_size, self.n_agents, self.args.rnn_hidden_dim),
                           device=self.device)

    def _augment(self, obs: torch.Tensor, last_oh: torch.Tensor) -> torch.Tensor:
        """obs (B, T, Na, O); last_oh (B, T, Na, A) -> the agents' inputs."""
        B, T, Na, _ = obs.shape
        parts = [obs]
        if self.obs_last_action:
            parts.append(last_oh.to(obs.dtype))
        if self.obs_agent_id:
            parts.append(torch.eye(Na, dtype=obs.dtype, device=obs.device).expand(B, T, Na, Na))
        return torch.cat(parts, dim=3)

    def forward_step(self, obs, last_actions_onehot, hidden):
        """One rollout step: (q (B, Na, A), new hidden)."""
        inp = self._augment(obs["obs"][:, None], last_actions_onehot[:, None])
        q, h = self.agent(inp, hidden)
        return q[:, 0], h

    def forward_episode(self, batch, **unused):
        """Learner path: q (B, T, Na, A); the last-action block at t is
        actions_onehot[t-1], zeros at t=0."""
        obs, ao = batch["obs"], batch["actions_onehot"]
        last = torch.cat([torch.zeros_like(ao[:, :1]), ao[:, :-1]], dim=1)
        q, _ = self.agent(self._augment(obs, last), self.init_hidden(obs.shape[0]))
        return q


def pi_logits_transform(q: torch.Tensor, avail: torch.Tensor,
                        epsilon: Union[float, torch.Tensor], test_mode: bool,
                        mask_before_softmax: bool = True) -> torch.Tensor:
    """``agent_output_type: pi_logits``: the availability-masked softmax,
    with an epsilon floor spread over the available actions in training."""
    if mask_before_softmax:
        q = q.masked_fill(~avail, -1e10)
    probs = torch.softmax(q, dim=-1)
    if not test_mode:
        if mask_before_softmax:
            n_avail = avail.sum(dim=-1, keepdim=True).to(probs.dtype)
        else:
            n_avail = float(q.shape[-1])
        probs = (1 - epsilon) * probs + epsilon / n_avail
        if mask_before_softmax:
            probs = probs.masked_fill(~avail, 0.0)
    return probs


MAC_REGISTRY = {"entity_mac": EntityMAC, "basic_mac": BasicMAC}
