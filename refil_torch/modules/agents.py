"""Agent Q-networks over entity sets, port of ``refil_tpu/modules/agents.py``.

``EntityAttentionFFAgent`` and ``ImagineEntityAttentionFFAgent`` (the Group
Matching agents), ``EntityAttentionRNNAgent`` and
``ImagineEntityAttentionRNNAgent`` (the combat agents), and the flat agents
``FFAgent`` and ``RNNAgent`` (the flat SMAC path).

The whole (B, T) grid is flattened into one batched attention call, the GRU
runs over the whole sequence at once (``GRUSequence``), and REFIL's ×3 [full,
within-group, across-group] pass tiles the batch axis. All masks are boolean
blocking masks (True = blocked / inactive).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masks import build_imagine_masks
from .layers import GRUSequence, TorchLinear, make_entity_layer


class EntityAttentionFFAgent(nn.Module):
    """fc1 -> ReLU -> entity-attention -> ReLU -> fc2 -> Q. ``hidden`` passes
    through untouched (API uniformity with the RNN agents); ``use_gru_kernel``
    is accepted for the same reason and ignored."""

    agent_rows = True  # imagine masks are agent-rows (Na, Ne) for FF agents

    def __init__(self, input_shape: int, attn_embed_dim: int, rnn_hidden_dim: int,
                 n_actions: int, n_agents: int, attn_n_heads: int,
                 pooling_type: Optional[str] = None, gt_obs_mask: bool = False,
                 dtype: Optional[torch.dtype] = None, use_kernel: bool = True,
                 use_gru_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents = n_agents
        self.n_actions = n_actions
        self.gt_obs_mask = gt_obs_mask
        self.dtype = dtype
        self.fc1 = TorchLinear(input_shape, attn_embed_dim, generator=generator)
        self.attn = make_entity_layer(attn_embed_dim, attn_embed_dim, attn_embed_dim,
                                      attn_n_heads, pooling_type, dtype=dtype,
                                      use_kernel=use_kernel, generator=generator)
        self.fc2 = TorchLinear(attn_embed_dim, n_actions, generator=generator)

    def _base_forward(self, entities, obs_mask, entity_mask, hidden, ret_attn_logits=None):
        B, T, Ne, D = entities.shape
        if self.dtype is not None:
            entities = entities.to(self.dtype)
        x = entities.reshape(B * T, Ne, D)
        pre_mask = obs_mask.reshape(B * T, obs_mask.shape[2], Ne)
        agent_mask = entity_mask.reshape(B * T, Ne)[:, :self.n_agents]

        x1 = torch.relu(self.fc1(x))
        attn_outs = self.attn(x1, pre_mask=pre_mask, post_mask=agent_mask,
                              ret_attn_logits=ret_attn_logits)
        if ret_attn_logits is not None:
            x2, attn_logits = attn_outs
        else:
            x2 = attn_outs
        q = self.fc2(torch.relu(x2))
        q = q.reshape(B, T, self.n_agents, self.n_actions)
        # zero Q of inactive agents
        q = q.masked_fill(agent_mask.reshape(B, T, self.n_agents, 1), 0.0).float()
        if ret_attn_logits is not None:
            return q, hidden, attn_logits.reshape(B, T, self.n_agents, Ne)
        return q, hidden

    def forward(self, entities, obs_mask, entity_mask, hidden, ret_attn_logits=None,
                gt_mask=None, **unused):
        if self.gt_obs_mask and gt_mask is not None:
            obs_mask = gt_mask  # ground truth substitutes for observability
        return self._base_forward(entities, obs_mask, entity_mask, hidden, ret_attn_logits)


class EntityAttentionRNNAgent(nn.Module):
    """fc1 -> ReLU -> entity-attention -> fc2 -> ReLU -> GRU over T -> fc3 -> Q.
    ``use_gru_kernel`` is the config's ``use_pallas_gru``."""

    agent_rows = False  # imagine masks are square (Ne, Ne) for RNN agents

    def __init__(self, input_shape: int, attn_embed_dim: int, rnn_hidden_dim: int,
                 n_actions: int, n_agents: int, attn_n_heads: int,
                 pooling_type: Optional[str] = None, gt_obs_mask: bool = False,
                 dtype: Optional[torch.dtype] = None, use_kernel: bool = True,
                 use_gru_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents = n_agents
        self.n_actions = n_actions
        self.rnn_hidden_dim = rnn_hidden_dim
        self.dtype = dtype
        self.fc1 = TorchLinear(input_shape, attn_embed_dim, generator=generator)
        self.attn = make_entity_layer(attn_embed_dim, attn_embed_dim, attn_embed_dim,
                                      attn_n_heads, pooling_type, dtype=dtype,
                                      use_kernel=use_kernel, generator=generator)
        self.fc2 = TorchLinear(attn_embed_dim, rnn_hidden_dim, generator=generator)
        self.gru = GRUSequence(rnn_hidden_dim, rnn_hidden_dim, use_kernel=use_gru_kernel,
                               generator=generator)
        self.fc3 = TorchLinear(rnn_hidden_dim, n_actions, generator=generator)

    def _base_forward(self, entities, obs_mask, entity_mask, hidden, ret_attn_logits=None):
        B, T, Ne, D = entities.shape
        Na, H = self.n_agents, self.rnn_hidden_dim
        if self.dtype is not None:
            entities = entities.to(self.dtype)
        x = entities.reshape(B * T, Ne, D)
        pre_mask = obs_mask.reshape(B * T, obs_mask.shape[2], Ne)
        agent_mask = entity_mask.reshape(B * T, Ne)[:, :Na]

        x1 = torch.relu(self.fc1(x))
        attn_outs = self.attn(x1, pre_mask=pre_mask, post_mask=agent_mask,
                              ret_attn_logits=ret_attn_logits)
        if ret_attn_logits is not None:
            x2, attn_logits = attn_outs
        else:
            x2 = attn_outs
        x3 = torch.relu(self.fc2(x2))
        # (B*T, Na, H) -> (B*Na, T, H) for the sequence
        x3 = x3.reshape(B, T, Na, H).transpose(1, 2).reshape(B * Na, T, H)
        h_last, hs = self.gru(x3, hidden.reshape(B * Na, H))
        hs = hs.reshape(B, Na, T, H).transpose(1, 2)
        q = self.fc3(hs)  # (B, T, Na, A)
        # zero Q of inactive agents
        q = q.masked_fill(agent_mask.reshape(B, T, Na, 1), 0.0).float()
        h_out = h_last.reshape(B, Na, H)
        if ret_attn_logits is not None:
            return q, h_out, attn_logits.reshape(B, T, Na, Ne)
        return q, h_out

    def forward(self, entities, obs_mask, entity_mask, hidden, ret_attn_logits=None,
                **unused):
        return self._base_forward(entities, obs_mask, entity_mask, hidden, ret_attn_logits)


def _imagine_forward(agent, entities, obs_mask, entity_mask, hidden, generator=None,
                     imagine_draws=None, gt_mask=None, use_gt_factors=False,
                     use_rand_gt_factors=False):
    """REFIL ×3 tiling (``refil_tpu/modules/agents.py:177-213``).
    ``imagine_draws`` = (group_probs, groupA) overrides ``generator``."""
    group_probs, groupA = imagine_draws if imagine_draws is not None else (None, None)
    masks = build_imagine_masks(
        obs_mask, entity_mask, agent.n_agents, agent_rows=agent.agent_rows,
        gt_mask=gt_mask, use_gt_factors=use_gt_factors,
        use_rand_gt_factors=use_rand_gt_factors, generator=generator,
        group_probs=group_probs, groupA=groupA,
    )
    ent3 = torch.cat([entities] * 3, dim=0)
    # the attention layer reads only the first Na rows of a pre-mask
    base = obs_mask[:, :, :agent.n_agents, :] if agent.agent_rows else obs_mask
    om3 = torch.cat([base, masks.within, masks.interact], dim=0)
    em3 = torch.cat([entity_mask] * 3, dim=0)
    h3 = torch.cat([hidden] * 3, dim=0)
    q, h = agent._base_forward(ent3, om3, em3, h3)
    return q, h, (masks.w_noobs, masks.i_noobs)


class ImagineEntityAttentionFFAgent(EntityAttentionFFAgent):
    """REFIL FF agent (Group Matching), incl. the gt-factor oracle paths."""

    def forward(self, entities, obs_mask, entity_mask, hidden, imagine=False,
                generator=None, imagine_draws=None, gt_mask=None, use_gt_factors=False,
                use_rand_gt_factors=False, ret_attn_logits=None):
        if self.gt_obs_mask and gt_mask is not None:
            obs_mask = gt_mask
        if not imagine:
            return self._base_forward(entities, obs_mask, entity_mask, hidden,
                                      ret_attn_logits)
        return _imagine_forward(self, entities, obs_mask, entity_mask, hidden,
                                generator=generator, imagine_draws=imagine_draws,
                                gt_mask=gt_mask, use_gt_factors=use_gt_factors,
                                use_rand_gt_factors=use_rand_gt_factors)


class ImagineEntityAttentionRNNAgent(EntityAttentionRNNAgent):
    """REFIL's combat agent: random entity bipartition, ×3 tiled forward."""

    def forward(self, entities, obs_mask, entity_mask, hidden, imagine=False,
                generator=None, imagine_draws=None, gt_mask=None, use_gt_factors=False,
                use_rand_gt_factors=False, ret_attn_logits=None):
        if not imagine:
            return self._base_forward(entities, obs_mask, entity_mask, hidden,
                                      ret_attn_logits)
        return _imagine_forward(self, entities, obs_mask, entity_mask, hidden,
                                generator=generator, imagine_draws=imagine_draws,
                                gt_mask=gt_mask, use_gt_factors=use_gt_factors,
                                use_rand_gt_factors=use_rand_gt_factors)


class FFAgent(nn.Module):
    """Flat-observation MLP: fc1 -> ReLU -> fc2 -> ReLU -> fc3 -> Q.
    ``inputs`` (B, T, Na, D); ``hidden`` passes through untouched, and
    ``use_gru_kernel`` is accepted and ignored (``BasicMAC`` builds either
    flat agent with the same arguments)."""

    def __init__(self, input_shape: int, rnn_hidden_dim: int, n_actions: int,
                 use_gru_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = TorchLinear(input_shape, rnn_hidden_dim, generator=generator)
        self.fc2 = TorchLinear(rnn_hidden_dim, rnn_hidden_dim, generator=generator)
        self.fc3 = TorchLinear(rnn_hidden_dim, n_actions, generator=generator)

    def forward(self, inputs, hidden, **unused):
        x = torch.relu(self.fc2(torch.relu(self.fc1(inputs))))
        return self.fc3(x), hidden


class RNNAgent(nn.Module):
    """Flat-observation GRU agent: fc1 -> ReLU -> GRU over T -> fc2 -> Q.
    ``inputs`` (B, T, Na, D); ``hidden`` (B, Na, H). The recurrence is
    ``GRUSequence``'s: the CUDA kernels on the card (``use_gru_kernel``, the
    config's ``use_pallas_gru``), at every T, the rollout's T = 1 included."""

    def __init__(self, input_shape: int, rnn_hidden_dim: int, n_actions: int,
                 use_gru_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn_hidden_dim = rnn_hidden_dim
        self.fc1 = TorchLinear(input_shape, rnn_hidden_dim, generator=generator)
        self.gru = GRUSequence(rnn_hidden_dim, rnn_hidden_dim, use_kernel=use_gru_kernel,
                               generator=generator)
        self.fc2 = TorchLinear(rnn_hidden_dim, n_actions, generator=generator)

    def forward(self, inputs, hidden, **unused):
        B, T, Na, _ = inputs.shape
        H = self.rnn_hidden_dim
        x = torch.relu(self.fc1(inputs))
        x = x.transpose(1, 2).reshape(B * Na, T, H)
        h_last, hs = self.gru(x, hidden.reshape(B * Na, H))
        q = self.fc2(hs.reshape(B, Na, T, H).transpose(1, 2))
        return q, h_last.reshape(B, Na, H)


AGENT_REGISTRY = {
    "ff": FFAgent,
    "rnn": RNNAgent,
    "entity_attend_ff": EntityAttentionFFAgent,
    "imagine_entity_attend_ff": ImagineEntityAttentionFFAgent,
    "entity_attend_rnn": EntityAttentionRNNAgent,
    "imagine_entity_attend_rnn": ImagineEntityAttentionRNNAgent,
}
