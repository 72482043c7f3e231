"""Mixing networks, port of ``refil_tpu/modules/mixers.py``.

Ported: ``AttentionHyperNet`` (all four modes), ``FlexQMixer`` (the combat
mixer), ``LinearFlexQMixer`` (the Group Matching mixer) and ``VDNMixer``.
``QMixer`` belongs to the flat path, not ported yet.

Shapes: ``entities`` (B, T, Ne, D); ``entity_mask`` (B, T, Ne) bool;
``agent_qs`` (B, T, Na), or (B, T, 2·Na) on the imagined path. Mixers return
``q_tot`` (B, T, 1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import hypernet_attn_mask
from .layers import TorchLinear, make_entity_layer


class AttentionHyperNet(nn.Module):
    """fc1 -> ReLU -> attention -> fc2, then an agent-masked reduction:
    'matrix' (B', Na, E), 'vector' (B', E), 'alt_vector' (B', Na), 'scalar' (B',)."""

    def __init__(self, input_dim: int, hypernet_embed: int, mixing_embed_dim: int,
                 n_agents: int, attn_n_heads: int, pooling_type: Optional[str] = None,
                 mode: str = "matrix", dtype: Optional[torch.dtype] = None,
                 use_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents = n_agents
        self.mode = mode
        self.fc1 = TorchLinear(input_dim, hypernet_embed, generator=generator)
        self.attn = make_entity_layer(hypernet_embed, hypernet_embed, hypernet_embed,
                                      attn_n_heads, pooling_type, dtype=dtype,
                                      use_kernel=use_kernel, generator=generator)
        self.fc2 = TorchLinear(hypernet_embed, mixing_embed_dim, generator=generator)

    def forward(self, entities, entity_mask, attn_mask=None):
        # entities (B', Ne, D); entity_mask (B', Ne) bool
        x1 = torch.relu(self.fc1(entities))
        agent_mask = entity_mask[:, :self.n_agents]
        if attn_mask is None:
            attn_mask = hypernet_attn_mask(entity_mask, self.n_agents)
        x2 = self.attn(x1, pre_mask=attn_mask, post_mask=agent_mask)
        x3 = self.fc2(x2).masked_fill(agent_mask[..., None], 0.0)
        if self.mode == "vector":
            return x3.mean(dim=1)
        if self.mode == "alt_vector":
            return x3.mean(dim=2)
        if self.mode == "scalar":
            return x3.mean(dim=(1, 2))
        return x3


class FlexQMixer(nn.Module):
    """QMIX monotonic mixing with attention hypernets. On the imagined path
    the first-layer hypernet runs twice, with the within-group and the
    interaction masks, and the 2·Na imagined Qs mix against the same
    targets."""

    def __init__(self, n_agents: int, input_dim: int, mixing_embed_dim: int,
                 hypernet_embed: int, attn_n_heads: int, softmax_mixing_weights: bool = False,
                 mixer_non_lin: str = "elu", pooling_type: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, use_kernel: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents = n_agents
        self.mixing_embed_dim = mixing_embed_dim
        self.softmax_mixing_weights = softmax_mixing_weights
        self.mixer_non_lin = mixer_non_lin
        self.dtype = dtype
        kw = dict(input_dim=input_dim, hypernet_embed=hypernet_embed,
                  mixing_embed_dim=mixing_embed_dim, n_agents=n_agents,
                  attn_n_heads=attn_n_heads, pooling_type=pooling_type, dtype=dtype,
                  use_kernel=use_kernel, generator=generator)
        self.hyper_w_1 = AttentionHyperNet(mode="matrix", **kw)
        self.hyper_w_final = AttentionHyperNet(mode="vector", **kw)
        self.hyper_b_1 = AttentionHyperNet(mode="vector", **kw)
        self.V = AttentionHyperNet(mode="scalar", **kw)

    def _weights(self, w: torch.Tensor) -> torch.Tensor:
        return torch.softmax(w, dim=-1) if self.softmax_mixing_weights else w.abs()

    def forward(self, agent_qs, entities, entity_mask, imagine_groups=None):
        B, T, Ne, D = entities.shape
        if self.dtype is not None:
            entities = entities.to(self.dtype)
            agent_qs = agent_qs.to(self.dtype)
        ents = entities.reshape(B * T, Ne, D)
        em = entity_mask.reshape(B * T, Ne)
        E = self.mixing_embed_dim

        if imagine_groups is not None:
            w_mask, i_mask = imagine_groups
            qs = agent_qs.reshape(B * T, 1, self.n_agents * 2)
            w1_W = self.hyper_w_1(ents, em, attn_mask=w_mask.reshape(B * T, -1, Ne))
            w1_I = self.hyper_w_1(ents, em, attn_mask=i_mask.reshape(B * T, -1, Ne))
            w1 = torch.cat([w1_W, w1_I], dim=1)  # (B', 2Na, E)
        else:
            qs = agent_qs.reshape(B * T, 1, self.n_agents)
            w1 = self.hyper_w_1(ents, em)  # (B', Na, E)
        b1 = self.hyper_b_1(ents, em).reshape(B * T, 1, E)
        non_lin = F.elu if self.mixer_non_lin == "elu" else torch.tanh
        hidden = non_lin(torch.bmm(qs, self._weights(w1)) + b1)  # (B', 1, E)
        w_final = self._weights(self.hyper_w_final(ents, em))  # (B', E)
        v = self.V(ents, em).reshape(B * T, 1, 1)
        y = torch.bmm(hidden, w_final[..., None]) + v
        return y.reshape(B, T, 1).float()


class LinearFlexQMixer(nn.Module):
    """Linear mixing: a scalar weight per agent, ``q_tot = Σ w_i·q_i + V``."""

    def __init__(self, n_agents: int, input_dim: int, mixing_embed_dim: int,
                 hypernet_embed: int, attn_n_heads: int, softmax_mixing_weights: bool = False,
                 pooling_type: Optional[str] = None, dtype: Optional[torch.dtype] = None,
                 use_kernel: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents = n_agents
        self.softmax_mixing_weights = softmax_mixing_weights
        self.dtype = dtype
        kw = dict(input_dim=input_dim, hypernet_embed=hypernet_embed,
                  mixing_embed_dim=mixing_embed_dim, n_agents=n_agents,
                  attn_n_heads=attn_n_heads, pooling_type=pooling_type, dtype=dtype,
                  use_kernel=use_kernel, generator=generator)
        self.hyper_w_1 = AttentionHyperNet(mode="alt_vector", **kw)
        self.V = AttentionHyperNet(mode="scalar", **kw)

    def forward(self, agent_qs, entities, entity_mask, imagine_groups=None,
                ret_ingroup_prop=False):
        B, T, Ne, D = entities.shape
        if self.dtype is not None:
            entities = entities.to(self.dtype)
            agent_qs = agent_qs.to(self.dtype)
        ents = entities.reshape(B * T, Ne, D)
        em = entity_mask.reshape(B * T, Ne)

        if imagine_groups is not None:
            w_mask, i_mask = imagine_groups
            qs = agent_qs.reshape(B * T, self.n_agents * 2)
            w1_W = self.hyper_w_1(ents, em, attn_mask=w_mask.reshape(B * T, self.n_agents, Ne))
            w1_I = self.hyper_w_1(ents, em, attn_mask=i_mask.reshape(B * T, self.n_agents, Ne))
            w1 = torch.cat([w1_W, w1_I], dim=1)  # (B', 2Na)
        else:
            qs = agent_qs.reshape(B * T, self.n_agents)
            w1 = self.hyper_w_1(ents, em)  # (B', Na)
        w1 = torch.softmax(w1, dim=1) if self.softmax_mixing_weights else w1.abs()
        v = self.V(ents, em)  # (B',)

        q_tot = ((qs * w1).sum(dim=1) + v).reshape(B, T, 1).float()
        if ret_ingroup_prop:
            # mean share of mixing weight on the in-group Qs
            ingroup_w = w1.clone()
            if imagine_groups is not None:
                ingroup_w[:, self.n_agents:] = 0.0
            return q_tot, ingroup_w.sum(dim=1).mean()
        return q_tot


class VDNMixer(nn.Module):
    """``q_tot = Σ_i q_i``."""

    def forward(self, agent_qs, entities=None, entity_mask=None, imagine_groups=None):
        return agent_qs.sum(dim=2, keepdim=True)


MIXER_REGISTRY = {
    "vdn": VDNMixer,
    "flex_qmix": FlexQMixer,
    "lin_flex_qmix": LinearFlexQMixer,
}
