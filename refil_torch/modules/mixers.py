"""Mixing networks, port of ``refil_tpu/modules/mixers.py``.

``AttentionHyperNet`` (all four modes), ``FlexQMixer`` (the combat mixer),
``LinearFlexQMixer`` (the Group Matching mixer), ``VDNMixer`` and ``QMixer``
(the flat path's, over the global state vector).

Shapes: ``entities`` (B, T, Ne, D); ``entity_mask`` (B, T, Ne) bool;
``states`` (B, T, S); ``agent_qs`` (B, T, Na), or (B, T, 2·Na) on the
imagined path. Mixers return ``q_tot`` (B, T, 1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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
                ret_ingroup_prop=False, ingroup_rows=None):
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
            # mean share of mixing weight on the in-group Qs; over
            # ``ingroup_rows`` rows where this batch is a shard of them
            ingroup_w = w1.clone()
            if imagine_groups is not None:
                ingroup_w[:, self.n_agents:] = 0.0
            share = ingroup_w.sum(dim=1)
            return q_tot, share.mean() if ingroup_rows is None else share.sum() / ingroup_rows
        return q_tot


class VDNMixer(nn.Module):
    """``q_tot = Σ_i q_i``."""

    def forward(self, agent_qs, entities=None, entity_mask=None, imagine_groups=None):
        return agent_qs.sum(dim=2, keepdim=True)


class QMixer(nn.Module):
    """QMIX's monotonic mixing over the flat state: hypernets from the state
    give |W_1| (Na, E), b_1, |w_final| (E) and V; ``hypernet_layers`` 1 makes
    W_1 and w_final one Linear each, 2 a Linear -> ReLU -> Linear of width
    ``hypernet_embed``. ``softmax_mixing_weights`` takes a softmax over E
    in place of the absolute value; ``mixer_non_lin`` is elu or tanh.

    The imagined path takes ``imagine_groups`` = (groupA, groupB), each
    (B, T, Ne) or broadcastable to it: each group's state is the state masked
    by the union of its entities' ``state_masks`` rows (Ne, S), and W_1 runs
    on each, so the 2·Na imagined Qs mix against one b_1, w_final and V."""

    def __init__(self, n_agents: int, state_dim: int, mixing_embed_dim: int,
                 hypernet_layers: int = 1, hypernet_embed: int = 64,
                 softmax_mixing_weights: bool = False, mixer_non_lin: str = "elu",
                 state_masks=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents = n_agents
        self.state_dim = state_dim
        self.mixing_embed_dim = E = mixing_embed_dim
        self.hypernet_layers = int(hypernet_layers)
        self.softmax_mixing_weights = softmax_mixing_weights
        self.mixer_non_lin = mixer_non_lin
        lin = lambda i, o: TorchLinear(i, o, generator=generator)  # noqa: E731
        # the flax tree's names: hyper_w_1 (or hyper_w_1_0, hyper_w_1_1),
        # hyper_w_final (or _0, _1), hyper_b_1, V_0, V_1
        if self.hypernet_layers > 1:
            self.hyper_w_1_0 = lin(state_dim, hypernet_embed)
            self.hyper_w_1_1 = lin(hypernet_embed, E * n_agents)
            self.hyper_w_final_0 = lin(state_dim, hypernet_embed)
            self.hyper_w_final_1 = lin(hypernet_embed, E)
        else:
            self.hyper_w_1 = lin(state_dim, E * n_agents)
            self.hyper_w_final = lin(state_dim, E)
        self.hyper_b_1 = lin(state_dim, E)
        self.V_0 = lin(state_dim, E)
        self.V_1 = lin(E, 1)
        self.register_buffer("state_masks", None if state_masks is None else
                             torch.as_tensor(np.asarray(state_masks), dtype=torch.float32))

    def _hyper(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.hypernet_layers > 1:
            return getattr(self, f"{name}_1")(torch.relu(getattr(self, f"{name}_0")(x)))
        return getattr(self, name)(x)

    def _weights(self, w: torch.Tensor) -> torch.Tensor:
        return torch.softmax(w, dim=-1) if self.softmax_mixing_weights else w.abs()

    def forward(self, agent_qs, states, imagine_groups=None):
        B, T, S = states.shape
        E = self.mixing_embed_dim
        st = states.reshape(B * T, S)
        if imagine_groups is not None:
            if self.state_masks is None:
                raise ValueError("imagined flat mixing needs state_masks")
            ne = self.state_masks.shape[0]
            gA, gB = (g.reshape(B * T, ne, 1).to(st.dtype) for g in imagine_groups)
            sm = self.state_masks.reshape(1, ne, S).to(st.dtype)
            mask_a = (gA * sm).sum(dim=1).clamp(max=1.0)
            mask_b = (gB * sm).sum(dim=1).clamp(max=1.0)
            w1 = torch.cat([self._hyper("hyper_w_1", st * mask_a),
                            self._hyper("hyper_w_1", st * mask_b)], dim=1)
            qs = agent_qs.reshape(B * T, 1, self.n_agents * 2)
        else:
            w1 = self._hyper("hyper_w_1", st)
            qs = agent_qs.reshape(B * T, 1, self.n_agents)
        b1 = self.hyper_b_1(st).reshape(B * T, 1, E)
        w1 = self._weights(w1.reshape(B * T, -1, E))
        non_lin = F.elu if self.mixer_non_lin == "elu" else torch.tanh
        hidden = non_lin(torch.bmm(qs, w1) + b1)  # (B*T, 1, E)
        wf = self._weights(self._hyper("hyper_w_final", st))  # (B*T, E)
        v = self.V_1(torch.relu(self.V_0(st))).reshape(B * T, 1, 1)
        y = torch.bmm(hidden, wf[..., None]) + v
        return y.reshape(B, T, 1)


MIXER_REGISTRY = {
    "vdn": VDNMixer,
    "qmix": QMixer,
    "flex_qmix": FlexQMixer,
    "lin_flex_qmix": LinearFlexQMixer,
}
