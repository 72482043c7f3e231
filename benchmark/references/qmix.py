"""Plain PyTorch QMIX: the GRU agent, the monotonic mixer over the global
state and one learner update, written from the paper (Rashid et al.,
"QMIX: Monotonic Value Function Factorisation for Deep Multi-Agent
Reinforcement Learning", ICML 2018, arXiv 1803.11485, §4) and PyMARL's
public code (``src/modules/agents/rnn_agent.py``,
``src/modules/mixers/qmix.py``, ``src/learners/q_learner.py``,
``src/controllers/basic_controller.py``), at its ``qmix.yaml`` settings on
SMAC (Samvelyan et al. 2019, arXiv 1902.04043).

It imports torch alone. Every product goes through one ``mm`` function, so
that a control can run the same arithmetic with its products in a lower
precision (``benchmark/precision.py``); everything else is float32.

The model, for the sizes of one configuration (``sizes``):

* agent inputs: each agent's observation, its last action one-hot (zeros
  at t = 0) and its id one-hot (``obs_last_action``, ``obs_agent_id``);
* agent: fc1 -> ReLU -> GRU over the episode -> fc2 -> Q, one network
  shared by the agents;
* mixer (``hypernet_layers`` 2): from the state s,
  |W_1| = |Linear(ReLU(Linear(s)))| (Na x M), b_1 = Linear(s),
  |w_final| = |Linear(ReLU(Linear(s)))| (M), V = Linear(ReLU(Linear(s)));
  Q_tot = ELU(q W_1 + b_1) w_final + V;
* update: double-Q one-step targets (the target agent's Q at the live
  agent's argmax over the available actions, mixed by the target mixer on
  the state of every step), the TD loss masked to the filled steps up to
  termination and summed over the mask's count, the gradients clipped to a
  global norm of ``grad_norm_clip``, RMSprop (``alpha``, ``eps`` outside the
  square root, no momentum).

Where it departs from PyMARL, as the port does:

* the GRU is flax's ``GRUCell`` (gate order [r | z | n]; the r and z gates
  carry one bias, on the input side, where ``torch.nn.GRUCell`` has two that
  only ever add; the n gate's hidden bias inside r * (...)), the same
  function of its inputs under another parametrisation;
* the clip leaves gradients alone below the norm and scales them by
  ``clip / norm`` above it (optax's ``clip_by_global_norm``), where
  ``clip_grad_norm_`` scales by ``clip / (norm + 1e-6)`` everywhere;
* every leaf starts U(-bound, bound) from one draw (``init_params``); both
  sides are handed the same weights, so PyMARL's initialisers do not enter.

Its helpers are its own, not ``refil.py``'s: a reference imports torch and
nothing else.

Parameters are a dict of named float32 tensors, named and laid out as the
port's ``QLearner.param_names()`` gives them (a Linear's ``weight`` is
(out, in); a GRU kernel is (in, H)).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

UNAVAILABLE_Q = -9999999.0
GATES = ("ir", "iz", "in", "hr", "hz", "hn")


# ------------------------------------------------------------------ parameters
def _linear_leaves(prefix: str, fan_in: int, fan_out: int):
    bound = 1.0 / math.sqrt(fan_in)
    return [(f"{prefix}.weight", (fan_out, fan_in), bound), (f"{prefix}.bias", (fan_out,), bound)]


def param_leaves(sizes) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, init bound) of every leaf, the agent's then the mixer's."""
    if sizes["hypernet_layers"] != 2:
        raise ValueError("the reference mixes with two-layer hypernets")
    h, a, na = sizes["rnn_hidden_dim"], sizes["n_actions"], sizes["n_agents"]
    s, hy, m = sizes["state_shape"], sizes["hypernet_embed"], sizes["mixing_embed_dim"]
    out = _linear_leaves("agent.fc1", sizes["obs_shape"] + a + na, h)
    gb = 1.0 / math.sqrt(h)
    for gate in GATES:
        out.append((f"agent.gru.{gate}.kernel", (h, h), gb))
        if gate not in ("hr", "hz"):
            out.append((f"agent.gru.{gate}.bias", (h,), gb))
    out += _linear_leaves("agent.fc2", h, a)
    out += _linear_leaves("mixer.hyper_w_1_0", s, hy) + _linear_leaves("mixer.hyper_w_1_1", hy,
                                                                         na * m)
    out += _linear_leaves("mixer.hyper_w_final_0", s, hy)
    out += _linear_leaves("mixer.hyper_w_final_1", hy, m)
    out += _linear_leaves("mixer.hyper_b_1", s, m)
    out += _linear_leaves("mixer.V_0", s, m) + _linear_leaves("mixer.V_1", m, 1)
    return out


def init_params(sizes, generator: torch.Generator, device) -> Params:
    """Every leaf U(-bound, bound) in float32, from one draw on ``device``."""
    leaves = param_leaves(sizes)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.rand((total,), generator=generator, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape, bound in leaves:
        n = math.prod(shape)
        out[name] = (flat[off:off + n] * bound).reshape(shape)
        off += n
    return out


# ------------------------------------------------------------------ layers
def _linear(p: Params, prefix: str, x: torch.Tensor, mm: MM) -> torch.Tensor:
    return mm(x, p[prefix + ".weight"].t()) + p[prefix + ".bias"]


def _gru(p: Params, x: torch.Tensor, mm: MM) -> torch.Tensor:
    """x (R, T, H) -> the hidden states (R, T, H), from h0 = 0."""
    g = "agent.gru."
    h_dim = x.shape[-1]
    w_i = torch.cat([p[g + "ir.kernel"], p[g + "iz.kernel"], p[g + "in.kernel"]], 1)
    b_i = torch.cat([p[g + "ir.bias"], p[g + "iz.bias"], p[g + "in.bias"]])
    w_h = torch.cat([p[g + "hr.kernel"], p[g + "hz.kernel"], p[g + "hn.kernel"]], 1)
    xw = mm(x, w_i) + b_i
    h = x.new_zeros((x.shape[0], h_dim))
    hs = []
    for t in range(x.shape[1]):
        gh = mm(h, w_h)
        r = torch.sigmoid(xw[:, t, :h_dim] + gh[:, :h_dim])
        z = torch.sigmoid(xw[:, t, h_dim:2 * h_dim] + gh[:, h_dim:2 * h_dim])
        cand = torch.tanh(xw[:, t, 2 * h_dim:] + r * (gh[:, 2 * h_dim:] + p[g + "hn.bias"]))
        h = (1.0 - z) * cand + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


# ------------------------------------------------------------------ model
def agent_inputs(batch, n_agents: int) -> torch.Tensor:
    """(B, T, Na, O + A + Na): the observation, the last action's one-hot
    (zeros at t = 0) and the agent's id one-hot."""
    obs, ao = batch["obs"].float(), batch["actions_onehot"].float()
    last = torch.cat([torch.zeros_like(ao[:, :1]), ao[:, :-1]], dim=1)
    b, t = obs.shape[:2]
    ids = torch.eye(n_agents, dtype=obs.dtype, device=obs.device).expand(b, t, n_agents, n_agents)
    return torch.cat([obs, last, ids], dim=-1)


def agent_q(p: Params, x: torch.Tensor, sizes, mm: MM) -> torch.Tensor:
    """x (B, T, Na, D) -> Q (B, T, Na, A)."""
    b, t, na, _ = x.shape
    h = sizes["rnn_hidden_dim"]
    x1 = torch.relu(_linear(p, "agent.fc1", x, mm))
    hs = _gru(p, x1.transpose(1, 2).reshape(b * na, t, h), mm)
    return _linear(p, "agent.fc2", hs.reshape(b, na, t, h).transpose(1, 2), mm)


def _hypernet(p: Params, net: str, s: torch.Tensor, mm: MM) -> torch.Tensor:
    return _linear(p, f"mixer.{net}_1", torch.relu(_linear(p, f"mixer.{net}_0", s, mm)), mm)


def mix(p: Params, qs: torch.Tensor, states: torch.Tensor, sizes, mm: MM) -> torch.Tensor:
    """qs (B, T, Na), states (B, T, S) -> Q_tot (B, T, 1)."""
    b, t, na = qs.shape
    m = sizes["mixing_embed_dim"]
    s = states.float().reshape(b * t, -1)
    w1 = _hypernet(p, "hyper_w_1", s, mm).abs().reshape(b * t, na, m)
    b1 = _linear(p, "mixer.hyper_b_1", s, mm).reshape(b * t, 1, m)
    hidden = F.elu(mm(qs.reshape(b * t, 1, na), w1) + b1)
    w_final = _hypernet(p, "hyper_w_final", s, mm).abs().reshape(b * t, m, 1)
    v = _hypernet(p, "V", s, mm).reshape(b * t, 1, 1)
    return (mm(hidden, w_final) + v).reshape(b, t, 1)


def loss(p: Params, target: Params, batch, sizes, mm: MM) -> torch.Tensor:
    """The QMIX loss of one update on ``batch`` (B, T+1, ...)."""
    x = agent_inputs(batch, sizes["n_agents"])
    avail = batch["avail_actions"].bool()
    actions = batch["actions"][:, :-1].long()
    reward = batch["reward"][:, :-1].float()
    term = batch["terminated"][:, :-1].float()
    mask = batch["filled"][:, :-1].float().clone()
    mask[:, 1:] = mask[:, 1:] * (1.0 - term[:, :-1])

    q = agent_q(p, x, sizes, mm)
    chosen = q[:, :-1].gather(3, actions[..., None]).squeeze(3)
    with torch.no_grad():
        q_target = agent_q(target, x, sizes, mm).masked_fill(~avail, UNAVAILABLE_Q)
        best = q.detach().masked_fill(~avail, UNAVAILABLE_Q).argmax(dim=3)
        target_qs = q_target.gather(3, best[..., None]).squeeze(3)
        target_tot = mix(target, target_qs, batch["state"], sizes, mm)
        targets = reward + sizes["gamma"] * (1.0 - term) * target_tot[:, 1:]
    chosen_tot = mix(p, chosen, batch["state"][:, :-1], sizes, mm)
    return (((chosen_tot - targets) * mask) ** 2).sum() / mask.sum()


def train(p0: Params, batches: Sequence, draws: Sequence, sizes, mm: MM):
    """Len(batches) updates from ``p0`` (the target networks stay at
    ``p0``); ``draws`` is unused (QMIX draws nothing). Returns (losses, the
    first update's clipped gradients, the parameters after the last
    update)."""
    del draws
    names = list(p0)
    params = {k: v.detach().clone() for k, v in p0.items()}
    target = {k: v.detach().clone() for k, v in p0.items()}
    square = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    alpha, eps, lr = sizes["optim_alpha"], sizes["optim_eps"], sizes["lr"]
    clip = float(sizes["grad_norm_clip"])
    for batch in batches:
        leaves = [params[k].requires_grad_(True) for k in names]
        value = loss(dict(zip(names, leaves)), target, batch, sizes, mm)
        grads = torch.autograd.grad(value, leaves)
        losses.append(value.detach())
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            if norm >= clip:
                grads = [g / norm * clip for g in grads]
            if first_grads is None:
                first_grads = dict(zip(names, grads))
            new = {}
            for k, g in zip(names, grads):
                square[k] = alpha * square[k] + (1.0 - alpha) * g * g
                new[k] = params[k].detach() - lr * g / (square[k].sqrt() + eps)
            params = new
    return losses, first_grads, params


def rollout_q(p: Params, batch, sizes, mm: MM) -> torch.Tensor:
    """The agent's Q (B, T+1, Na, A) over whole rollouts."""
    return agent_q(p, agent_inputs(batch, sizes["n_agents"]), sizes, mm)


def leaf_norms(tree: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}
