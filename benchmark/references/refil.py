"""Plain PyTorch REFIL: the agent, the mixer and one learner update, written
from the paper (Iqbal et al., "Randomized Entity-wise Factorization for
Multi-Agent Reinforcement Learning", ICML 2021, arXiv 2006.04222, §3-§4) and
its public reference code (``src/modules/agents/entity_rnn_agent.py``,
``src/modules/mixers/flex_qmix.py``, ``src/learners/q_learner.py``).

It imports torch alone. Every product goes through one ``mm`` function, so
that a control can run the same arithmetic with its products in a lower
precision (``benchmark/precision.py``); everything else is float32.

The model, for the sizes of one configuration (``sizes``):

* agent: fc1 -> ReLU -> multi-head attention over the entities (queries
  are the agents' rows; a blocked pair's logit is -1e9, a row that sees
  nothing gives zeros) -> output projection, zeroed for inactive agents ->
  fc2 -> ReLU -> GRU over the episode (flax gate order [r | z | n], no
  hidden bias on r and z) -> fc3 -> Q, zeroed for inactive agents. Its
  input is each entity's features with the agent's last action one-hot in
  the agents' rows;
* REFIL's imagined pass: one random bipartition of the entities per
  episode (``group_probs`` ~ U(0, 1), ``groupA`` ~ Bernoulli(p) per
  entity), on the first step's activity; the agent runs three times, with
  the observation mask, with the within-group mask and with the
  across-group mask;
* mixer (QMIX with attention hypernets): hyper_w_1 (per agent), hyper_b_1,
  hyper_w_final (mean over agents) and V (mean over agents and features);
  softmax mixing weights over the embedding, ELU hidden layer. On the
  imagined path hyper_w_1 runs with the within and the across mask, and
  the 2 Na imagined Qs mix against one b_1, w_final and V;
* update: double-Q one-step targets from the target networks, the masked
  TD loss mixed with the imagined loss by ``lmbda``, the gradients clipped
  to a global norm of ``grad_norm_clip`` (left alone below it), RMSprop
  (``alpha``, ``eps`` outside the square root, no momentum).

Parameters are a dict of named float32 tensors; a name and a layout say
what the leaf is in the model (a Linear's ``weight`` is (out, in); an
attention's ``in_trans`` is (in, 3 E) and ``out_kernel`` (E, out); a GRU's
kernels are (in, H)).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

BLOCKED_LOGIT = -1e9
UNAVAILABLE_Q = -9999999.0
HYPERNETS = ("hyper_w_1", "hyper_w_final", "hyper_b_1", "V")


# ------------------------------------------------------------------ parameters
def _linear_leaves(prefix: str, fan_in: int, fan_out: int):
    bound = 1.0 / math.sqrt(fan_in)
    return [(f"{prefix}.weight", (fan_out, fan_in), bound), (f"{prefix}.bias", (fan_out,), bound)]


def _attention_leaves(prefix: str, width: int):
    bound = 1.0 / math.sqrt(width)
    return [(f"{prefix}.in_trans", (width, 3 * width), bound),
            (f"{prefix}.out_kernel", (width, width), bound),
            (f"{prefix}.out_bias", (width,), bound)]


def param_leaves(sizes) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, init bound) of every leaf, the agent's then the mixer's."""
    d_in = sizes["entity_shape"] + sizes["n_actions"]
    e, h, a = sizes["attn_embed_dim"], sizes["rnn_hidden_dim"], sizes["n_actions"]
    hy, m = sizes["hypernet_embed"], sizes["mixing_embed_dim"]
    out = _linear_leaves("agent.fc1", d_in, e) + _attention_leaves("agent.attn", e)
    out += _linear_leaves("agent.fc2", e, h)
    gb = 1.0 / math.sqrt(h)
    for gate in ("ir", "iz", "in", "hr", "hz", "hn"):
        out.append((f"agent.gru.{gate}.kernel", (h, h), gb))
        if gate not in ("hr", "hz"):
            out.append((f"agent.gru.{gate}.bias", (h,), gb))
    out += _linear_leaves("agent.fc3", h, a)
    for net in HYPERNETS:
        out += _linear_leaves(f"mixer.{net}.fc1", d_in, hy)
        out += _attention_leaves(f"mixer.{net}.attn", hy)
        out += _linear_leaves(f"mixer.{net}.fc2", hy, m)
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


def _attention(p: Params, prefix: str, x: torch.Tensor, blocked: torch.Tensor,
               inactive_query: torch.Tensor, n_heads: int, mm: MM) -> torch.Tensor:
    """x (N, Ne, W); blocked (N, Nq, Ne) bool; inactive_query (N, Nq) bool;
    the first Nq entities query. Returns (N, Nq, W)."""
    n, ne, _ = x.shape
    nq = inactive_query.shape[1]
    w_in = p[prefix + ".in_trans"]
    e = w_in.shape[1] // 3
    hd = e // n_heads
    q = mm(x[:, :nq], w_in[:, :e]).reshape(n, nq, n_heads, hd).transpose(1, 2)
    k = mm(x, w_in[:, e:2 * e]).reshape(n, ne, n_heads, hd).transpose(1, 2)
    v = mm(x, w_in[:, 2 * e:]).reshape(n, ne, n_heads, hd).transpose(1, 2)
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    logits = logits.masked_fill(blocked[:, None], BLOCKED_LOGIT)
    weights = torch.softmax(logits, dim=-1)
    weights = weights.masked_fill(blocked.all(-1)[:, None, :, None], 0.0)
    att = mm(weights, v).transpose(1, 2).reshape(n, nq, e)
    out = mm(att, p[prefix + ".out_kernel"]) + p[prefix + ".out_bias"]
    return out.masked_fill(inactive_query[..., None], 0.0)


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
    """Entities (B, T, Ne, D) with the last action's one-hot (zeros at t = 0)
    in the agents' rows."""
    ents, ao = batch["entities"].float(), batch["actions_onehot"].float()
    last = torch.cat([torch.zeros_like(ao[:, :1]), ao[:, :-1]], dim=1)
    pad = ents.new_zeros(ents.shape[:3] + (ao.shape[-1],))
    pad[:, :, :n_agents] = last
    return torch.cat([ents, pad], dim=-1)


def agent_q(p: Params, x: torch.Tensor, blocked: torch.Tensor, entity_mask: torch.Tensor,
            sizes, mm: MM) -> torch.Tensor:
    """x (B, T, Ne, D); blocked (B, T, Ne or Na, Ne); entity_mask (B, T, Ne)
    -> Q (B, T, Na, A)."""
    b, t, ne, d = x.shape
    na, h = sizes["n_agents"], sizes["rnn_hidden_dim"]
    inactive = entity_mask[..., :na].reshape(b * t, na)
    x1 = torch.relu(_linear(p, "agent.fc1", x.reshape(b * t, ne, d), mm))
    x2 = _attention(p, "agent.attn", x1, blocked.reshape(b * t, -1, ne)[:, :na], inactive,
                    sizes["attn_n_heads"], mm)
    x3 = torch.relu(_linear(p, "agent.fc2", x2, mm))
    x3 = x3.reshape(b, t, na, h).transpose(1, 2).reshape(b * na, t, h)
    hs = _gru(p, x3, mm).reshape(b, na, t, h).transpose(1, 2)
    q = _linear(p, "agent.fc3", hs, mm)
    return q.masked_fill(entity_mask[..., :na, None], 0.0)


def _pair_blocked(inactive: torch.Tensor, rows: int) -> torch.Tensor:
    """(..., Ne) inactive -> (..., rows, Ne): a pair is blocked unless both
    its entities are active."""
    act = ~inactive
    return ~(act[..., :rows, None] & act[..., None, :])


def imagined_masks(obs_mask, entity_mask, group_probs, group_a):
    """REFIL's random bipartition, on the first step's activity: the agent's
    within-group and across-group masks (with the observation mask) and the
    mixer's (without it), each (B, T, Ne, Ne) bool, blocked = True."""
    del group_probs  # groupA was drawn with it; the masks need groupA alone
    b, t, ne = entity_mask.shape
    em0 = entity_mask[:, :1]
    in_a = group_a.bool() | em0
    in_b = (~group_a.bool()) | em0
    same = ~_pair_blocked(in_a, ne) | ~_pair_blocked(in_b, ne)
    within, across = ~same, same
    active0 = _pair_blocked(em0, ne)
    return (within | obs_mask, across | obs_mask, (within | active0).expand(b, t, ne, ne),
            (across | active0).expand(b, t, ne, ne))


def _hypernet(p: Params, net: str, ents, entity_mask, blocked, sizes, mm: MM):
    """ents (N, Ne, D) -> per-agent outputs (N, Na, M), zeroed for inactive agents."""
    na = sizes["n_agents"]
    inactive = entity_mask[:, :na]
    if blocked is None:
        blocked = _pair_blocked(entity_mask, na)
    x1 = torch.relu(_linear(p, f"mixer.{net}.fc1", ents, mm))
    x2 = _attention(p, f"mixer.{net}.attn", x1, blocked[:, :na], inactive,
                    sizes["attn_n_heads"], mm)
    return _linear(p, f"mixer.{net}.fc2", x2, mm).masked_fill(inactive[..., None], 0.0)


def mix(p: Params, qs, ents, entity_mask, sizes, mm: MM, imagined=None):
    """qs (B, T, Na) or (B, T, 2 Na) on the imagined path, with
    ``imagined`` = (within, across) mixer masks (B, T, Ne, Ne) -> (B, T, 1)."""
    b, t, ne, d = ents.shape
    n = b * t
    x, em = ents.reshape(n, ne, d), entity_mask.reshape(n, ne)
    if imagined is None:
        w1 = _hypernet(p, "hyper_w_1", x, em, None, sizes, mm)
    else:
        w1 = torch.cat([_hypernet(p, "hyper_w_1", x, em, m.reshape(n, ne, ne), sizes, mm)
                        for m in imagined], dim=1)
    b1 = _hypernet(p, "hyper_b_1", x, em, None, sizes, mm).mean(dim=1)
    w_final = torch.softmax(_hypernet(p, "hyper_w_final", x, em, None, sizes, mm).mean(dim=1),
                            dim=-1)
    v = _hypernet(p, "V", x, em, None, sizes, mm).mean(dim=(1, 2))
    hidden = F.elu(mm(qs.reshape(n, 1, -1), torch.softmax(w1, dim=-1)) + b1[:, None])
    y = mm(hidden, w_final[..., None]).reshape(n) + v
    return y.reshape(b, t, 1)


def loss(p: Params, target: Params, batch, draws, sizes, mm: MM) -> torch.Tensor:
    """The REFIL loss of one update on ``batch`` (B, T+1, ...) with the
    bipartition ``draws`` = (group_probs, groupA)."""
    na = sizes["n_agents"]
    x = agent_inputs(batch, na)
    om, em = batch["obs_mask"].bool(), batch["entity_mask"].bool()
    avail = batch["avail_actions"].bool()
    actions = batch["actions"][:, :-1].long()
    reward = batch["reward"][:, :-1].float()
    term = batch["terminated"][:, :-1].float()
    mask = batch["filled"][:, :-1].float().clone()
    mask[:, 1:] = mask[:, 1:] * (1.0 - term[:, :-1])

    w_obs, a_obs, w_mix, a_mix = imagined_masks(om, em, *draws)
    q3 = agent_q(p, torch.cat([x] * 3), torch.cat([om, w_obs, a_obs]), torch.cat([em] * 3),
                 sizes, mm)
    q_full, q_within, q_across = q3.chunk(3, dim=0)
    pick = lambda q: q[:, :-1].gather(3, actions[..., None]).squeeze(3)  # noqa: E731
    chosen = pick(q_full)
    imagined = torch.cat([pick(q_within), pick(q_across)], dim=2)

    with torch.no_grad():
        q_target = agent_q(target, x, om, em, sizes, mm).masked_fill(~avail, UNAVAILABLE_Q)
        best = q_full.detach().masked_fill(~avail, UNAVAILABLE_Q).argmax(dim=3)
        target_qs = q_target.gather(3, best[..., None]).squeeze(3)
        target_tot = mix(target, target_qs, x, em, sizes, mm)
        targets = reward + sizes["gamma"] * (1.0 - term) * target_tot[:, 1:]

    live_x, live_em = x[:, :-1], em[:, :-1]
    chosen_tot = mix(p, chosen, live_x, live_em, sizes, mm)
    imagined_tot = mix(p, imagined, live_x, live_em, sizes, mm,
                       imagined=(w_mix[:, :-1], a_mix[:, :-1]))
    count = mask.sum()
    td = (((chosen_tot - targets) * mask) ** 2).sum() / count
    im = (((imagined_tot - targets) * mask) ** 2).sum() / count
    return (1.0 - sizes["lmbda"]) * td + sizes["lmbda"] * im


def train(p0: Params, batches: Sequence, draws: Sequence, sizes, mm: MM):
    """Len(batches) updates from ``p0`` (the target networks stay at
    ``p0``). Returns (losses, the first update's clipped gradients, the
    parameters after the last update)."""
    names = list(p0)
    params = {k: v.detach().clone() for k, v in p0.items()}
    target = {k: v.detach().clone() for k, v in p0.items()}
    square = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    alpha, eps, lr = sizes["optim_alpha"], sizes["optim_eps"], sizes["lr"]
    clip = float(sizes["grad_norm_clip"])
    for batch, draw in zip(batches, draws):
        leaves = [params[k].requires_grad_(True) for k in names]
        value = loss(dict(zip(names, leaves)), target, batch, draw, sizes, mm)
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
    """The agent's Q (B, T+1, Na, A) over whole rollouts, the full view."""
    return agent_q(p, agent_inputs(batch, sizes["n_agents"]), batch["obs_mask"].bool(),
                   batch["entity_mask"].bool(), sizes, mm)


def leaf_norms(tree: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}
