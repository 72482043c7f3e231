"""Operations and bytes of the flat path's train block (QMIX: ``BasicMAC``'s
``RNNAgent``, ``QMixer`` over the flat state), counted from a
configuration's sizes. ``costs.py`` counts the entity scheme's; the
kernels' arithmetic (``gru_cost``, ``bound_ms``) and the peaks are its own.

``block_calls`` lists every GRU kernel call of one train block;
``block_model_flops`` counts the model operations of one train block for
``flat_train_mfu``.
"""
from __future__ import annotations

from typing import List

from .costs import GruCall, bound_ms, gru_cost


def block_calls(sizes) -> List[GruCall]:
    """Every GRU call of one train block of QMIX: the rollout's agent step
    at each of ``episode_limit`` steps (``batch_size_run`` envs, T = 1),
    then ``training_iters`` updates, each the live agent's forward and
    backward and the target agent's forward over the sampled episodes
    (T = episode_limit + 1)."""
    B, bs, na = sizes["batch_size_run"], sizes["batch_size"], sizes["n_agents"]
    steps, it = sizes["episode_limit"], sizes["training_iters"]
    t1 = steps + 1
    return [GruCall("rollout", 1, B * na, False, steps),
            GruCall("agent", t1, bs * na, False, it),
            GruCall("agent", t1, bs * na, True, it),
            GruCall("target_agent", t1, bs * na, False, it)]


def launches_per_block(sizes) -> dict:
    """The GRU wrappers' launch counts one train block records."""
    out = {"gru_fwd": 0, "gru_bwd": 0}
    for c in block_calls(sizes):
        out["gru_bwd" if c.bwd else "gru_fwd"] += c.count
    return out


def block_bound_ms(sizes) -> float:
    """The summed bound of one train block's GRU calls (the recurrence is
    float32 whatever the dtype)."""
    return sum(c.count * bound_ms(*gru_cost(c.T, c.R, sizes["rnn_hidden_dim"],
                                            sizes["compute_dtype"], c.bwd), "float32")
               for c in block_calls(sizes))


def _agent_fwd(rows, sizes):
    """(forward flops, the first layer's forward flops) of the agent over
    ``rows`` agent rows: fc1, the GRU's input and recurrent products, fc2."""
    d = sizes["obs_shape"] + sizes["n_actions"] + sizes["n_agents"]
    h, a = sizes["rnn_hidden_dim"], sizes["n_actions"]
    fc1 = 2 * rows * d * h
    return fc1 + 2 * rows * (2 * h * 3 * h + h * a), fc1


def _mixer_fwd(n, sizes):
    """(forward flops, the first layers' forward flops) of the mixer over
    ``n`` (sample, step) rows: the four hypernets from the state
    (hyper_w_1 and hyper_w_final Linear -> ReLU -> Linear, hyper_b_1 one
    Linear, V Linear -> ReLU -> Linear to 1) and the two mixing products."""
    s, hy, m, na = (sizes["state_shape"], sizes["hypernet_embed"], sizes["mixing_embed_dim"],
                    sizes["n_agents"])
    first = 2 * n * s * (2 * hy + 2 * m)
    second = 2 * n * (hy * na * m + hy * m + m)
    mixing = 2 * n * (na * m + m)
    return first + second + mixing, first


def block_model_flops(sizes) -> float:
    """The model operations of one train block, as the model is written
    (none recomputed): the rollout's agent forward at each step, then per
    update the live agent's forward and backward over the sampled episodes'
    T + 1 steps, the target agent's forward over them, the live mixer's
    forward and backward over their T trained steps and the target mixer's
    forward over their T + 1. A backward costs twice its forward, less the
    first layers' input gradient, which nothing needs."""
    B, bs, na = sizes["batch_size_run"], sizes["batch_size"], sizes["n_agents"]
    steps = sizes["episode_limit"]
    t1 = steps + 1

    def fwd_bwd(total, first):
        return total + 2 * total - first

    rollout = steps * _agent_fwd(B * na, sizes)[0]
    agent = fwd_bwd(*_agent_fwd(bs * t1 * na, sizes))
    target_agent = _agent_fwd(bs * t1 * na, sizes)[0]
    live_mixer = fwd_bwd(*_mixer_fwd(bs * steps, sizes))
    target_mixer = _mixer_fwd(bs * t1, sizes)[0]
    return rollout + sizes["training_iters"] * (agent + target_agent + live_mixer + target_mixer)
