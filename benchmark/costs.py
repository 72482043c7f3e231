"""Operations and bytes, counted from shapes, and the card's peaks.

The kernels' arithmetic (``attention_cost``, ``gru_cost``, ``bound_ms``) is a
frozen copy of ``chip_smoke.py``'s ``cost``, ``gru_cost`` and ``bound``, with
one correction: the GRU's recurrent product is float32 whatever the input
dtype (``refil_torch/ops/gru.py``), so its operations are bounded by the
float32 peak. ``block_calls`` derives every kernel call of one train block
from a configuration's sizes; ``block_model_flops`` counts the model
operations of one train block for ``train_mfu``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def attention_cost(Bp, Ne, Nq, D, E, O, dtype: str, bwd: bool):
    """(bytes, flops) one entity-attention call needs: each input read once,
    each output written once; multiply-adds count 2 operations. K and V are
    projected for all Ne rows, Q only for the Nq rows that query; every
    call has a pre-mask. The backward recomputes the forward from its
    inputs (it is handed no activations)."""
    b = ELEMENT_BYTES[dtype]
    weights = (D * 3 * E + E * O + O) * b
    masks = Bp * Nq * Ne + Bp * Nq
    qkv = 2 * Bp * (Ne * 2 * E + Nq * E) * D
    scores = 2 * 2 * Bp * Nq * Ne * E  # q k^T and w v
    proj = 2 * Bp * Nq * E * O
    if not bwd:
        return Bp * Ne * D * b + weights + masks + Bp * Nq * O * b, qkv + scores + proj
    reads = Bp * Ne * D * b + Bp * Nq * O * b + weights + masks
    writes = Bp * Ne * D * 4 + (D * 3 * E + E * O + O) * 4
    flops = qkv + scores + 2 * proj + 2 * scores + 2 * qkv  # recompute + VJPs
    return reads + writes, flops


def gru_cost(T, R, H, dtype: str, bwd: bool):
    """(bytes, flops) of the GRU recurrence: each input read once, each
    output written once; the operations are the recurrent products'
    multiply-adds (the gates' elementwise work, under 5%, is not counted):
    h @ W_h per step forward; backward, its recomputation, dgh @ W_h^T and
    h^T @ dgh."""
    b = ELEMENT_BYTES[dtype]
    weights = (H * 3 * H + H) * 4
    product = 2 * T * R * H * 3 * H
    if not bwd:
        return T * R * 3 * H * b + weights + R * H * 4 + T * R * H * b, product
    reads = T * R * 3 * H * b + 2 * T * R * H * b + R * H * 4 + weights
    writes = T * R * 3 * H * 4 + weights + R * H * 4
    return reads + writes, 3 * product


def bound_ms(nbytes: float, flops: float, flops_dtype: str) -> float:
    """The least time the card could take: the larger of bytes over peak
    bandwidth and operations over the peak of ``flops_dtype``."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[flops_dtype]) * 1e3


class AttnCall(NamedTuple):
    tag: str
    Bp: int
    Ne: int
    Nq: int
    width: int
    bwd: bool
    count: int  # calls of this shape in one train block


class GruCall(NamedTuple):
    tag: str
    T: int
    R: int
    bwd: bool
    count: int


def block_calls(sizes) -> Dict[str, List]:
    """Every entity-attention and GRU call of one train block of REFIL
    (``imagine_entity_attend_rnn`` agent, ``flex_qmix`` mixer) on the entity
    scheme: the rollout's agent step at each of ``episode_limit`` steps
    (``batch_size_run`` envs, T = 1), then ``training_iters`` updates: the
    agent x3 over the sampled episodes (forward and backward), the target
    agent (forward), the live mixer's hypernets on the trained steps (4 on
    the chosen Qs, 5 on the imagined ones: hyper_w_1 twice) and the target
    mixer's 4 on all steps."""
    B, bs = sizes["batch_size_run"], sizes["batch_size"]
    steps, na, ne = sizes["episode_limit"], sizes["n_agents"], sizes["n_entities"]
    t1, it = steps + 1, sizes["training_iters"]
    w, hw = sizes["attn_embed_dim"], sizes["hypernet_embed"]
    attn = [AttnCall("rollout", B, ne, na, w, False, steps),
            AttnCall("agent_x3", 3 * bs * t1, ne, na, w, False, it),
            AttnCall("agent_x3", 3 * bs * t1, ne, na, w, True, it),
            AttnCall("target_agent", bs * t1, ne, na, w, False, it),
            AttnCall("mixer", bs * steps, ne, na, hw, False, 9 * it),
            AttnCall("mixer", bs * steps, ne, na, hw, True, 9 * it),
            AttnCall("target_mixer", bs * t1, ne, na, hw, False, 4 * it)]
    gru = [GruCall("rollout", 1, B * na, False, steps),
           GruCall("agent_x3", t1, 3 * bs * na, False, it),
           GruCall("agent_x3", t1, 3 * bs * na, True, it),
           GruCall("target_agent", t1, bs * na, False, it)]
    return {"attention": attn, "gru": gru}


def launches_per_block(sizes) -> Dict[str, int]:
    """The kernel wrappers' launch counts one train block records."""
    calls = block_calls(sizes)
    out = {"entity_attn_fwd": 0, "entity_attn_bwd": 0, "gru_fwd": 0, "gru_bwd": 0}
    for c in calls["attention"]:
        out["entity_attn_bwd" if c.bwd else "entity_attn_fwd"] += c.count
    for c in calls["gru"]:
        out["gru_bwd" if c.bwd else "gru_fwd"] += c.count
    return out


def block_bound_ms(sizes, dtype: str) -> Dict[str, float]:
    """The summed bound of one train block's calls, by kernel."""
    calls = block_calls(sizes)
    attn = sum(c.count * bound_ms(*attention_cost(c.Bp, c.Ne, c.Nq, c.width, c.width,
                                                  c.width, dtype, c.bwd), dtype)
               for c in calls["attention"])
    gru = sum(c.count * bound_ms(*gru_cost(c.T, c.R, sizes["rnn_hidden_dim"], dtype, c.bwd),
                                 "float32")
              for c in calls["gru"])
    return {"attention": attn, "gru": gru}


def _agent_fwd(n, sizes):
    """(forward flops, the first layer's forward flops) of the agent over
    n (sample, step) rows of Ne entities."""
    ne, na = sizes["n_entities"], sizes["n_agents"]
    d = sizes["entity_shape"] + sizes["n_actions"]
    e, h, a = sizes["attn_embed_dim"], sizes["rnn_hidden_dim"], sizes["n_actions"]
    fc1 = 2 * n * ne * d * e
    attn = attention_cost(n, ne, na, e, e, e, "float32", False)[1]
    rest = 2 * n * na * (e * h + 2 * h * 3 * h + h * a)  # fc2, GRU's two products, fc3
    return fc1 + attn + rest, fc1


def _hypernet_fwd(n, sizes):
    ne, na = sizes["n_entities"], sizes["n_agents"]
    d = sizes["entity_shape"] + sizes["n_actions"]
    hy, m = sizes["hypernet_embed"], sizes["mixing_embed_dim"]
    fc1 = 2 * n * ne * d * hy
    attn = attention_cost(n, ne, na, hy, hy, hy, "float32", False)[1]
    return fc1 + attn + 2 * n * na * hy * m, fc1


def block_model_flops(sizes) -> float:
    """The model operations of one train block, as the model is written
    (none recomputed): the rollout's agent forward at each step, then per
    update the agent x3 forward and backward, the target agent's forward,
    the live mixer (4 hypernets on the chosen Qs, 5 on the imagined ones,
    and their mixing products) forward and backward, and the target mixer
    (4 hypernets) forward. A backward costs twice its forward, less the
    first layer's input gradient, which nothing needs."""
    B, bs = sizes["batch_size_run"], sizes["batch_size"]
    steps, na, m = sizes["episode_limit"], sizes["n_agents"], sizes["mixing_embed_dim"]
    t1 = steps + 1
    rollout = steps * _agent_fwd(B, sizes)[0]

    def fwd_bwd(total, first):
        return total + 2 * total - first

    agent = fwd_bwd(*_agent_fwd(3 * bs * t1, sizes))
    target_agent = _agent_fwd(bs * t1, sizes)[0]
    n = bs * steps
    hyper, first = _hypernet_fwd(n, sizes)
    mixing = 2 * n * (na * m + m) + 2 * n * (2 * na * m + m)
    live_mixer = fwd_bwd(9 * hyper + mixing, 9 * first)
    target_mixer = 4 * _hypernet_fwd(bs * t1, sizes)[0] + 2 * bs * t1 * (na * m + m)
    update = agent + target_agent + live_mixer + target_mixer
    return rollout + sizes["training_iters"] * update
