"""Masked entity-set attention: the plain PyTorch versions.

Port of ``refil_tpu/ops/attention.py:56-191``. These functions are the plain
version of the CUDA kernel in ``ops/entity_attn.py``: the CPU path and the
tests run them, and ``chip_smoke.py`` holds the kernel against them on the
card. Gradients come from autograd.

Semantics:
  * blocked pairs get a logit of -1e9 (finite), and rows whose pre-mask blocks
    every entity produce exactly zero (the reference's NaN->0), never NaN;
  * logits, softmax and both attention products accumulate in float32 even
    for bfloat16 inputs; the softmax weights and the attention output are
    rounded to the input dtype, as in the JAX package;
  * the softmax scale is the Python float ``1/sqrt(hd)`` of the Pallas kernel
    (``pallas_attn.py:104``). The JAX XLA path rounds it to the query dtype
    (``attention.py:80``); the two agree exactly in float32 and for every
    head width that is a power of 4, and differ by at most one bfloat16
    rounding of the scale otherwise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG = -1e9  # logit of a blocked pair


def masked_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    pre_mask: Optional[torch.Tensor],
    n_heads: int,
    ret_logits: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Multi-head scaled dot-product attention with a blocking pre-mask.

    query (B, Nq, E); key, value (B, Ne, E); pre_mask (B, Nq, Ne) bool or
    None. Returns (out (B, Nq, E), unmasked per-head logits (B, H, Nq, Ne) or
    None).
    """
    B, Nq, E = query.shape
    Ne = key.shape[1]
    hd = E // n_heads
    scale = 1.0 / math.sqrt(hd)

    q = query.reshape(B, Nq, n_heads, hd).transpose(1, 2).float()
    k = key.reshape(B, Ne, n_heads, hd).transpose(1, 2).float()
    v = value.reshape(B, Ne, n_heads, hd).transpose(1, 2)

    logits = torch.matmul(q, k.transpose(-1, -2)) * scale  # (B,H,Nq,Ne) f32
    if pre_mask is not None:
        m = pre_mask[:, None, :, :]
        weights = torch.softmax(logits.masked_fill(m, NEG), dim=-1)
        all_blocked = pre_mask.all(dim=-1)[:, None, :, None]
        weights = weights.masked_fill(all_blocked, 0.0)
    else:
        weights = torch.softmax(logits, dim=-1)

    out = torch.matmul(weights.to(v.dtype).float(), v.float()).to(query.dtype)
    out = out.transpose(1, 2).reshape(B, Nq, E)
    return out, (logits if ret_logits else None)


def entity_attention(
    entities: torch.Tensor,
    in_kernel: torch.Tensor,
    out_kernel: torch.Tensor,
    out_bias: torch.Tensor,
    pre_mask: Optional[torch.Tensor],
    post_mask: torch.Tensor,
    n_heads: int,
    ret_attn_logits: Optional[str] = None,
):
    """Fused QKV projection -> masked MHA -> output projection -> post-mask.

    entities (B, Ne, D); in_kernel (D, 3E); out_kernel (E, O); out_bias (O,);
    pre_mask (B, >=Nq, Ne) bool or None (rows beyond Nq are ignored);
    post_mask (B, Nq) bool, whose second dim sets the number of queries Nq and
    whose True rows are zeroed. ``ret_attn_logits`` None | 'max' | 'mean' also
    returns head-reduced unmasked logits (B, Nq, Ne).
    """
    n_queries = post_mask.shape[1]
    E = in_kernel.shape[1] // 3
    qkv = entities @ in_kernel
    query = qkv[:, :n_queries, :E]
    key = qkv[..., E:2 * E]
    value = qkv[..., 2 * E:]

    pm = None if pre_mask is None else pre_mask[:, :n_queries]
    out, logits = masked_attention(query, key, value, pm, n_heads,
                                   ret_logits=ret_attn_logits is not None)
    out = out @ out_kernel + out_bias
    out = out.masked_fill(post_mask[..., None], 0.0)

    if ret_attn_logits is not None:
        if ret_attn_logits == "max":
            logits = logits.max(dim=1).values
        else:  # 'mean' / 'norm' both reduce by mean in the reference
            logits = logits.mean(dim=1)
        return out, logits
    return out


class ForwardStages(NamedTuple):
    """What ``entity_attention_forward_staged`` returns: the planes in the
    type they are stored in, their values rounded to the inputs' dtype."""
    out: torch.Tensor  # (B, Nq, O) in the inputs' dtype
    q: torch.Tensor  # (B, Nq, E) plane
    kv: torch.Tensor  # (B, Ne, 2E) plane
    weights: torch.Tensor  # (B, H, Nq, Ne) f32 softmax
    attn: torch.Tensor  # (B, Nq, E) plane, row_ok applied
    row_ok: torch.Tensor  # (B, Nq) f32: 0 where the pre-mask blocks the whole row


def entity_attention_forward_staged(
    entities: torch.Tensor,
    in_kernel: torch.Tensor,
    out_kernel: torch.Tensor,
    out_bias: Optional[torch.Tensor],
    pre_mask: Optional[torch.Tensor],
    post_mask: torch.Tensor,
    n_heads: int,
    plane_dtype: Optional[torch.dtype] = None,
) -> ForwardStages:
    """``entity_attention`` computed in the stages of the CUDA forward
    (``csrc/entity_attn.cu``, ``launch_fwd``), so that each stage has a
    plain counterpart. The planes between the stages (Q, K|V, attn) are
    stored in ``plane_dtype``: None, the inputs' dtype, as the kernels store
    them; float32 keeps them in f32, which changes no value (each holds
    values already rounded to the inputs' dtype):

      (i)   K|V = ents W_kv over all Ne rows, Q = ents[:, :Nq] W_q over the
            query rows only;
      (ii)  per sample and head: the scores, blocked pairs at -1e9, the f32
            softmax, attn = round(w) v * row_ok;
      (iii) out = (attn W_o + b_o) * post_keep in the inputs' dtype
            (``out_bias`` None: no bias).

    Every product accumulates in float32; values are rounded to the inputs'
    dtype where ``refil_tpu/ops/pallas_attn.py:_kernel`` rounds them (qkv,
    the softmax weights fed to w v, attn, out)."""
    cdt = entities.dtype
    rnd = lambda x: x.to(cdt).float()  # noqa: E731
    plane = lambda x: x.to(plane_dtype or cdt)  # noqa: E731  (a stored plane)
    B = entities.shape[0]
    Nq = post_mask.shape[1]
    E = in_kernel.shape[1] // 3
    hd = E // n_heads
    scale = 1.0 / math.sqrt(hd)
    x, w_qkv = entities.float(), in_kernel.float()
    heads = lambda t: t.reshape(B, t.shape[1], n_heads, hd).transpose(1, 2)  # noqa: E731

    # (i) projections
    kv = plane(rnd(x @ w_qkv[:, E:]))
    q = plane(rnd(x[:, :Nq] @ w_qkv[:, :E]))

    # (ii) the attention, per sample and head
    pm = None if pre_mask is None else pre_mask[:, :Nq]
    row_ok = (torch.ones((B, Nq)) if pm is None else (~pm.all(-1)).float()).to(x.device)
    logits = heads(q.float()) @ heads(kv[..., :E].float()).transpose(-1, -2) * scale
    if pm is not None:
        logits = logits.masked_fill(pm[:, None], NEG)
    w = torch.softmax(logits, dim=-1)  # (B, H, Nq, Ne) f32
    attn = (rnd(w) @ heads(kv[..., E:].float())).transpose(1, 2).reshape(B, Nq, E)
    attn = plane(rnd(attn * row_ok[..., None]))

    # (iii) the output projection, bias and post-mask in its epilogue
    out = attn.float() @ out_kernel.float()
    if out_bias is not None:
        out = out + out_bias.float()
    out = out.masked_fill(post_mask[..., None], 0.0).to(cdt)
    return ForwardStages(out, q, kv, w, attn, row_ok)


class BackwardStages(NamedTuple):
    """What ``entity_attention_backward_staged`` returns, float32."""
    d_entities: torch.Tensor  # (B, Ne, D)
    d_in_kernel: torch.Tensor  # (D, 3E)
    d_out_kernel: torch.Tensor  # (E, O)
    d_out_bias: torch.Tensor  # (O,)
    attn: torch.Tensor  # (B, Nq, E): the recomputed attention, row_ok applied


def entity_attention_backward_staged(
    entities: torch.Tensor,
    in_kernel: torch.Tensor,
    out_kernel: torch.Tensor,
    pre_mask: Optional[torch.Tensor],
    post_mask: torch.Tensor,
    g: torch.Tensor,
    n_heads: int,
    plane_dtype: Optional[torch.dtype] = None,
) -> BackwardStages:
    """The gradients of ``entity_attention`` for the output gradient ``g``,
    computed in the stages of the CUDA backward (``csrc/entity_attn.cu``,
    ``launch_bwd``), so that each stage has a plain counterpart. The planes
    between the stages (Q then dq, K|V then dK|dV, dattn then attn, g
    post_keep) are stored in ``plane_dtype`` as the forward's are (None: the
    inputs' dtype, as the kernels store them):

      (i)   K|V, Q and the attention as ``entity_attention_forward_staged``
            forms them, dattn = g W_o^T;
      (ii)  per sample: dv, the softmax VJP, dq, dk;
      (iii) dEnts = dK|dV W_kv^T + dq W_q^T (on the query rows), dW_qkv,
            dW_o = attn^T (g post_keep), db_o.

    Every product accumulates in float32; values are rounded to the inputs'
    dtype where ``refil_tpu/ops/pallas_attn.py:_bwd_kernel`` rounds them
    (qkv, the softmax weights fed to products, dattn, attn, dl, dqkv)."""
    cdt = entities.dtype
    rnd = lambda x: x.to(cdt).float()  # noqa: E731
    plane = lambda x: x.to(plane_dtype or cdt)  # noqa: E731  (a stored plane)
    B, Ne, D = entities.shape
    Nq = post_mask.shape[1]
    E = in_kernel.shape[1] // 3
    hd = E // n_heads
    scale = 1.0 / math.sqrt(hd)
    x, w_qkv, w_o = entities.float(), in_kernel.float(), out_kernel.float()
    heads = lambda t: t.reshape(B, t.shape[1], n_heads, hd).transpose(1, 2)  # noqa: E731
    merge = lambda t: t.transpose(1, 2).reshape(B, t.shape[2], E)  # noqa: E731

    # (i) the recomputed forward and dattn
    fwd = entity_attention_forward_staged(entities, in_kernel, out_kernel, None, pre_mask,
                                          post_mask, n_heads, plane_dtype)
    w, row_ok = fwd.weights, fwd.row_ok
    q, kv, attn = fwd.q.float(), fwd.kv.float(), fwd.attn.float()
    # dattn = g W_o^T as stored: in the inputs' dtype it is rounded before
    # the row mask below, which is 0 or 1, so that rounding changes no value
    dattn_raw = plane(g.to(cdt).float() @ w_o.T).float()

    # (ii) the attention's VJP, per sample
    post_keep = (~post_mask).float()
    dattn = rnd(dattn_raw * (post_keep * row_ok)[..., None])
    qh, kh, vh = heads(q), heads(kv[..., :E]), heads(kv[..., E:])
    dah = heads(dattn)
    dv = rnd(rnd(w).transpose(-1, -2) @ dah)
    dw = dah @ vh.transpose(-1, -2)
    dl = rnd(w * (dw - (dw * w).sum(-1, keepdim=True)))
    dq = plane(rnd(merge(dl @ kh) * scale)).float()
    dk = rnd(merge(dl.transpose(-1, -2) @ qh) * scale)
    dkv = plane(torch.cat([dk, merge(dv)], dim=-1)).float()
    gm = plane(g.to(cdt).float() * post_keep[..., None]).float()

    # (iii) dEnts and the weight gradients
    d_ents = dkv @ w_qkv[:, E:].T
    d_ents[:, :Nq] += dq @ w_qkv[:, :E].T
    dw_q = x[:, :Nq].reshape(-1, D).T @ dq.reshape(-1, E)
    dw_kv = x.reshape(-1, D).T @ dkv.reshape(-1, 2 * E)
    dw_o = attn.reshape(-1, E).T @ gm.reshape(-1, gm.shape[-1])
    return BackwardStages(d_ents, torch.cat([dw_q, dw_kv], dim=1), dw_o, gm.sum((0, 1)), attn)


def entity_pooling(
    entities: torch.Tensor,
    in_kernel: torch.Tensor,
    in_bias: torch.Tensor,
    out_kernel: torch.Tensor,
    out_bias: torch.Tensor,
    pre_mask: Optional[torch.Tensor],
    post_mask: torch.Tensor,
    pooling_type: str,
):
    """Masked max/mean pooling ablation of the attention layer, with the
    reference's quirks: masked entries are zeroed (not -inf) before the max,
    and the mean divides by the total entity count Ne."""
    n_queries = post_mask.shape[1]
    x = entities @ in_kernel + in_bias  # (B, Ne, E)
    rep = x[:, None].expand(x.shape[0], n_queries, x.shape[1], x.shape[2])
    if pre_mask is not None:
        pm = pre_mask[:, :n_queries]
        rep = rep.masked_fill(pm[..., None], 0.0)
    if pooling_type == "max":
        pooled = rep.max(dim=2).values
    elif pooling_type == "mean":
        pooled = rep.mean(dim=2)
    else:
        raise ValueError(f"Unknown pooling_type {pooling_type}")
    out = pooled @ out_kernel + out_bias
    return out.masked_fill(post_mask[..., None], 0.0)
