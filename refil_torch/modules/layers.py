"""Parameterized layers, port of ``refil_tpu/modules/layers.py``.

Initialization reproduces torch's ``nn.Linear`` default,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and bias, drawn from an
explicit ``torch.Generator``. The attention and pooling layers keep their
weights in the JAX layout (``in_trans`` (D, 3E), ``out_kernel`` (E, O),
``out_bias`` (O,)), which is also the layout at the kernel's interface.
"""
from __future__ import annotations

import logging
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import entity_attention, entity_pooling
from ..ops.entity_attn import entity_attention as kernel_entity_attention
from ..ops.gru import gru_sequence
from ..ops.gru_kernel import gru_sequence as kernel_gru_sequence

_log = logging.getLogger("refil_torch")
_logged_plain_choice = set()


def _uniform(shape, fan_in: int, generator: Optional[torch.Generator],
             bound: Optional[float] = None) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in) if bound is None else bound
    t = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


class TorchLinear(nn.Module):
    """Dense layer with torch-default init; ``weight`` is (out, in) as in
    ``nn.Linear``. Computes in the input's dtype."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _uniform((out_features, in_features), in_features, generator)
        self.bias = _uniform((out_features,), in_features, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def _log_plain_choice(key: str, what: str) -> None:
    if key not in _logged_plain_choice:
        _logged_plain_choice.add(key)
        _log.info("%s=False: %s runs its plain PyTorch version instead of the CUDA kernel",
                  key, what)


class EntityAttentionLayer(nn.Module):
    """Set-attention over entities where only the first ``post_mask.shape[1]``
    entities form queries.

    ``use_kernel`` (the config's ``use_pallas_attention``) routes through
    ``ops.entity_attn.entity_attention``: the CUDA kernels on a CUDA tensor,
    the plain version on a CPU tensor. ``use_kernel=False`` is the user's
    explicit choice of the plain version everywhere. ``ret_attn_logits``
    always takes the plain version, as the kernel does not emit logits.
    """

    def __init__(self, in_dim: int, embed_dim: int, out_dim: int, n_heads: int,
                 dtype: Optional[torch.dtype] = None, use_kernel: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.in_trans = _uniform((in_dim, 3 * embed_dim), in_dim, generator)
        self.out_kernel = _uniform((embed_dim, out_dim), embed_dim, generator)
        self.out_bias = _uniform((out_dim,), embed_dim, generator)

    def forward(self, entities, pre_mask=None, post_mask=None, ret_attn_logits=None):
        dt = self.dtype or entities.dtype
        args = (entities.to(dt), self.in_trans.to(dt), self.out_kernel.to(dt),
                self.out_bias.to(dt), pre_mask, post_mask, self.n_heads)
        if ret_attn_logits is None and self.use_kernel:
            return kernel_entity_attention(*args)
        if not self.use_kernel:
            _log_plain_choice("use_pallas_attention", "entity attention")
        return entity_attention(*args, ret_attn_logits=ret_attn_logits)


class EntityPoolingLayer(nn.Module):
    """Masked max/mean pooling ablation of the attention layer."""

    def __init__(self, in_dim: int, embed_dim: int, out_dim: int, pooling_type: str,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pooling_type = pooling_type
        self.dtype = dtype
        self.in_kernel = _uniform((in_dim, embed_dim), in_dim, generator)
        self.in_bias = _uniform((embed_dim,), in_dim, generator)
        self.out_kernel = _uniform((embed_dim, out_dim), embed_dim, generator)
        self.out_bias = _uniform((out_dim,), embed_dim, generator)

    def forward(self, entities, pre_mask=None, post_mask=None, ret_attn_logits=None):
        dt = self.dtype or entities.dtype
        out = entity_pooling(entities.to(dt), self.in_kernel.to(dt), self.in_bias.to(dt),
                             self.out_kernel.to(dt), self.out_bias.to(dt), pre_mask,
                             post_mask, self.pooling_type)
        if ret_attn_logits is not None:
            return out, None
        return out


class _ProjParams(nn.Module):
    """One GRU projection's parameters, named and shaped as the flax
    ``GRUCell`` Dense children: ``kernel`` (fan_in, H), ``bias`` (H,) or none.
    Every one is initialised U(-1/sqrt(H), 1/sqrt(H)), the GRUCell bound."""

    def __init__(self, fan_in: int, features: int, use_bias: bool, bound: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _uniform((fan_in, features), fan_in, generator, bound)
        self.bias = _uniform((features,), fan_in, generator, bound) if use_bias else None


class GRUSequence(nn.Module):
    """GRU over a sequence with the input projection hoisted out of the
    recurrence. Children ``ir``, ``iz``, ``in`` (with bias), ``hr``, ``hz``
    (without) and ``hn`` (with), as the flax tree names them.

    ``xs`` (R, T, D), ``h0`` (R, H) -> ``(h_last, hs)``, hs (R, T, H). The
    input projection ``xs @ W_i + b_i`` is one plain matmul in ``xs``'s dtype
    (the JAX package leaves it to XLA outside its kernel); the recurrence, in
    float32, is ``ops.gru_kernel.gru_sequence`` (the CUDA kernels on a CUDA
    tensor, the plain version on a CPU tensor) or, with ``use_kernel=False``
    (the config's ``use_pallas_gru``), the plain version everywhere."""

    def __init__(self, in_features: int, features: int, use_kernel: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.use_kernel = use_kernel
        bound = 1.0 / math.sqrt(features)
        for name in ("ir", "iz", "in", "hr", "hz", "hn"):
            fan_in = in_features if name.startswith("i") else features
            self.add_module(name, _ProjParams(fan_in, features, name not in ("hr", "hz"),
                                              bound, generator))

    def forward(self, xs: torch.Tensor, h0: torch.Tensor):
        p = self._modules
        wi = torch.cat([p["ir"].kernel, p["iz"].kernel, p["in"].kernel], -1)  # (D, 3H)
        bi = torch.cat([p["ir"].bias, p["iz"].bias, p["in"].bias], -1)
        wh = torch.cat([p["hr"].kernel, p["hz"].kernel, p["hn"].kernel], -1)  # (H, 3H)
        xw = torch.matmul(xs, wi.to(xs.dtype)) + bi.to(xs.dtype)  # (R, T, 3H)
        args = (xw.transpose(0, 1).contiguous(), wh.float(), p["hn"].bias.float(), h0)
        if self.use_kernel:
            hs = kernel_gru_sequence(*args)
        else:
            _log_plain_choice("use_pallas_gru", "the GRU recurrence")
            hs = gru_sequence(*args)
        hs = hs.transpose(0, 1)  # (R, T, H)
        return hs[:, -1], hs


def make_entity_layer(in_dim: int, embed_dim: int, out_dim: int, n_heads: int,
                      pooling_type: Optional[str], dtype=None, use_kernel: bool = True,
                      generator: Optional[torch.Generator] = None) -> nn.Module:
    """Attention layer, or the pooling ablation when ``pooling_type`` is set."""
    if pooling_type is None:
        return EntityAttentionLayer(in_dim, embed_dim, out_dim, n_heads, dtype=dtype,
                                    use_kernel=use_kernel, generator=generator)
    return EntityPoolingLayer(in_dim, embed_dim, out_dim, pooling_type, dtype=dtype,
                              generator=generator)
