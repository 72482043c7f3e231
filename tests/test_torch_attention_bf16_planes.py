"""The planes between the attention kernels' stages are stored in the
inputs' dtype (``csrc/entity_attn.cu``, ``launch_fwd`` and ``BwdScratch``):
in bfloat16, Q, K|V, attn, dattn, dq, dK|dV and g post_keep take 2 bytes a
value. Each holds only values the TPU kernel rounds to bfloat16 before
their next use (dattn: rounded before a row mask of 0 or 1), so storing it
in bfloat16 changes no value. Here the plain version of the stages
(``entity_attention_forward_staged``, ``entity_attention_backward_staged``)
with the planes stored in bfloat16, as the kernels store them, equals bit
for bit the same stages with the planes kept in float32, on seeded inputs
on the CPU: the output, every plane's values and every gradient. In float32
the planes are float32 either way."""
import numpy as np
import pytest
import torch

from refil_torch.ops import attention as ta

# (B, Ne, Nq, D, E, O, heads, pre-mask rows or None)
SHAPES = [(6, 16, 8, 32, 32, 32, 4, 16), (5, 8, 5, 16, 16, 16, 2, 8),
          (3, 6, 6, 24, 32, 16, 2, None), (4, 8, 8, 16, 24, 8, 3, 8)]


def _inputs(B, Ne, Nq, D, E, O, rows, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dtype)  # noqa: E731
    ents = t(np.maximum(rng.standard_normal((B, Ne, D)), 0))
    wi = t(rng.uniform(-1, 1, (D, 3 * E)) / np.sqrt(D))
    wo = t(rng.uniform(-1, 1, (E, O)) / np.sqrt(E))
    bo = t(rng.uniform(-1, 1, (O,)) / np.sqrt(E))
    pre = None
    if rows is not None:
        pre = torch.as_tensor(rng.random((B, rows, Ne)) < 0.25)
        pre[0, min(1, Nq - 1)] = True  # a fully blocked query row
    post = torch.as_tensor(rng.random((B, Nq)) < 0.2)
    post[0, 0] = True
    g = t(rng.standard_normal((B, Nq, O)))
    return ents, wi, wo, bo, pre, post, g


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_planes_change_no_value(shape):
    *dims, H, rows = shape
    ents, wi, wo, bo, pre, post, g = _inputs(*dims, rows, torch.bfloat16, seed=sum(dims) + H)
    f_b = ta.entity_attention_forward_staged(ents, wi, wo, bo, pre, post, H)
    f_f = ta.entity_attention_forward_staged(ents, wi, wo, bo, pre, post, H,
                                             plane_dtype=torch.float32)
    for name in ("q", "kv", "attn"):
        assert getattr(f_b, name).dtype == torch.bfloat16, name
        assert getattr(f_f, name).dtype == torch.float32, name
        assert torch.equal(getattr(f_b, name).float(), getattr(f_f, name)), name
    assert torch.equal(f_b.out, f_f.out) and f_b.out.dtype == torch.bfloat16
    assert torch.equal(f_b.weights, f_f.weights)

    b_b = ta.entity_attention_backward_staged(ents, wi, wo, pre, post, g, H)
    b_f = ta.entity_attention_backward_staged(ents, wi, wo, pre, post, g, H,
                                              plane_dtype=torch.float32)
    for name in b_b._fields:
        x, y = getattr(b_b, name).float(), getattr(b_f, name).float()
        assert torch.equal(x, y), name
        assert torch.isfinite(x).all(), name


def test_f32_planes_stay_f32():
    ents, wi, wo, bo, pre, post, g = _inputs(4, 8, 5, 16, 16, 16, 8, torch.float32, seed=3)
    f = ta.entity_attention_forward_staged(ents, wi, wo, bo, pre, post, 2)
    assert f.q.dtype == f.kv.dtype == f.attn.dtype == torch.float32
