"""refil_torch.ops.attention (the plain versions of the entity-attention
kernel) against refil_tpu: the XLA path and the Pallas kernel in interpret
mode. f32 forward at atol 1e-5, gradients of all four differentiable inputs at
atol/rtol 1e-4, bf16 forward at atol 2e-2.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and the
``cuda``-marked test at the end of this file)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from refil_tpu.ops import attention as ja
from refil_tpu.ops import pallas_attn
from refil_torch.ops import attention as ta
from refil_torch.ops import entity_attn

CASES = {
    # name: (Bp, Ne, Nq, D, E, O, heads, pre_mask?)
    "nq_eq_ne": (6, 8, 8, 16, 32, 24, 4, True),
    "nq_lt_ne": (5, 7, 3, 12, 16, 16, 2, True),
    "no_pre_mask": (4, 6, 4, 16, 16, 8, 2, False),
    "ragged_batch": (13, 6, 6, 16, 16, 16, 4, True),  # Bp a multiple of no tile
}


def _inputs(Bp, Ne, Nq, D, E, O, pre, seed=0, mask_rows=None):
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((Bp, Ne, D)).astype(np.float32)
    wi = (rng.standard_normal((D, 3 * E)) * 0.2).astype(np.float32)
    wo = (rng.standard_normal((E, O)) * 0.2).astype(np.float32)
    bo = (rng.standard_normal((O,)) * 0.1).astype(np.float32)
    pm = None
    if pre:
        pm = rng.random((Bp, mask_rows or Nq, Ne)) < 0.3
        pm[0, min(1, Nq - 1), :] = True  # a fully blocked row
    post = rng.random((Bp, Nq)) < 0.2
    post[-1, 0] = True  # a post-masked row
    g = rng.standard_normal((Bp, Nq, O)).astype(np.float32)
    return ents, wi, wo, bo, pm, post, g


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_entity_attention_forward_and_grads_vs_xla(case):
    Bp, Ne, Nq, D, E, O, H, pre = CASES[case]
    ents, wi, wo, bo, pm, post, g = _inputs(Bp, Ne, Nq, D, E, O, pre, mask_rows=Ne)

    def jloss(e, a, b, c):
        return (ja.entity_attention(e, a, b, c, _j(pm), _j(post), H) * _j(g)).sum()

    ref = ja.entity_attention(*map(jnp.asarray, (ents, wi, wo, bo)), _j(pm), _j(post), H)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (ents, wi, wo, bo)))

    leaves = [torch.tensor(x, requires_grad=True) for x in (ents, wi, wo, bo)]
    out = ta.entity_attention(*leaves, _t(pm), _t(post), H)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    if pre:  # fully blocked row: exactly the bias (or 0 where post-masked)
        blocked = pm[:, :Nq].all(-1)
        np.testing.assert_array_equal(
            out.detach().numpy()[blocked],
            np.where(post[blocked][:, None], 0.0, bo[None, :]))
    (out * torch.as_tensor(g)).sum().backward()
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)

    # the wrapper takes the plain version for CPU tensors
    out_w = entity_attn.entity_attention(*map(torch.as_tensor, (ents, wi, wo, bo)), _t(pm),
                                         _t(post), H)
    assert torch.equal(out_w, out.detach())


@pytest.mark.parametrize("case", sorted(CASES))
def test_entity_attention_vs_pallas_interpret(case):
    Bp, Ne, Nq, D, E, O, H, pre = CASES[case]
    ents, wi, wo, bo, pm, post, g = _inputs(Bp, Ne, Nq, D, E, O, pre, seed=1)
    args = tuple(map(jnp.asarray, (ents, wi, wo, bo)))

    def jloss(e, a, b, c):
        out = pallas_attn.pallas_entity_attention(e, a, b, c, _j(pm), _j(post), H)
        return (out * _j(g)).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = pallas_attn.pallas_entity_attention(*args, _j(pm), _j(post), H)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*args)

    leaves = [torch.tensor(x, requires_grad=True) for x in (ents, wi, wo, bo)]
    out = ta.entity_attention(*leaves, _t(pm), _t(post), H)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    (out * torch.as_tensor(g)).sum().backward()
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_masked_attention_and_logits(reduce):
    Bp, Ne, Nq, D, E, O, H, _ = CASES["nq_lt_ne"]
    ents, wi, wo, bo, pm, post, _ = _inputs(Bp, Ne, Nq, D, E, O, True, seed=2)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((Bp, Nq, E)).astype(np.float32)
    k = rng.standard_normal((Bp, Ne, E)).astype(np.float32)
    v = rng.standard_normal((Bp, Ne, E)).astype(np.float32)
    ref_out, ref_logits = ja.masked_attention(_j(q), _j(k), _j(v), _j(pm), H, ret_logits=True)
    out, logits = ta.masked_attention(_t(q), _t(k), _t(v), _t(pm), H, ret_logits=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5)

    ref = ja.entity_attention(*map(jnp.asarray, (ents, wi, wo, bo)), _j(pm), _j(post), H,
                              ret_attn_logits=reduce)
    got = ta.entity_attention(*map(torch.as_tensor, (ents, wi, wo, bo)), _t(pm), _t(post), H,
                              ret_attn_logits=reduce)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("pooling", ["max", "mean"])
def test_entity_pooling(pooling):
    Bp, Ne, Nq, D, E, O = 5, 7, 3, 12, 16, 8
    ents, _, wo, bo, pm, post, _ = _inputs(Bp, Ne, Nq, D, E, O, True, seed=4)
    rng = np.random.default_rng(5)
    wi = (rng.standard_normal((D, E)) * 0.2).astype(np.float32)
    bi = (rng.standard_normal((E,)) * 0.1).astype(np.float32)
    ref = ja.entity_pooling(*map(jnp.asarray, (ents, wi, bi, wo, bo)), _j(pm), _j(post), pooling)
    got = ta.entity_pooling(*map(torch.as_tensor, (ents, wi, bi, wo, bo)), _t(pm), _t(post),
                            pooling)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_entity_attention_bf16_forward():
    Bp, Ne, Nq, D, E, O, H, _ = CASES["nq_eq_ne"]
    ents, wi, wo, bo, pm, post, _ = _inputs(Bp, Ne, Nq, D, E, O, True, seed=6)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (ents, wi, wo, bo)]
    ref = ja.entity_attention(*jb, _j(pm), _j(post), H)
    tb = [torch.as_tensor(x).to(torch.bfloat16) for x in (ents, wi, wo, bo)]
    got = ta.entity_attention(*tb, _t(pm), _t(post), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    Bp, Ne, Nq, D, E, O, H, _ = CASES["nq_eq_ne"]
    ents, wi, wo, bo, pm, post, _ = _inputs(Bp, Ne, Nq, D, E, O, True)
    before = dict(entity_attn.launches)
    with pytest.raises(ValueError):
        entity_attn.kernel_forward(*map(torch.as_tensor, (ents, wi, wo, bo)), _t(pm), _t(post), H)
    entity_attn.entity_attention(*map(torch.as_tensor, (ents, wi, wo, bo)), _t(pm), _t(post), H)
    assert entity_attn.launches == before


@pytest.mark.cuda
def test_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    Bp, Ne, Nq, D, E, O, H, _ = CASES["nq_lt_ne"]
    ents, wi, wo, bo, pm, post, g = _inputs(Bp, Ne, Nq, D, E, O, True, mask_rows=Ne)
    cuda = [torch.as_tensor(x).cuda().requires_grad_(True) for x in (ents, wi, wo, bo)]
    out = entity_attn.entity_attention(*cuda, _t(pm).cuda(), _t(post).cuda(), H)
    (out * torch.as_tensor(g).cuda()).sum().backward()
    leaves = [torch.tensor(x, requires_grad=True) for x in (ents, wi, wo, bo)]
    ref = ta.entity_attention(*leaves, _t(pm), _t(post), H)
    (ref * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().cpu().numpy(), ref.detach().numpy(), atol=1e-5)
    for a, b in zip(cuda, leaves):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(), atol=1e-4, rtol=1e-4)
