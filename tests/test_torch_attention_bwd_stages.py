"""refil_torch.ops.attention.entity_attention_backward_staged, the plain
version of the CUDA backward's stages (Q over the Nq query rows only, the
TPU kernel's rounding points), against refil_tpu: the Pallas backward
``pallas_attn._bwd`` in interpret mode and the VJP of the XLA path.

Float32: the recomputed forward (attn W_o + b_o, post-masked) at atol 1e-5,
the four gradients at atol/rtol 1e-4. Bfloat16: forward and gradients within
2e-2 of max(1, max |reference|) (as ``chip_smoke.py`` compares gradients,
each summed over many rows) against the Pallas kernel, which rounds at the
same points, and against the XLA VJP of the same bfloat16-valued inputs in
float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from refil_tpu.ops import attention as ja
from refil_tpu.ops import pallas_attn
from refil_torch.ops import attention as ta

HEADS = 2
# name: (Bp, Ne, Nq, D, E, O)
SHAPES = {"nq_lt_ne": (6, 8, 5, 16, 16, 12), "nq_eq_ne": (5, 6, 6, 12, 16, 8)}
MASKS = ("no_pre_mask", "blocked_row", "post_masked_rows")
TOL = {"float32": dict(fwd=1e-5, grad=1e-4), "bfloat16": dict(fwd=2e-2, grad=2e-2)}


def _inputs(Bp, Ne, Nq, D, E, O, masks, seed):
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((Bp, Ne, D)).astype(np.float32)
    wi = (rng.standard_normal((D, 3 * E)) * 0.25).astype(np.float32)
    wo = (rng.standard_normal((E, O)) * 0.25).astype(np.float32)
    bo = (rng.standard_normal((O,)) * 0.1).astype(np.float32)
    g = rng.standard_normal((Bp, Nq, O)).astype(np.float32)
    pm = None
    post = np.zeros((Bp, Nq), bool)
    if masks != "no_pre_mask":
        pm = rng.random((Bp, Ne, Ne)) < 0.3  # square, as the agents' masks
        pm[1, 0, :] = True  # a fully blocked query row
    if masks == "post_masked_rows":
        post = rng.random((Bp, Nq)) < 0.3
        post[0, :] = True  # a whole sample post-masked
    return ents, wi, wo, bo, pm, post, g


def _close(a, b, tol, dtype, msg, rtol=None):
    b = np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol if rtol is None else rtol,
                                   err_msg=msg)
    else:
        err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
        assert err <= tol, f"{msg}: {err} of scale > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_staged_backward_matches_pallas_and_xla(shape, masks, dtype):
    Bp, Ne, Nq, D, E, O = SHAPES[shape]
    ents, wi, wo, bo, pm, post, g = _inputs(Bp, Ne, Nq, D, E, O, masks,
                                            seed=MASKS.index(masks) + 3 * Ne)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = TOL[dtype]
    jpm = None if pm is None else jnp.asarray(pm)
    jpost = jnp.asarray(post)

    got = ta.entity_attention_backward_staged(
        *(torch.as_tensor(a).to(tdt) for a in (ents, wi, wo)),
        None if pm is None else torch.as_tensor(pm), torch.as_tensor(post),
        torch.as_tensor(g).to(tdt), HEADS)
    assert all(t.dtype == torch.float32 for t in got)
    out = (got.attn.to(tdt) @ torch.as_tensor(wo).to(tdt) + torch.as_tensor(bo).to(tdt))
    out = out.masked_fill(torch.as_tensor(post)[..., None], 0.0).float().numpy()
    grads = [t.numpy() for t in got[:4]]

    jargs = tuple(jnp.asarray(a, jdt) for a in (ents, wi, wo, bo))
    jg = jnp.asarray(g, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref_out = pallas_attn.pallas_entity_attention(*jargs, jpm, jpost, HEADS)
        ref_grads = pallas_attn._bwd(HEADS, (*jargs, jpm, jpost), jg)[:4]
    _close(out, ref_out, tol["fwd"], dtype, "forward vs pallas", rtol=0)
    for name, a, b in zip(got._fields, grads, ref_grads):
        _close(a, b, tol["grad"], dtype, f"{name} vs pallas")

    # the XLA path's VJP, in float32 on the (possibly bf16-rounded) inputs
    f32 = tuple(jnp.asarray(a, jnp.float32) for a in jargs)
    xla_out, vjp = jax.vjp(lambda *a: ja.entity_attention(*a, jpm, jpost, HEADS), *f32)
    xla_grads = vjp(jnp.asarray(jg, jnp.float32))
    _close(out, xla_out, tol["fwd"], dtype, "forward vs XLA", rtol=0)
    for name, a, b in zip(got._fields, grads, xla_grads):
        _close(a, b, tol["grad"], dtype, f"{name} vs the XLA VJP")
    if pm is not None:  # a fully blocked row attends to nothing: attn is exactly 0
        assert not got.attn[1, 0].any()
