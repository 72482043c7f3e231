"""refil_torch.ops.attention.entity_attention_forward_staged, the plain
version of the CUDA forward's stages (Q over the Nq query rows only, the
TPU kernel's rounding points), against refil_tpu: the Pallas forward
``pallas_attn._pallas_forward`` in interpret mode and the XLA path
``attention.entity_attention``.

Float32: atol 1e-5. Bfloat16: within 2e-2 of max(1, max |reference|)
against the Pallas kernel, which rounds at the same points, and against the
XLA path in float32 on the same bfloat16-valued inputs."""
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
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(Bp, Ne, Nq, D, E, O, masks, seed):
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((Bp, Ne, D)).astype(np.float32)
    wi = (rng.standard_normal((D, 3 * E)) * 0.25).astype(np.float32)
    wo = (rng.standard_normal((E, O)) * 0.25).astype(np.float32)
    bo = (rng.standard_normal((O,)) * 0.1).astype(np.float32)
    pm = None
    post = np.zeros((Bp, Nq), bool)
    if masks != "no_pre_mask":
        pm = rng.random((Bp, Ne, Ne)) < 0.3  # square, as the agents' masks
        pm[1, 0, :] = True  # a fully blocked query row
    if masks == "post_masked_rows":
        post = rng.random((Bp, Nq)) < 0.3
        post[0, :] = True  # a whole sample post-masked
    return ents, wi, wo, bo, pm, post


def _close(a, b, tol, dtype, msg):
    b = np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=msg)
    else:
        err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
        assert err <= tol, f"{msg}: {err} of scale > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_staged_forward_matches_pallas_and_xla(shape, masks, dtype):
    Bp, Ne, Nq, D, E, O = SHAPES[shape]
    ents, wi, wo, bo, pm, post = _inputs(Bp, Ne, Nq, D, E, O, masks,
                                         seed=MASKS.index(masks) + 5 * Ne)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = TOL[dtype]
    jpm = None if pm is None else jnp.asarray(pm)
    jpost = jnp.asarray(post)

    got = ta.entity_attention_forward_staged(
        *(torch.as_tensor(a).to(tdt) for a in (ents, wi, wo, bo)),
        None if pm is None else torch.as_tensor(pm), torch.as_tensor(post), HEADS)
    assert got.out.dtype == tdt and got.out.shape == (Bp, Nq, O)
    out = got.out.float().numpy()

    jargs = tuple(jnp.asarray(a, jdt) for a in (ents, wi, wo, bo))
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_attn._pallas_forward(*jargs, jpm, jpost, HEADS)
    _close(out, ref, tol, dtype, "forward vs pallas")

    f32 = tuple(jnp.asarray(a, jnp.float32) for a in jargs)
    _close(out, ja.entity_attention(*f32, jpm, jpost, HEADS), tol, dtype, "forward vs XLA")
    # the plain version, which the CPU path runs, agrees with its stages
    plain = ta.entity_attention(*(torch.as_tensor(a).to(tdt) for a in (ents, wi, wo, bo)),
                                None if pm is None else torch.as_tensor(pm),
                                torch.as_tensor(post), HEADS)
    _close(out, plain.float().numpy(), tol, dtype, "forward vs the plain version")
    if pm is not None:  # a fully blocked row attends to nothing: attn is exactly 0
        assert not got.attn[1, 0].any() and got.row_ok[1, 0] == 0
    if post.any():  # post-masked rows are exactly 0
        assert not got.out[torch.as_tensor(post)].any()
