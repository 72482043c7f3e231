"""refil_torch.ops.gru.gru_backward_staged, the plain version of the CUDA
GRU backward's stages (GH for all steps at once, the dh recurrence, dW_h and
db_hn as sums over all rows), against refil_tpu: the Pallas backward
``pallas_gru._pallas_bwd`` in interpret mode and the VJP of
``gru_sequence_xla``, float32 at atol/rtol 1e-4."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refil_tpu.ops.pallas_gru as pg
from refil_torch.ops.gru import gru_backward_staged, gru_sequence

H = 8


@pytest.fixture
def interpret_kernel():
    pg._INTERPRET = True
    yield
    pg._INTERPRET = False


def _raw(T, R, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, R, 3 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) / math.sqrt(H)).astype(np.float32)
    bhn = (0.1 * rng.standard_normal(H)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((R, H))).astype(np.float32)
    g = rng.standard_normal((T, R, H)).astype(np.float32)
    return xw, wh, bhn, h0, g


@pytest.mark.parametrize("impl", ["xla_vjp", "pallas_interpret"])
@pytest.mark.parametrize("R", [8, 37])  # 37: a ragged last row tile
@pytest.mark.parametrize("T", [1, 13])
def test_staged_backward_matches_jax(T, R, impl, interpret_kernel):
    xw, wh, bhn, h0, g = _raw(T, R, seed=T * 100 + R)
    jxw, jwh, jbhn, jh0 = jargs = tuple(map(jnp.asarray, (xw, wh, bhn, h0)))
    hs = pg.gru_sequence_xla(*jargs)
    if impl == "xla_vjp":
        _, vjp = jax.vjp(pg.gru_sequence_xla, *jargs)
        ref = vjp(jnp.asarray(g))
    else:
        ref = pg._pallas_bwd(jxw, hs, jh0, jwh, jbhn, jnp.asarray(g))

    txw, twh, tbhn, th0, tg = map(torch.as_tensor, (xw, wh, bhn, h0, g))
    ths = gru_sequence(txw, twh, tbhn, th0)
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), atol=1e-5)
    got = gru_backward_staged(txw, ths, th0, twh, tbhn, tg)
    assert all(t.dtype == torch.float32 for t in got)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
