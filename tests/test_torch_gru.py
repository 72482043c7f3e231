"""refil_torch's GRU against refil_tpu's: the plain ``gru_sequence`` against
the lax.scan reference ``gru_sequence_xla`` and against the Pallas kernel in
interpret mode, forward at 1e-5 and the gradients of xw, wh, bhn and h0 at
1e-4; and ``GRUSequence`` with the flax parameters carried over: float32 forward
at 1e-5 and parameter gradients at 1e-4, bfloat16 forward at 2e-2. The CUDA kernel against the plain version runs on the
card (``chip_smoke.py``; the ``cuda`` test below)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refil_tpu.ops.pallas_gru as pg
from refil_tpu.modules.layers import GRUSequence as JaxGRUSequence
from refil_torch import params as tparams
from refil_torch.modules.layers import GRUSequence
from refil_torch.ops import gru_kernel
from refil_torch.ops.gru import gru_sequence
from torch_parity import assert_trees_close, flax_tree_to_numpy, unwrap

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
    w = rng.standard_normal((T, R, H)).astype(np.float32)
    return xw, wh, bhn, h0, w


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("T", [1, 13])
def test_plain_gru_matches_jax(impl, T, interpret_kernel):
    xw, wh, bhn, h0, w = _raw(T, 37, seed=T)
    jfn = pg.gru_sequence_xla if impl == "xla" else pg.pallas_gru
    jargs = tuple(map(jnp.asarray, (xw, wh, bhn, h0)))
    jhs = jfn(*jargs)
    jgrads = jax.grad(lambda *a: (jfn(*a) * w).sum(), argnums=(0, 1, 2, 3))(*jargs)

    leaves = [torch.tensor(a, requires_grad=True) for a in (xw, wh, bhn, h0)]
    hs = gru_sequence(*leaves)
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs), atol=1e-5)
    (hs * torch.as_tensor(w)).sum().backward()
    for name, leaf, jg in zip(("xw", "wh", "bhn", "h0"), leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    # on a CPU tensor the kernel's wrapper is the plain version
    np.testing.assert_array_equal(gru_kernel.gru_sequence(*(torch.as_tensor(a) for a in (
        xw, wh, bhn, h0))).numpy(), hs.detach().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_sequence_module_matches_flax(dtype):
    R, T, D = 10, 6, 5
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((R, T, D)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((R, H))).astype(np.float32)
    w = rng.standard_normal((R, T, H)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = JaxGRUSequence(features=H)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs, jdt), jnp.asarray(h0))
    jlast, jhs = jm.apply(jp, jnp.asarray(xs, jdt), jnp.asarray(h0))
    jgrads = jax.grad(lambda p: (jm.apply(p, jnp.asarray(xs, jdt), jnp.asarray(h0))[1]
                                 * w).sum())(jp)

    tdt = getattr(torch, dtype)
    tm = GRUSequence(D, H)
    tparams.load_flax_params(tm, flax_tree_to_numpy(jp))
    assert_trees_close(tparams.to_flax_params(tm), unwrap(flax_tree_to_numpy(jp)), atol=0)
    tlast, ths = tm(torch.as_tensor(xs).to(tdt), torch.as_tensor(h0))
    assert ths.dtype == tdt and ths.shape == (R, T, H)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(ths.float().detach().numpy(), np.asarray(jhs, np.float32), atol=tol)
    np.testing.assert_allclose(tlast.float().detach().numpy(), np.asarray(jlast, np.float32),
                               atol=tol)
    if dtype == "float32":  # bf16 gradients round at other points in the two frameworks
        (ths * torch.as_tensor(w)).sum().backward()
        assert_trees_close(tparams.to_flax_params(tm, grads=True),
                           unwrap(flax_tree_to_numpy(jgrads)), atol=1e-4, rtol=1e-4)


def test_gru_kernel_refuses_what_it_does_not_take():
    xw, wh, bhn, h0, _ = (torch.as_tensor(a) for a in _raw(2, 3, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        gru_kernel.kernel_forward(xw, wh, bhn, h0)
    with pytest.raises(TypeError):
        gru_kernel.kernel_forward(xw.double(), wh, bhn, h0)
    with pytest.raises(ValueError, match="no kernel"):
        gru_kernel.gru_sequence(xw.to("meta"), wh.to("meta"), bhn.to("meta"), h0.to("meta"))


@pytest.mark.cuda
def test_gru_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GRU kernel has no CPU mode")
    xw, wh, bhn, h0, w = (torch.as_tensor(a).cuda() for a in _raw(13, 37, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (xw, wh, bhn, h0)]
    hs = gru_kernel.gru_sequence(*leaves)
    (hs * w).sum().backward()
    ref_leaves = [t.clone().requires_grad_(True) for t in (xw, wh, bhn, h0)]
    ref = gru_sequence(*ref_leaves)
    (ref * w).sum().backward()
    torch.testing.assert_close(hs, ref, atol=1e-5, rtol=0)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)
