"""refil_torch's combat modules against the JAX package's flax modules, with
the weights carried across by ``refil_torch.params``: the RNN agents (plain,
and imagined with the JAX draws injected) and ``FlexQMixer`` (plain and
imagined, with and without softmax mixing weights, elu and tanh). Outputs at
atol 1e-5, parameter gradients at atol/rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu.modules import agents as jag
from refil_tpu.modules import mixers as jmx
from refil_torch import params as tparams
from refil_torch.modules import agents as tag
from refil_torch.modules import mixers as tmx
from torch_parity import assert_trees_close, flax_tree_to_numpy, unwrap

B, T, NE, NA, D, A, E, H, HID = 2, 5, 7, 3, 9, 4, 16, 2, 8


def _obs(seed):
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((B, T, NE, D)).astype(np.float32)
    om = rng.random((B, T, NE, NE)) < 0.25
    em = rng.random((B, T, NE)) < 0.15
    em[0, :, 1] = True  # an inactive agent
    hidden = (0.5 * rng.standard_normal((B, NA, HID))).astype(np.float32)
    return ents, om, em, hidden


def _agent_kw():
    return dict(attn_embed_dim=E, rnn_hidden_dim=HID, n_actions=A, n_agents=NA, attn_n_heads=H)


def _check_grads(module, jgrads):
    assert_trees_close(tparams.to_flax_params(module, grads=True),
                       unwrap(flax_tree_to_numpy(jgrads)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("imagine", [False, True])
def test_rnn_agent(imagine):
    ents, om, em, hidden = _obs(1)
    cls = jag.ImagineEntityAttentionRNNAgent if imagine else jag.EntityAttentionRNNAgent
    ja = cls(**_agent_kw())
    jargs = (jnp.asarray(ents), jnp.asarray(om), jnp.asarray(em), jnp.asarray(hidden))
    jp = ja.init(jax.random.PRNGKey(0), *jargs)
    key = jax.random.PRNGKey(9)
    kw = dict(imagine=True, imagine_key=key) if imagine else {}
    n_b = 3 * B if imagine else B
    rng = np.random.default_rng(2)
    wq = rng.standard_normal((n_b, T, NA, A)).astype(np.float32)
    wh = rng.standard_normal((n_b, NA, HID)).astype(np.float32)

    def jfwd(p):
        return ja.apply(p, *jargs, **kw)

    def jloss(p):
        out = jfwd(p)
        return (out[0] * wq).sum() + (out[1] * wh).sum()

    jout = jfwd(jp)
    jgrads = jax.grad(jloss)(jp)

    ta = getattr(tag, cls.__name__)(input_shape=D, **_agent_kw())
    assert ta.agent_rows is False  # square imagine masks
    tparams.load_flax_params(ta, flax_tree_to_numpy(jp))
    targs = (torch.as_tensor(ents), torch.as_tensor(om), torch.as_tensor(em),
             torch.as_tensor(hidden))
    tkw = {}
    if imagine:
        key_p, key_b = jax.random.split(key)
        gp = jax.random.uniform(key_p, (B, 1, 1))
        ga = jax.random.bernoulli(key_b, gp, (B, 1, NE))
        tkw = dict(imagine=True, imagine_draws=(torch.as_tensor(np.array(gp)),
                                                torch.as_tensor(np.array(ga))))
    tout = ta(*targs, **tkw)
    np.testing.assert_allclose(tout[0].detach().numpy(), np.asarray(jout[0]), atol=1e-5)
    np.testing.assert_allclose(tout[1].detach().numpy(), np.asarray(jout[1]), atol=1e-5)
    if imagine:
        for got, ref in zip(tout[2], jout[2]):
            assert got.shape[-2:] == (NE, NE)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ((tout[0] * torch.as_tensor(wq)).sum() + (tout[1] * torch.as_tensor(wh)).sum()).backward()
    _check_grads(ta, jgrads)


@pytest.mark.parametrize("imagine", [False, True])
@pytest.mark.parametrize("softmax,non_lin", [(True, "elu"), (False, "elu"), (False, "tanh")])
def test_flex_qmixer(imagine, softmax, non_lin):
    ents, _, em, _ = _obs(7)
    rng = np.random.default_rng(8)
    n_q = 2 * NA if imagine else NA
    qs = rng.standard_normal((B, T, n_q)).astype(np.float32)
    groups = tuple(rng.random((B, T, NE, NE)) < 0.4 for _ in range(2)) if imagine else None
    kw = dict(n_agents=NA, mixing_embed_dim=8, hypernet_embed=E, attn_n_heads=H,
              softmax_mixing_weights=softmax, mixer_non_lin=non_lin)
    jm = jmx.FlexQMixer(**kw)
    jargs = (jnp.asarray(qs), jnp.asarray(ents), jnp.asarray(em))
    jg = None if groups is None else tuple(map(jnp.asarray, groups))
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((B, T, NA)), jargs[1], jargs[2])
    jq = jm.apply(jp, *jargs, imagine_groups=jg)
    w = rng.standard_normal(jq.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: (jm.apply(p, *jargs, imagine_groups=jg) * w).sum())(jp)

    tm = tmx.FlexQMixer(input_dim=D, **kw)
    tparams.load_flax_params(tm, flax_tree_to_numpy(jp))
    tg = None if groups is None else tuple(map(torch.as_tensor, groups))
    tq = tm(torch.as_tensor(qs), torch.as_tensor(ents), torch.as_tensor(em), imagine_groups=tg)
    assert tq.shape == (B, T, 1)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5)
    (tq * torch.as_tensor(w)).sum().backward()
    _check_grads(tm, jgrads)
