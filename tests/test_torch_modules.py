"""refil_torch's agents and mixers against the JAX package's flax modules:
weights from flax ``.init`` carried across by ``refil_torch.params``;
outputs at atol 1e-5 and parameter gradients at atol/rtol 1e-4 against flax
``.apply`` and ``jax.grad``."""
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

B, T, NE, NA, D, A, E, H = 2, 3, 6, 4, 10, 3, 16, 2


def _obs(seed=0):
    rng = np.random.default_rng(seed)
    ents = rng.standard_normal((B, T, NE, D)).astype(np.float32)
    om = rng.random((B, T, NE, NE)) < 0.2
    em = rng.random((B, T, NE)) < 0.15
    em[0, :, 1] = True  # an inactive agent
    gt = rng.random((B, T, NA, NE)) < 0.5
    return ents, om, em, gt


def _check_grads(module, jgrads):
    assert_trees_close(tparams.to_flax_params(module, grads=True),
                       unwrap(flax_tree_to_numpy(jgrads)), atol=1e-4, rtol=1e-4)


def _agent_kw():
    return dict(attn_embed_dim=E, rnn_hidden_dim=E, n_actions=A, n_agents=NA, attn_n_heads=H)


@pytest.mark.parametrize("gt_obs_mask", [False, True])
def test_ff_agent(gt_obs_mask):
    ents, om, em, gt = _obs(1)
    ja = jag.EntityAttentionFFAgent(gt_obs_mask=gt_obs_mask, **_agent_kw())
    h = jnp.zeros((B, NA, E))
    jargs = (jnp.asarray(ents), jnp.asarray(om), jnp.asarray(em), h)
    jp = ja.init(jax.random.PRNGKey(0), *jargs)
    w = np.random.default_rng(2).standard_normal((B, T, NA, A)).astype(np.float32)
    jq, _ = ja.apply(jp, *jargs, gt_mask=jnp.asarray(gt))
    jgrads = jax.grad(lambda p: (ja.apply(p, *jargs, gt_mask=jnp.asarray(gt))[0] * w).sum())(jp)

    ta = tag.EntityAttentionFFAgent(input_shape=D, gt_obs_mask=gt_obs_mask, **_agent_kw())
    tparams.load_flax_params(ta, flax_tree_to_numpy(jp))
    tq, _ = ta(torch.as_tensor(ents), torch.as_tensor(om), torch.as_tensor(em),
               torch.zeros((B, NA, E)), gt_mask=torch.as_tensor(gt))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5)
    (tq * torch.as_tensor(w)).sum().backward()
    _check_grads(ta, jgrads)


@pytest.mark.parametrize("mode", ["random", "gt", "rand_gt"])
def test_imagine_ff_agent(mode):
    ents, om, em, gt = _obs(3)
    ja = jag.ImagineEntityAttentionFFAgent(**_agent_kw())
    h = jnp.zeros((B, NA, E))
    jargs = (jnp.asarray(ents), jnp.asarray(om), jnp.asarray(em), h)
    jp = ja.init(jax.random.PRNGKey(1), *jargs)
    key = jax.random.PRNGKey(9)
    kw = dict(use_gt_factors=mode == "gt", use_rand_gt_factors=mode == "rand_gt")
    w = np.random.default_rng(4).standard_normal((3 * B, T, NA, A)).astype(np.float32)

    def jfwd(p):
        return ja.apply(p, *jargs, imagine=True, imagine_key=key, gt_mask=jnp.asarray(gt), **kw)

    jq, _, (jw, ji) = jfwd(jp)
    jgrads = jax.grad(lambda p: (jfwd(p)[0] * w).sum())(jp)
    key_p, key_b = jax.random.split(key)
    gp = jax.random.uniform(key_p, (B, 1, 1))
    ga = jax.random.bernoulli(key_b, gp, (B, 1, NE))

    ta = tag.ImagineEntityAttentionFFAgent(input_shape=D, **_agent_kw())
    tparams.load_flax_params(ta, flax_tree_to_numpy(jp))
    tq, _, (tw, ti) = ta(torch.as_tensor(ents), torch.as_tensor(om), torch.as_tensor(em),
                         torch.zeros((B, NA, E)), imagine=True,
                         imagine_draws=(torch.as_tensor(np.array(gp)),
                                        torch.as_tensor(np.array(ga))),
                         gt_mask=torch.as_tensor(gt), **kw)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    (tq * torch.as_tensor(w)).sum().backward()
    _check_grads(ta, jgrads)

    # without imagine the agent is the plain FF forward
    jq1, _ = ja.apply(jp, *jargs)
    tq1, _ = ta(torch.as_tensor(ents), torch.as_tensor(om), torch.as_tensor(em),
                torch.zeros((B, NA, E)))
    np.testing.assert_allclose(tq1.detach().numpy(), np.asarray(jq1), atol=1e-5)


@pytest.mark.parametrize("mode", ["matrix", "vector", "alt_vector", "scalar"])
def test_attention_hypernet(mode):
    ents, om, em, _ = _obs(5)
    x = jnp.asarray(ents.reshape(B * T, NE, D))
    m = jnp.asarray(em.reshape(B * T, NE))
    jh = jmx.AttentionHyperNet(hypernet_embed=E, mixing_embed_dim=8, n_agents=NA,
                               attn_n_heads=H, mode=mode)
    jp = jh.init(jax.random.PRNGKey(2), x, m)
    jout = jh.apply(jp, x, m)
    w = np.random.default_rng(6).standard_normal(jout.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: (jh.apply(p, x, m) * w).sum())(jp)

    th = tmx.AttentionHyperNet(input_dim=D, hypernet_embed=E, mixing_embed_dim=8, n_agents=NA,
                               attn_n_heads=H, mode=mode)
    tparams.load_flax_params(th, flax_tree_to_numpy(jp))
    tout = th(torch.as_tensor(np.array(x)), torch.as_tensor(np.array(m)))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5)
    (tout * torch.as_tensor(w)).sum().backward()
    _check_grads(th, jgrads)


@pytest.mark.parametrize("imagine", [False, True])
@pytest.mark.parametrize("ingroup", [False, True])
def test_linear_flex_qmixer(imagine, ingroup):
    ents, om, em, _ = _obs(7)
    rng = np.random.default_rng(8)
    n_q = 2 * NA if imagine else NA
    qs = rng.standard_normal((B, T, n_q)).astype(np.float32)
    groups = None
    if imagine:
        groups = tuple(rng.random((B, T, NA, NE)) < 0.4 for _ in range(2))
    jm = jmx.LinearFlexQMixer(n_agents=NA, mixing_embed_dim=8, hypernet_embed=E,
                              attn_n_heads=H, softmax_mixing_weights=True)
    jargs = (jnp.asarray(qs), jnp.asarray(ents), jnp.asarray(em))
    jg = None if groups is None else tuple(map(jnp.asarray, groups))
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((B, T, NA)), jargs[1], jargs[2])

    def jfwd(p):
        return jm.apply(p, *jargs, imagine_groups=jg, ret_ingroup_prop=ingroup)

    jout = jfwd(jp)
    jq = jout[0] if ingroup else jout
    w = rng.standard_normal(jq.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: ((jfwd(p)[0] if ingroup else jfwd(p)) * w).sum())(jp)

    tm = tmx.LinearFlexQMixer(n_agents=NA, input_dim=D, mixing_embed_dim=8, hypernet_embed=E,
                              attn_n_heads=H, softmax_mixing_weights=True)
    tparams.load_flax_params(tm, flax_tree_to_numpy(jp))
    tg = None if groups is None else tuple(map(torch.as_tensor, groups))
    tout = tm(torch.as_tensor(qs), torch.as_tensor(ents), torch.as_tensor(em),
              imagine_groups=tg, ret_ingroup_prop=ingroup)
    tq = tout[0] if ingroup else tout
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5)
    if ingroup:
        np.testing.assert_allclose(float(tout[1].detach()), float(jout[1]), atol=1e-5)
    (tq * torch.as_tensor(w)).sum().backward()
    _check_grads(tm, jgrads)


def test_vdn_mixer_and_param_round_trip():
    qs = np.random.default_rng(9).standard_normal((B, T, NA)).astype(np.float32)
    np.testing.assert_allclose(tmx.VDNMixer()(torch.as_tensor(qs)).numpy(),
                               np.asarray(jmx.VDNMixer().apply({}, jnp.asarray(qs))), atol=1e-6)
    ents, om, em, _ = _obs(0)
    ja = jag.EntityAttentionFFAgent(**_agent_kw())
    jp = flax_tree_to_numpy(ja.init(jax.random.PRNGKey(4), jnp.asarray(ents), jnp.asarray(om),
                                    jnp.asarray(em), jnp.zeros((B, NA, E))))
    ta = tag.EntityAttentionFFAgent(input_shape=D, **_agent_kw())
    tparams.load_flax_params(ta, jp)
    assert_trees_close(tparams.to_flax_params(ta), unwrap(jp), atol=0)
    bad = unwrap(jp)
    bad["fc1"]["kernel"] = bad["fc1"]["kernel"][:-1]
    with pytest.raises(ValueError):
        tparams.load_flax_params(ta, bad)
