"""The flat path's modules against refil_tpu's on the same inputs, made from
a seed with numpy, and the same parameters (the JAX init carried over by
``refil_torch.params``): ``RNNAgent`` (its JAX GRU on the XLA scan and on
the Pallas kernel in interpret mode) and ``FFAgent``, ``QMixer`` at
``hypernet_layers`` 1 and 2, with softmax weights and the tanh
non-linearity, with and without imagined groups over ``state_masks``, and
``BasicMAC``'s rollout step and whole-episode forward: outputs within 1e-6,
and the parameters' gradients of a scalar of the output within 1e-5 of
max(1, max |ref|) over each parameter (sums over every element, in another
order).
Then ``multinomial`` and ``pi_logits_transform`` on the Gumbel draws JAX
takes from its key: the same actions and probabilities."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refil_tpu.ops.pallas_gru as pg
from refil_tpu.components.action_selectors import multinomial as jax_multinomial
from refil_tpu.config import Args
from refil_tpu.controllers.mac import BasicMAC as JaxBasicMAC
from refil_tpu.controllers.mac import pi_logits_transform as jax_pi_logits
from refil_tpu.envs.combat.flat_env import FlatBattle as JaxFlat
from refil_tpu.modules import agents as jagents
from refil_tpu.modules import mixers as jmixers
from refil_torch import params as tparams
from refil_torch.components.action_selectors import multinomial
from refil_torch.controllers.mac import BasicMAC, pi_logits_transform
from refil_torch.modules import agents as tagents
from refil_torch.modules import mixers as tmixers
from torch_parity import flax_tree_to_numpy, unwrap

B, T, NA, D, H, A = 3, 7, 4, 13, 16, 9


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_gru(request):
    impl = pg.get_gru_impl()
    if request.param == "pallas_interpret":
        pg.set_gru_impl("pallas")
        pg._INTERPRET = True
    yield request.param
    pg.set_gru_impl(impl)
    pg._INTERPRET = False


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check_module(jmod, tmod, jargs, targs, reduce_out, key=0):
    """Init ``jmod`` on ``jargs``, load its parameters into ``tmod``, then
    the outputs (within 1e-6) and the gradients of ``reduce_out(outputs)``
    (within 1e-5 of max(1, max |ref|) each) of both on the same inputs."""
    params = jmod.init(jax.random.PRNGKey(key), *jargs)
    tparams.load_flax_params(tmod, flax_tree_to_numpy(params))
    jout = jmod.apply(params, *jargs)
    tout = tmod(*targs)
    jout, tout = (jout, tout) if isinstance(jout, tuple) else ((jout,), (tout,))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)
    jgrad = jax.grad(lambda p: reduce_out(jnp, jmod.apply(p, *jargs)))(params)
    reduce_out(torch, tmod(*targs)).backward()
    _assert_scaled_close(tparams.to_flax_params(tmod, grads=True),
                         unwrap(flax_tree_to_numpy(jgrad)))


def _assert_scaled_close(got, ref, tol=1e-5, path=""):
    assert set(got) == set(ref), (path, sorted(got), sorted(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_scaled_close(got[k], ref[k], tol, f"{path}/{k}")
        else:
            err = np.abs(got[k] - ref[k]).max() / max(1.0, np.abs(ref[k]).max())
            assert err <= tol, (f"{path}/{k}", err)


def _q_loss(xp, out):
    q, h = out
    return (q ** 2).sum() + xp.tanh(h).sum()


def test_rnn_agent_matches_jax(jax_gru):
    rng = np.random.default_rng(0)
    x, h0 = _rand(rng, B, T, NA, D), _rand(rng, B, NA, H)
    _check_module(jagents.RNNAgent(rnn_hidden_dim=H, n_actions=A),
                  tagents.RNNAgent(D, H, A),
                  (jnp.asarray(x), jnp.asarray(h0)),
                  (torch.as_tensor(x), torch.as_tensor(h0)), _q_loss)


def test_ff_agent_matches_jax():
    rng = np.random.default_rng(1)
    x, h0 = _rand(rng, B, T, NA, D), _rand(rng, B, NA, H)
    _check_module(jagents.FFAgent(rnn_hidden_dim=H, n_actions=A), tagents.FFAgent(D, H, A),
                  (jnp.asarray(x), jnp.asarray(h0)),
                  (torch.as_tensor(x), torch.as_tensor(h0)), _q_loss)


@pytest.mark.parametrize("layers,softmax,non_lin,imagined", [
    (1, False, "elu", False), (2, False, "elu", False), (2, True, "tanh", False),
    (1, False, "elu", True), (1, True, "tanh", True)])
def test_qmixer_matches_jax(layers, softmax, non_lin, imagined):
    rng = np.random.default_rng(layers + 2 * softmax)
    S, E, NE = 27, 8, 7
    masks = (rng.random((NE, S)) < 0.3).astype(np.float32)
    states = _rand(rng, B, T, S)
    qs = _rand(rng, B, T, 2 * NA if imagined else NA)
    kw = dict(n_agents=NA, state_dim=S, mixing_embed_dim=E, hypernet_layers=layers,
              hypernet_embed=12, softmax_mixing_weights=softmax, mixer_non_lin=non_lin)
    jargs, targs = [jnp.asarray(qs), jnp.asarray(states)], [torch.as_tensor(qs),
                                                             torch.as_tensor(states)]
    jmod = jmixers.QMixer(state_masks=jnp.asarray(masks), **kw)
    tmod = tmixers.QMixer(state_masks=masks, **kw)
    if imagined:
        ga = rng.random((B, T, NE)) < 0.5
        groups = (ga, ~ga)
        jmod = _Bound(jmod, imagine_groups=tuple(jnp.asarray(g) for g in groups))
        tfwd = tmod.forward
        tmod.forward = lambda *a: tfwd(*a, imagine_groups=tuple(torch.as_tensor(g)
                                                                for g in groups))
    _check_module(jmod, tmod, jargs, targs, lambda xp, y: (y ** 2).sum(), key=3)
    with pytest.raises(ValueError, match="state_masks"):
        tmixers.QMixer(**kw)(torch.as_tensor(qs[..., :NA]).repeat(1, 1, 2),
                             torch.as_tensor(states),
                             imagine_groups=(torch.ones(B, T, NE), torch.ones(B, T, NE)))


class _Bound:
    """A flax module with keyword arguments bound to its init and apply."""

    def __init__(self, mod, **kw):
        self.mod, self.kw = mod, kw

    def init(self, key, *args):
        return self.mod.init(key, *args, **self.kw)

    def apply(self, params, *args):
        return self.mod.apply(params, *args, **self.kw)


def test_qmixer_imagined_two_layer_hypernets():
    """The imagined path at ``hypernet_layers`` 2 runs W_1's two-layer
    hypernet on both groups' masked states with one set of weights. The JAX
    ``QMixer`` cannot run it (flax refuses to create the compact
    ``hyper_w_1_0`` twice in one call), so the reference here is the same
    math written out in jax.numpy over that module's parameters, which its
    non-imagined path holds to the JAX module first."""
    rng = np.random.default_rng(8)
    S, E, NE = 27, 8, 7
    masks = (rng.random((NE, S)) < 0.3).astype(np.float32)
    states, qs = _rand(rng, B, T, S), _rand(rng, B, T, 2 * NA)
    ga = rng.random((B, T, NE)) < 0.5
    kw = dict(n_agents=NA, state_dim=S, mixing_embed_dim=E, hypernet_layers=2,
              hypernet_embed=12)
    jmod = jmixers.QMixer(state_masks=jnp.asarray(masks), **kw)
    params = jmod.init(jax.random.PRNGKey(9), jnp.asarray(qs[..., :NA]), jnp.asarray(states))
    p = unwrap(params)

    def lin(name, x):
        return x @ p[name]["kernel"] + p[name]["bias"]

    def reference(q, st):
        st = st.reshape(B * T, S)
        hw1 = lambda x: lin("hyper_w_1_1", jax.nn.relu(lin("hyper_w_1_0", x)))  # noqa: E731
        sm = jnp.asarray(masks)[None]
        m_a = jnp.clip((jnp.asarray(ga, jnp.float32).reshape(B * T, NE, 1) * sm).sum(1), max=1)
        m_b = jnp.clip((jnp.asarray(~ga, jnp.float32).reshape(B * T, NE, 1) * sm).sum(1), max=1)
        w1 = jnp.abs(jnp.concatenate([hw1(st * m_a), hw1(st * m_b)], 1)).reshape(B * T, -1, E)
        hidden = jax.nn.elu(jnp.einsum("bqa,bae->bqe", q.reshape(B * T, 1, 2 * NA), w1)
                            + lin("hyper_b_1", st)[:, None])
        wf = jnp.abs(lin("hyper_w_final_1", jax.nn.relu(lin("hyper_w_final_0", st))))
        v = lin("V_1", jax.nn.relu(lin("V_0", st)))
        return (jnp.einsum("bqe,be->bq", hidden, wf) + v).reshape(B, T, 1)

    tmod = tmixers.QMixer(state_masks=masks, **kw)
    tparams.load_flax_params(tmod, flax_tree_to_numpy(params))
    groups = (torch.as_tensor(ga), torch.as_tensor(~ga))
    got = tmod(torch.as_tensor(qs), torch.as_tensor(states), imagine_groups=groups)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(reference(jnp.asarray(qs), jnp.asarray(states))),
                               atol=1e-5, rtol=0)
    # the written-out reference is the JAX module where the module runs
    flat = tmod(torch.as_tensor(qs[..., :NA]), torch.as_tensor(states))
    np.testing.assert_allclose(flat.detach().numpy(), np.asarray(jmod.apply(
        params, jnp.asarray(qs[..., :NA]), jnp.asarray(states))), atol=1e-6, rtol=0)
    with pytest.raises(Exception, match="hyper_w_1_0"):
        jmod.apply(params, jnp.asarray(qs), jnp.asarray(states),
                   imagine_groups=(jnp.asarray(ga), jnp.asarray(~ga)))


@pytest.mark.parametrize("agent,last_action,agent_id", [("rnn", True, True),
                                                        ("ff", False, True)])
def test_basic_mac_matches_jax(agent, last_action, agent_id):
    env = JaxFlat(map_name="2s3z")
    info = env.env_info()
    args = Args(agent=agent, rnn_hidden_dim=H, obs_last_action=last_action,
                obs_agent_id=agent_id, use_cuda=False)
    jmac, tmac = JaxBasicMAC(args, info), BasicMAC(args, info, "cpu")
    assert tmac.input_shape == jmac.input_shape
    params = jmac.init_params(jax.random.PRNGKey(4))
    tparams.load_flax_params(tmac.agent, flax_tree_to_numpy(params))
    rng = np.random.default_rng(5)
    Na, Aa, L = info["n_agents"], info["n_actions"], 6
    actions = rng.integers(0, Aa, (B, L, Na))
    batch = {"obs": _rand(rng, B, L, Na, info["obs_shape"]),
             "actions_onehot": np.eye(Aa, dtype=np.float32)[actions]}
    jq = jmac.forward_episode(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tq = tmac.forward_episode({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-6, rtol=0)

    obs = {"obs": batch["obs"][:, 0]}
    last, hidden = batch["actions_onehot"][:, 1], _rand(rng, B, Na, H)
    jq, jh = jmac.forward_step(params, {"obs": jnp.asarray(obs["obs"])}, jnp.asarray(last),
                               jnp.asarray(hidden))
    tq, th = tmac.forward_step({"obs": torch.as_tensor(obs["obs"])}, torch.as_tensor(last),
                               torch.as_tensor(hidden))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    assert tuple(tmac.init_hidden(B).shape) == (B, Na, H)


@pytest.mark.parametrize("test_mode,mask_first", [(False, True), (True, True),
                                                  (False, False)])
def test_multinomial_and_pi_logits_match_jax(test_mode, mask_first):
    rng = np.random.default_rng(6)
    q = _rand(rng, 16, NA, A)
    avail = rng.random((16, NA, A)) < 0.6
    avail[..., 0] = True
    eps = 0.3
    jprobs = jax_pi_logits(jnp.asarray(q), jnp.asarray(avail), eps, test_mode, mask_first)
    tprobs = pi_logits_transform(torch.as_tensor(q), torch.as_tensor(avail), eps, test_mode,
                                 mask_first)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)
    # the same probabilities as a 0-d tensor epsilon (the fused pipeline's)
    t2 = pi_logits_transform(torch.as_tensor(q), torch.as_tensor(avail), torch.tensor(eps),
                             test_mode, mask_first)
    np.testing.assert_allclose(t2.numpy(), tprobs.numpy(), atol=1e-7, rtol=0)

    key = jax.random.PRNGKey(7)
    for greedy in (True, False):
        ja = jax_multinomial(key, jprobs, jnp.asarray(avail), greedy, test_mode)
        gumbel = torch.as_tensor(np.array(jax.random.gumbel(key, q.shape)))
        ta = multinomial(tprobs, torch.as_tensor(avail), greedy, test_mode, gumbel=gumbel)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert bool(torch.as_tensor(avail).gather(2, ta[..., None]).all())
    # drawn from a generator: only available actions, every one of them in time
    g = torch.Generator().manual_seed(0)
    uniform = torch.as_tensor(avail).float()
    seen = torch.zeros_like(uniform, dtype=torch.bool)
    for _ in range(200):
        a = multinomial(uniform, torch.as_tensor(avail), generator=g)
        assert bool(torch.as_tensor(avail).gather(2, a[..., None]).all())
        seen |= torch.nn.functional.one_hot(a, A).bool()
    assert torch.equal(seen, torch.as_tensor(avail))
