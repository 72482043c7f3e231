"""The learner's remaining options against the JAX package on the CPU:
TD(λ) targets (``utils/rl_utils.py:build_td_lambda_targets``) on seeded
numpy inputs at 1e-6 (float32), and the Group Matching learner with
``td_lambda=0.8``, with ``weight_decay=1e-3`` and with both, over 3 RMSprop
updates on one sample of JAX-run episodes, at the tolerances of
``tests/test_torch_learner.py`` (metrics rtol 1e-5, parameters atol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu import config as jconfig
from refil_tpu.controllers.mac import EntityMAC as JaxMAC
from refil_tpu.core.buffer import ReplayBuffer as JaxBuffer
from refil_tpu.envs.group_matching import GroupMatching as JaxGM
from refil_tpu.learners.q_learner import QLearner as JaxLearner
from refil_tpu.run import _dummy_batch
from refil_tpu.runners.vector_runner import VectorRunner as JaxRunner
from refil_tpu.utils.rl_utils import build_td_lambda_targets as jax_td_lambda
from refil_torch import config as tconfig
from refil_torch import params as tparams
from refil_torch.controllers.mac import EntityMAC
from refil_torch.learners.q_learner import QLearner
from refil_torch.utils.rl_utils import build_td_lambda_targets
from test_torch_learner import METRICS, _args, _imagine_draws
from torch_parity import assert_trees_close, batch_to_torch, flax_tree_to_numpy, unwrap


@pytest.mark.parametrize("B,T,n,lam,gamma", [(4, 9, 1, 0.8, 0.99), (3, 1, 1, 0.5, 0.9),
                                             (5, 12, 6, 0.0, 0.99), (2, 7, 1, 1.0, 0.95)])
def test_td_lambda_targets_match_jax(B, T, n, lam, gamma):
    rng = np.random.default_rng(B * 100 + T)
    rewards = rng.standard_normal((B, T, 1)).astype(np.float32)
    term = np.zeros((B, T, 1), np.float32)
    mask = np.ones((B, T, 1), np.float32)
    for b in range(B):  # episodes that end (terminated or cut) at random steps
        end = int(rng.integers(1, T + 1))
        mask[b, end:] = 0.0
        if end < T or rng.random() < 0.5:
            term[b, end - 1] = 1.0
    target_qs = rng.standard_normal((B, T + 1, n)).astype(np.float32)
    want = np.asarray(jax_td_lambda(jnp.asarray(rewards), jnp.asarray(term), jnp.asarray(mask),
                                    jnp.asarray(target_qs), gamma, lam))
    got = build_td_lambda_targets(torch.as_tensor(rewards), torch.as_tensor(term).bool(),
                                  torch.as_tensor(mask), torch.as_tensor(target_qs), gamma, lam)
    assert got.shape == want.shape == (B, T, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra", [("td_lambda=0.8",), ("weight_decay=0.001",),
                                   ("td_lambda=0.8", "weight_decay=0.001")])
def test_learner_options_match_jax(extra):
    alg = "refil_group_matching"
    extra = list(extra) + ["training_iters=3", "batch_size=8"]
    jargs = _args(jconfig, alg, extra)
    jenv = JaxGM(**jargs.env_args)
    info = jenv.env_info()
    jmac = JaxMAC(jargs, info)
    key = jax.random.PRNGKey(1)
    key, k_init, k_r1, k_train = jax.random.split(key, 4)
    jlearner = JaxLearner(jmac, jargs, info, k_init)
    state = jlearner.init_state(k_init, _dummy_batch(jmac, info))
    batch = JaxRunner(jenv, jmac, jargs).run(state.params["agent"], k_r1)
    ring = JaxBuffer(batch, 32, seed=0)
    ring.insert_episode_batch(batch)
    samples = ring.sample_many(jargs.training_iters, jargs.batch_size)
    assert not np.asarray(samples["filled"]).all()  # some episodes end early

    targs = _args(tconfig, alg, extra + ["use_cuda=False"])
    mac = EntityMAC(targs, info, "cpu")
    learner = QLearner(mac, targs, info, "cpu")
    assert learner.optimiser.param_groups[0]["weight_decay"] == float(targs.weight_decay)
    tparams.load_flax_params(mac.agent, flax_tree_to_numpy(state.params["agent"]))
    tparams.load_flax_params(learner.mixer, flax_tree_to_numpy(state.params["mixer"]))
    learner.update_targets()
    draws = _imagine_draws(k_train, jargs.training_iters, jargs.batch_size, info["n_entities"])
    state2, jmetrics = jlearner.train_iters(state, samples, k_train, 0, 0)
    tmetrics = learner.train_iters(batch_to_torch(samples), 0, 0, imagine_draws=draws)

    for k in METRICS + ("im_loss",):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert_trees_close(tparams.to_flax_params(mac.agent),
                       unwrap(flax_tree_to_numpy(state2.params["agent"])), atol=1e-6)
    assert_trees_close(tparams.to_flax_params(learner.mixer),
                       unwrap(flax_tree_to_numpy(state2.params["mixer"])), atol=1e-6)
