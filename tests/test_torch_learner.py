"""The slice's numerical core as a whole: refil_torch's QLearner against
refil_tpu's on one ``(training_iters, 32, 51, ...)`` sample of episodes that
the JAX runner produced, with the same parameters loaded into both and the
JAX imagine draws handed to the port. Metrics after ``training_iters`` RMSprop
updates at rtol 1e-5, parameters at atol 1e-6, for both Group Matching
configs, at narrow widths."""
import jax
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
from refil_torch import config as tconfig
from refil_torch import params as tparams
from refil_torch.controllers.mac import EntityMAC
from refil_torch.envs.group_matching import GroupMatching
from refil_torch.learners.q_learner import QLearner
from torch_parity import assert_trees_close, batch_to_torch, flax_tree_to_numpy, unwrap

NARROW = ["attn_embed_dim=16", "hypernet_embed=16", "mixing_embed_dim=8", "attn_n_heads=2",
          "rnn_hidden_dim=16", "batch_size_run=32",
          "env_args.n_states=3"]  # 3 cells: random play solves some episodes early
METRICS = ("loss", "loss_td", "grad_norm", "td_error_abs", "q_taken_mean", "target_mean")


def _args(cfg_mod, alg, extra=()):
    cfg = cfg_mod.args_sanity_check(
        cfg_mod.load_config(alg=alg, env="group_matching", overrides=NARROW + list(extra)))
    args = cfg_mod.config_to_args(cfg)
    args.entity_scheme = True
    return args


def _imagine_draws(key, n_iters, B, Ne):
    """The draws ``q_learner.py:255`` and ``masks.py:108-110`` make from the key."""
    draws = []
    for k in jax.random.split(key, n_iters):
        key_p, key_b = jax.random.split(k)
        gp = jax.random.uniform(key_p, (B, 1, 1))
        ga = jax.random.bernoulli(key_b, gp, (B, 1, Ne))
        draws.append((torch.as_tensor(np.array(gp)), torch.as_tensor(np.array(ga))))
    return draws


@pytest.mark.parametrize("alg", ["refil_group_matching", "qmix_atten_group_matching"])
def test_learner_matches_jax_after_training_iters(alg):
    jargs = _args(jconfig, alg)
    jenv = JaxGM(**jargs.env_args)
    info = jenv.env_info()
    jmac = JaxMAC(jargs, info)
    key = jax.random.PRNGKey(0)
    key, k_init, k_r1, k_r2, k_train, k_diag = jax.random.split(key, 6)
    jlearner = JaxLearner(jmac, jargs, info, k_init)
    state = jlearner.init_state(k_init, _dummy_batch(jmac, info))

    # 64 episodes from the JAX runner, then one sample_many from the JAX ring
    runner = JaxRunner(jenv, jmac, jargs)
    b1 = runner.run(state.params["agent"], k_r1)
    b2 = runner.run(state.params["agent"], k_r2)
    ring = JaxBuffer(b1, 64, seed=0)
    ring.insert_episode_batch(b1)
    ring.insert_episode_batch(b2)
    samples = ring.sample_many(jargs.training_iters, jargs.batch_size)
    assert samples["entities"].shape[:3] == (8, 32, 51)
    assert not np.asarray(samples["filled"]).all()  # some episodes end early

    targs = _args(tconfig, alg, ["use_cuda=False"])
    env = GroupMatching(**targs.env_args)
    mac = EntityMAC(targs, env.env_info(), "cpu")
    learner = QLearner(mac, targs, env.env_info(), "cpu")
    tparams.load_flax_params(mac.agent, flax_tree_to_numpy(state.params["agent"]))
    tparams.load_flax_params(learner.mixer, flax_tree_to_numpy(state.params["mixer"]))
    learner.update_targets()

    Ne = info["n_entities"]
    draws = _imagine_draws(k_train, jargs.training_iters, jargs.batch_size, Ne) \
        if learner.is_imagine else None
    state2, jmetrics = jlearner.train_iters(state, samples, k_train, 0, 0)
    tmetrics = learner.train_iters(batch_to_torch(samples), 0, 0, imagine_draws=draws)

    names = METRICS + (("im_loss",) if learner.is_imagine else ())
    assert set(names) == set(jmetrics) == set(tmetrics)
    for k in names:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert_trees_close(tparams.to_flax_params(mac.agent),
                       unwrap(flax_tree_to_numpy(state2.params["agent"])), atol=1e-6)
    assert_trees_close(tparams.to_flax_params(learner.mixer),
                       unwrap(flax_tree_to_numpy(state2.params["mixer"])), atol=1e-6)

    last = {k: v[-1] for k, v in samples.items()}
    jdiag = jlearner.gt_diagnostics(state2, last, k_diag)
    key_p, key_b = jax.random.split(k_diag)
    gp = jax.random.uniform(key_p, (jargs.batch_size, 1, 1))
    ga = jax.random.bernoulli(key_b, gp, (jargs.batch_size, 1, Ne))
    tdiag = learner.gt_diagnostics(batch_to_torch(last), imagine_draws=(
        torch.as_tensor(np.array(gp)), torch.as_tensor(np.array(ga))))
    if jdiag is None:
        assert tdiag is None
    else:
        for k in ("ingroup_prop", "gt_ingroup_prop"):
            np.testing.assert_allclose(float(tdiag[k]), float(jdiag[k]), rtol=1e-5, err_msg=k)

    # the target networks sync on the episode cadence, not before
    learner._maybe_update_targets(targs.target_update_interval - 1)
    p, tp = next(mac.agent.parameters()), next(learner.target_mac.agent.parameters())
    assert not torch.equal(p, tp)
    learner._maybe_update_targets(targs.target_update_interval)
    assert all(torch.equal(a, b) for a, b in zip(mac.agent.parameters(),
                                                 learner.target_mac.agent.parameters()))


def test_optax_clip_rule_and_td_lambda_refused():
    targs = _args(tconfig, "refil_group_matching", ["use_cuda=False", "grad_norm_clip=1e-3"])
    env = GroupMatching(**targs.env_args)
    mac = EntityMAC(targs, env.env_info(), "cpu", generator=torch.Generator().manual_seed(0))
    learner = QLearner(mac, targs, env.env_info(), "cpu",
                       generator=torch.Generator().manual_seed(1),
                       init_generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(0)
    B, L, N, A, D = 2, 6, 8, 3, env.env_info()["entity_shape"]
    batch = {
        "entities": torch.as_tensor(rng.random((B, L, N, D)).astype(np.float32)),
        "obs_mask": torch.zeros((B, L, N, N), dtype=torch.bool),
        "entity_mask": torch.zeros((B, L, N), dtype=torch.bool),
        "gt_mask": torch.as_tensor(rng.random((B, L, N, N)) < 0.5),
        "avail_actions": torch.ones((B, L, N, A), dtype=torch.bool),
        "actions": torch.as_tensor(rng.integers(0, A, (B, L, N))),
        "actions_onehot": torch.zeros((B, L, N, A)),
        "reward": torch.as_tensor(rng.standard_normal((B, L, 1)).astype(np.float32)),
        "terminated": torch.zeros((B, L, 1), dtype=torch.bool),
        "filled": torch.ones((B, L, 1), dtype=torch.bool),
    }
    learner.train_step(batch)
    # optax clip_by_global_norm: clipped grads have exactly the clip's norm
    clipped = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                    for p in learner.params]))
    np.testing.assert_allclose(float(clipped), 1e-3, rtol=1e-4)

    # TD(lambda) is ported (tests/test_torch_td_lambda.py); the flat state's
    # QMixer is too (tests/test_torch_flat_learner.py), and on an entity env,
    # which has no state, it is refused by name
    with pytest.raises(ValueError, match="flat scheme's state"):
        QLearner(mac, _args(tconfig, "refil_group_matching", ["mixer=qmix"]),
                 env.env_info(), "cpu")
