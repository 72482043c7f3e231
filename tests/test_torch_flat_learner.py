"""The flat path's numerical core as a whole: refil_torch's QLearner with
``qmix.yaml`` (``BasicMAC``, ``RNNAgent``, ``QMixer`` with two-layer
hypernets over the flat state) against refil_tpu's, on one
``(training_iters, batch, L, ...)`` sample of the episodes the JAX runner
played on flat_battle 3m, with the same parameters loaded into both:
metrics after the 8 RMSprop updates at rtol 1e-5 (atol 1e-7), parameters
at atol 1e-6, at narrow widths and a short episode limit, the JAX GRU on
the XLA scan and on the Pallas kernel in interpret mode."""
import jax
import numpy as np
import pytest
import torch

import refil_tpu.ops.pallas_gru as pg
from refil_tpu import config as jconfig
from refil_tpu.controllers.mac import BasicMAC as JaxBasicMAC
from refil_tpu.core.buffer import ReplayBuffer as JaxBuffer
from refil_tpu.learners.q_learner import QLearner as JaxLearner
from refil_tpu.run import _dummy_batch
from refil_tpu.run import build_env as jax_build_env
from refil_tpu.runners.vector_runner import VectorRunner as JaxRunner
from refil_torch import config as tconfig
from refil_torch import params as tparams
from refil_torch.controllers.mac import BasicMAC
from refil_torch.learners.q_learner import QLearner
from refil_torch.run import build_env
from torch_parity import assert_trees_close, batch_to_torch, flax_tree_to_numpy, unwrap

NARROW = ["env_args.episode_limit=16", "rnn_hidden_dim=16", "hypernet_embed=16",
          "mixing_embed_dim=8", "batch_size_run=16", "batch_size=8"]
METRICS = ("loss", "loss_td", "grad_norm", "td_error_abs", "q_taken_mean", "target_mean")


def _args(cfg_mod, extra=()):
    cfg = cfg_mod.args_sanity_check(
        cfg_mod.load_config(alg="qmix", env="sc2", overrides=NARROW + list(extra)))
    args = cfg_mod.config_to_args(cfg)
    args.entity_scheme = False
    return args


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_gru(request):
    impl = pg.get_gru_impl()
    if request.param == "pallas_interpret":
        pg.set_gru_impl("pallas")
        pg._INTERPRET = True
    yield request.param
    pg.set_gru_impl(impl)
    pg._INTERPRET = False


def test_qmix_learner_matches_jax(jax_gru):
    jargs = _args(jconfig)
    jenv = jax_build_env(jargs)
    info = jenv.env_info(jargs)
    jargs.obs_masks, jargs.state_masks = info["masks"]
    jmac = JaxBasicMAC(jargs, info)
    key = jax.random.PRNGKey(0)
    key, k_init, k_r1, k_r2, k_train = jax.random.split(key, 5)
    jlearner = JaxLearner(jmac, jargs, info, k_init)
    state = jlearner.init_state(k_init, _dummy_batch(jmac, info))

    runner = JaxRunner(jenv, jmac, jargs)
    b1 = runner.run(state.params["agent"], k_r1)
    b2 = runner.run(state.params["agent"], k_r2)
    ring = JaxBuffer(b1, 32, seed=0)
    ring.insert_episode_batch(b1)
    ring.insert_episode_batch(b2)
    samples = ring.sample_many(jargs.training_iters, jargs.batch_size)
    assert samples["obs"].shape[:3] == (8, 8, 17)
    assert samples["state"].shape == (8, 8, 17, info["state_shape"])
    assert np.asarray(samples["reward"]).any()  # the random play hit something

    targs = _args(tconfig, ["use_cuda=False"])
    env = build_env(targs, torch.device("cpu"))
    tinfo = env.env_info(targs)
    assert {k: v for k, v in tinfo.items() if k != "masks"} == \
        {k: v for k, v in info.items() if k != "masks"}
    targs.obs_masks, targs.state_masks = tinfo["masks"]
    mac = BasicMAC(targs, tinfo, "cpu")
    learner = QLearner(mac, targs, tinfo, "cpu")
    np.testing.assert_array_equal(learner.mixer.state_masks.numpy(), jargs.state_masks)
    loaded_mixer = flax_tree_to_numpy(state.params["mixer"])  # train_iters donates state
    tparams.load_flax_params(mac.agent, flax_tree_to_numpy(state.params["agent"]))
    tparams.load_flax_params(learner.mixer, loaded_mixer)
    learner.update_targets()

    state2, jmetrics = jlearner.train_iters(state, samples, k_train, 0, 0)
    tmetrics = learner.train_iters(batch_to_torch(samples), 0, 0)
    assert set(METRICS) == set(jmetrics) == set(tmetrics)
    for k in METRICS:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert_trees_close(tparams.to_flax_params(mac.agent),
                       unwrap(flax_tree_to_numpy(state2.params["agent"])), atol=1e-6)
    assert_trees_close(tparams.to_flax_params(learner.mixer),
                       unwrap(flax_tree_to_numpy(state2.params["mixer"])), atol=1e-6)
    # and the targets still hold the loaded parameters
    assert_trees_close(tparams.to_flax_params(learner.target_mixer),
                       unwrap(loaded_mixer), atol=0)


def test_scheme_mismatch_raises():
    """An entity mixer on the flat scheme, and an entity agent in the flat
    controller, are refused by name."""
    targs = _args(tconfig, ["use_cuda=False", "mixer=flex_qmix", "attn_embed_dim=16",
                            "attn_n_heads=2"])
    env = build_env(targs, torch.device("cpu"))
    info = env.env_info(targs)
    mac = BasicMAC(targs, info, "cpu")
    with pytest.raises(ValueError, match="entities"):
        QLearner(mac, targs, info, "cpu")
    targs.agent = "entity_attend_rnn"
    with pytest.raises(ValueError, match="flat-scheme agent"):
        BasicMAC(targs, info, "cpu")
