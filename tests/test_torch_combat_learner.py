"""The combat slice's numerical core as a whole: refil_torch's QLearner on
``entity_battle`` against refil_tpu's, on one ``(training_iters, batch, L,
...)`` sample of episodes that the JAX runner produced on 1-5m_symmetric,
with the same parameters loaded into both and the JAX imagine draws handed
to the port, for each combat learner config: ``refil`` (its JAX GRU on the
XLA scan and on the Pallas kernel in interpret mode), ``refil_vdn``,
``vdn_atten`` and ``qmix_atten``. REFIL's imagined path also on
3-8MMM_symmetric (Medivacs, which heal) and 3-8csz_symmetric (Colossi), 16
entity slots with absent ones, on episodes in which units die (a dead unit
stays in ``entity_mask`` but its ``obs_mask`` row blocks every other
entity), with ``qmix_atten`` on 3-8MMM_symmetric as the control. Metrics after 4 RMSprop updates at rtol
1e-5, parameters at atol 1e-5, at narrow widths; and ``refil`` at
``compute_dtype=bfloat16``, metrics and parameters within the bf16
tolerance 2e-2 (relative to max(1, |x|))."""
import jax
import numpy as np
import pytest
import torch

import refil_tpu.ops.pallas_gru as pg
from refil_tpu import config as jconfig
from refil_tpu.controllers.mac import EntityMAC as JaxMAC
from refil_tpu.core.buffer import ReplayBuffer as JaxBuffer
from refil_tpu.learners.q_learner import QLearner as JaxLearner
from refil_tpu.run import _dummy_batch
from refil_tpu.run import build_env as jax_build_env
from refil_tpu.runners.vector_runner import VectorRunner as JaxRunner
from refil_torch import config as tconfig
from refil_torch import params as tparams
from refil_torch.controllers.mac import EntityMAC
from refil_torch.learners.q_learner import QLearner
from refil_torch.run import build_env
from torch_parity import assert_trees_close, batch_to_torch, flax_tree_to_numpy, unwrap

NARROW = ["env_args.episode_limit=12", "attn_embed_dim=16",
          "hypernet_embed=16", "mixing_embed_dim=8", "attn_n_heads=2", "rnn_hidden_dim=16",
          "batch_size_run=16", "batch_size=8", "training_iters=4"]
METRICS = ("loss", "loss_td", "im_loss", "grad_norm", "td_error_abs", "q_taken_mean",
           "target_mean")


def _args(cfg_mod, alg="refil", extra=(), scenario="1-5m_symmetric"):
    cfg = cfg_mod.args_sanity_check(cfg_mod.load_config(
        alg=alg, env="entity_battle", overrides=[f"scenario={scenario}"] + NARROW + list(extra)))
    args = cfg_mod.config_to_args(cfg)
    args.entity_scheme = True
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


def _death_shares(samples):
    """(absent, dead): the share of filled entity-steps whose slot is absent
    from the scenario, and of those present whose unit is dead."""
    em = np.asarray(samples["entity_mask"]).astype(bool)
    om = np.asarray(samples["obs_mask"]).astype(bool)
    filled = np.asarray(samples["filled"]).astype(bool)[..., 0]
    dead = (om | np.eye(om.shape[-1], dtype=bool)).all(-1) & ~em
    present = ~em & filled[..., None]
    return float(em[filled].mean()), float(dead[present].mean())


def _combat_learner_vs_jax(alg, extra=(), tol=None, scenario="1-5m_symmetric"):
    """Runs both learners on the same sample; ``tol`` None: rtol 1e-5 on the
    metrics and atol 1e-5 on the parameters, else |a - b| <= tol max(1, |b|)
    on both."""
    jargs = _args(jconfig, alg, extra, scenario)
    jenv = jax_build_env(jargs)
    info = jenv.env_info()
    jmac = JaxMAC(jargs, info)
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
    assert samples["entities"].shape[:4] == (
        jargs.training_iters, jargs.batch_size, info["episode_limit"] + 1, info["n_entities"])
    absent, dead = _death_shares(samples)
    print(f"{scenario}: absent {absent:.4f}, dead {dead:.4f} of the entity-steps")
    assert dead > 0, "no unit dies inside the episodes: the deaths' masks go unchecked"

    targs = _args(tconfig, alg, list(extra) + ["use_cuda=False"], scenario)
    env = build_env(targs, torch.device("cpu"))
    assert env.env_info() == info
    mac = EntityMAC(targs, info, "cpu")
    learner = QLearner(mac, targs, info, "cpu")
    tparams.load_flax_params(mac.agent, flax_tree_to_numpy(state.params["agent"]))
    modules = {"agent": mac.agent}
    if "mixer" in state.params and state.params["mixer"]:
        tparams.load_flax_params(learner.mixer, flax_tree_to_numpy(state.params["mixer"]))
        modules["mixer"] = learner.mixer
    learner.update_targets()

    draws = None
    if learner.is_imagine:
        draws = []
        for k in jax.random.split(k_train, jargs.training_iters):
            key_p, key_b = jax.random.split(k)  # the draws masks.py takes from the key
            gp = jax.random.uniform(key_p, (jargs.batch_size, 1, 1))
            ga = jax.random.bernoulli(key_b, gp, (jargs.batch_size, 1, info["n_entities"]))
            draws.append((torch.as_tensor(np.array(gp)), torch.as_tensor(np.array(ga))))
    state2, jmetrics = jlearner.train_iters(state, samples, k_train, 0, 0)
    tmetrics = learner.train_iters(batch_to_torch(samples), 0, 0, imagine_draws=draws)

    names = set(METRICS) - (set() if learner.is_imagine else {"im_loss"})
    assert names == set(jmetrics) == set(tmetrics)
    for k in sorted(names):
        got, want = float(tmetrics[k]), float(jmetrics[k])
        if tol is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            assert abs(got - want) <= tol * max(1.0, abs(want)), (k, got, want)
    for name, module in modules.items():
        want = unwrap(flax_tree_to_numpy(state2.params[name]))
        if tol is None:
            assert_trees_close(tparams.to_flax_params(module), want, atol=1e-5)
        else:
            assert_trees_close(tparams.to_flax_params(module), want, atol=tol, rtol=tol)
    assert learner.gt_diagnostics(batch_to_torch({k: v[-1] for k, v in samples.items()})) is None
    return learner


def test_combat_learner_matches_jax(jax_gru):
    _combat_learner_vs_jax("refil")


@pytest.mark.parametrize("alg", ["refil_vdn", "vdn_atten", "qmix_atten"])
def test_combat_learner_configs_match_jax(alg):
    learner = _combat_learner_vs_jax(alg)
    assert learner.is_imagine == (alg == "refil_vdn")


def test_combat_learner_bf16_matches_jax():
    learner = _combat_learner_vs_jax("refil", ["compute_dtype=bfloat16"], tol=2e-2)
    assert learner.mac.agent.dtype == learner.mixer.dtype == torch.bfloat16


@pytest.mark.parametrize("alg,scenario", [("refil", "3-8MMM_symmetric"),
                                          ("refil", "3-8csz_symmetric"),
                                          ("qmix_atten", "3-8MMM_symmetric")])
def test_combat_learner_scenarios_match_jax(alg, scenario):
    learner = _combat_learner_vs_jax(alg, scenario=scenario)
    assert learner.is_imagine == (alg == "refil")
