"""refil_torch's eval-only runs (``run.py:evaluate_sequential``) and the
reference's env name ``sc2custom`` on the CPU, at narrow widths on
1-5m_symmetric (5 scenarios, episodes of 10).

* ``evaluate`` after a checkpoint load, with and without ``eval_all_scen``:
  the ``eval_path`` JSON has the keys the JAX package's
  ``evaluate_sequential`` writes for the same config (per scenario name
  under ``eval_all_scen``), and every episode of a scenario's rollout runs
  that scenario (its active allies and enemies).
* ``--env-config=sc2custom`` builds the combat env ``entity_battle`` builds,
  as ``refil_tpu/run.py:build_env`` does, and trains through the CLI.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from refil_torch import main as tmain
from refil_torch import run as trun
from refil_torch.config import args_sanity_check, config_to_args, load_config
from refil_torch.runners.vector_runner import VectorRunner

NARROW = ["scenario=1-5m_symmetric", "attn_embed_dim=16", "hypernet_embed=16",
          "mixing_embed_dim=8", "attn_n_heads=2", "rnn_hidden_dim=16", "batch_size_run=4",
          "batch_size=4", "training_iters=2", "test_nepisode=8", "env_args.episode_limit=10"]


def _checkpoint(tmp_path):
    """A checkpoint of a short classic combat run; returns its run directory."""
    summary = tmain.main(["--config=refil", "--env-config=sc2custom", "with", *NARROW,
                          "t_max=40", "use_fused_pipeline=False", "save_model=True",
                          "use_cuda=False", f"local_results_path={tmp_path / 'train'}"])
    return os.path.dirname(summary["saves"][-1]["path"])


def _jax_eval_json(tmp_path, all_scen):
    """The JSON the JAX package's ``evaluate_sequential`` writes for the same
    config, from freshly initialised parameters."""
    from refil_tpu import config as jconfig
    from refil_tpu.controllers.mac import EntityMAC as JaxMAC
    from refil_tpu.learners.q_learner import QLearner as JaxLearner
    from refil_tpu.run import _dummy_batch
    from refil_tpu.run import build_env as jax_build_env
    from refil_tpu.run import evaluate_sequential as jax_eval
    from refil_tpu.runners.vector_runner import VectorRunner as JaxRunner
    from refil_tpu.utils.logging import Logger as JaxLogger

    path = str(tmp_path / f"jax_{all_scen}.json")
    cfg = jconfig.args_sanity_check(jconfig.load_config(
        alg="refil", env="sc2custom",
        overrides=NARROW + [f"eval_all_scen={all_scen}", f"eval_path={path}"]))
    args = jconfig.config_to_args(cfg)
    args.entity_scheme = True
    env = jax_build_env(args)
    info = env.env_info()
    mac = JaxMAC(args, info)
    key = jax.random.PRNGKey(0)
    learner = JaxLearner(mac, args, info, key)
    state = learner.init_state(key, _dummy_batch(mac, info))
    logger = JaxLogger()
    jax_eval(args, JaxRunner(env, mac, args, logger), state, logger, key)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("all_scen", [True, False])
def test_evaluate_matches_jax_keys_and_scenarios(tmp_path, monkeypatch, all_scen):
    ckpt = _checkpoint(tmp_path)
    calls = []
    rollout = VectorRunner.rollout

    def record(self, epsilon, batch_size, test=False, env_draws=None, index=None,
               generator=None):
        batch, stats = rollout(self, epsilon, batch_size, test=test, env_draws=env_draws,
                               index=index, generator=generator)
        calls.append((index, test, float(epsilon), batch["entity_mask"][:, 0].clone()))
        return batch, stats

    monkeypatch.setattr(VectorRunner, "rollout", record)
    eval_path = str(tmp_path / "eval")
    summary = tmain.main(["--config=refil", "--env-config=sc2custom", "with", *NARROW,
                          "evaluate=True", f"eval_all_scen={all_scen}", f"checkpoint_path={ckpt}",
                          f"eval_path={eval_path}", "use_cuda=False",
                          f"local_results_path={tmp_path / 'eval_run'}"])
    assert summary["loop"] == "evaluate" and summary["restored"]["t_env"] == summary["t_env"]
    with open(eval_path + ".json") as f:
        got = json.load(f)
    assert got == summary["eval"]
    want = _jax_eval_json(tmp_path, all_scen)
    if all_scen:
        assert list(got) == list(want) == ["1Mar", "2Mar", "3Mar", "4Mar", "5Mar"]
        assert all(set(got[k]) == set(want[k]) for k in want)
    else:
        assert set(got) == set(want)
    assert all(np.isfinite(v) for r in (got.values() if all_scen else [got]) for v in r.values())

    # one greedy rollout of all of test_nepisode per scenario, each env on it
    assert len(calls) == (5 if all_scen else 1)
    env = trun.build_env(config_to_args(args_sanity_check(load_config(
        "refil", "sc2custom", NARROW + ["use_cuda=False"]))), torch.device("cpu"))
    for i, (index, test, eps, inactive) in enumerate(calls):
        assert test and eps == 0.0 and inactive.shape[0] == summary["eval_episodes"] == 8
        assert index == (i if all_scen else None)
        if all_scen:
            n_active = int(env.sc.ally_active[i].sum() + env.sc.enemy_active[i].sum())
            assert ((~inactive).sum(dim=1) == n_active).all(), (i, inactive)


def test_sc2custom_builds_the_entity_battle_env():
    envs = {}
    for name in ("sc2custom", "entity_battle"):
        cfg = args_sanity_check(load_config("refil", name, NARROW + ["use_cuda=False"]))
        args = config_to_args(cfg)
        assert args.env == name
        envs[name] = trun.build_env(args, torch.device("cpu"))
    a, b = envs["sc2custom"], envs["entity_battle"]
    assert type(a) is type(b) and a.env_info() == b.env_info()
    assert a.scenario_names == b.scenario_names == ["1Mar", "2Mar", "3Mar", "4Mar", "5Mar"]
    _, obs_a = a.reset(6, generator=torch.Generator().manual_seed(4))
    _, obs_b = b.reset(6, generator=torch.Generator().manual_seed(4))
    for k in obs_b:
        torch.testing.assert_close(obs_a[k], obs_b[k], rtol=0, atol=0, msg=k)


def test_cli_trains_on_sc2custom_and_the_classic_loop_times_its_phases(tmp_path):
    """The reference's command line (``--env-config=sc2custom``); the
    classic loop logs its rollout and train phase times, as JAX's does."""
    summary = tmain.main(["--config=refil", "--env-config=sc2custom", "with", *NARROW,
                          "scenario=3-8sz_symmetric", "t_max=60", "use_fused_pipeline=False",
                          "use_cuda=False", f"local_results_path={tmp_path}"])
    assert summary["loop"] == "classic" and summary["updates"] >= 1
    assert np.isfinite(summary["last_metrics"]["loss"])
    for k in ("time_rollout_ms", "time_train_ms", "battle_won_mean"):
        assert k in summary["last_logged"], k
