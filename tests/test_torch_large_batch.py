"""refil_torch's fused pipeline and loop in the large-batch regime of the JAX
package's throughput configurations (``bench.py``: batch_size_run 512 and
4096 against a batch of 32, a target sync every 200 episodes and a ring of
B or 2 B), on the CPU at small sizes: batch_size_run 16 against batch_size
4, so one warm-up block, and target_update_interval 8, so a target sync in
every train block.

* The train half of a block against the JAX ``FusedPipeline.block`` over two
  train blocks after the warm-up block, with a ring of exactly B (each
  insert overwrites the whole ring) and of 2 B: Group Matching at the size
  of ``tests/test_pipeline.py:_setup`` (parameters and targets within 1e-6,
  metrics within rtol 1e-5, ``last_target_episode`` exactly: the tolerances
  of ``test_torch_pipeline.py``), and the combat scheme at narrow widths in
  ``compute_dtype=bfloat16`` (within 2e-2 of max(1, |x|), the bf16 learner's
  tolerance in ``test_torch_combat_learner.py``). The port's own blocks keep
  the counters JAX keeps.
* The fused CLI on Group Matching at batch_size_run 16 with test_nepisode 4
  and test_interval below one block's steps, against the JAX CLI at the same
  flags: every test rollout is B wide, and the blocks of each dispatch and
  the t_env of every logged ``test_`` stat are the JAX run's. Episodes of
  one step (``episode_limit=1``) make t_env the same in both packages,
  whose random streams differ.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import refil_tpu.core.pipeline as jax_pipeline_mod
from refil_tpu import config as jconfig
from refil_tpu.controllers.mac import EntityMAC as JaxMAC
from refil_tpu.learners.q_learner import QLearner as JaxLearner
from refil_tpu.run import _dummy_batch
from refil_tpu.run import build_env as jax_build_env
from refil_tpu.runners.vector_runner import VectorRunner as JaxRunner
from refil_torch import config as tconfig
from refil_torch import main as tmain
from refil_torch import params as tparams
from refil_torch import run as trun
from refil_torch.core.pipeline import FusedPipeline
from test_pipeline import _setup as jax_gm_setup
from test_torch_learner import _imagine_draws
from torch_parity import assert_trees_close, flax_tree_to_numpy, unwrap

B, BATCH, INTERVAL, ITERS = 16, 4, 8, 2
LARGE = dict(batch_size_run=B, batch_size=BATCH, target_update_interval=INTERVAL,
             training_iters=ITERS)
GM_SIZE = ["env_args.n_agents=3", "env_args.n_states=4", "env_args.episode_limit=5",
           "attn_embed_dim=8", "attn_n_heads=2", "hypernet_embed=8", "mixing_embed_dim=8"]
COMBAT_SIZE = ["scenario=1-5m_symmetric", "env_args.episode_limit=12", "attn_embed_dim=16",
               "hypernet_embed=16", "mixing_embed_dim=8", "attn_n_heads=2", "rnn_hidden_dim=16",
               "compute_dtype=bfloat16"]
COUNTERS = ("buffer_index", "episodes_in_buffer", "episode", "last_target_episode")


def _overrides(ring, size):
    return [f"{k}={v}" for k, v in {**LARGE, "buffer_size": ring}.items()] + size


def _jax_combat_setup(ring):
    """The JAX pipeline of ``refil`` on ``entity_battle`` at COMBAT_SIZE."""
    cfg = jconfig.load_config(alg="refil", env="entity_battle",
                              overrides=_overrides(ring, COMBAT_SIZE))
    args = jconfig.config_to_args(jconfig.args_sanity_check(cfg))
    args.entity_scheme = True
    env = jax_build_env(args)
    info = env.env_info()
    for k in ("n_agents", "n_actions", "n_entities", "entity_shape"):
        setattr(args, k, info[k])
    args.gt_mask_avail = info.get("gt_mask_avail", False)
    mac = JaxMAC(args, info)
    key = jax.random.PRNGKey(0)
    learner = JaxLearner(mac, args, info, key)
    state = learner.init_state(key, _dummy_batch(mac, info))
    runner = JaxRunner(env, mac, args, logger=None)
    return jax_pipeline_mod.FusedPipeline(runner, learner, args.buffer_size, args), state


def _port(alg, env, ring, size):
    cfg = tconfig.load_config(alg=alg, env=env,
                              overrides=_overrides(ring, size) + ["use_cuda=False"])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, learner, gens = trun.build_training(args, None, torch.device("cpu"))
    pipe = FusedPipeline(runner, learner, args.buffer_size, args)
    return pipe, pipe.init_state(gens["sample"]), learner, args


def _load(learner, params, targets):
    for module, tree in ((learner.mac.agent, params["agent"]), (learner.mixer, params["mixer"]),
                         (learner.target_mac.agent, targets["agent"]),
                         (learner.target_mixer, targets["mixer"])):
        tparams.load_flax_params(module, tree)


def _train_blocks_match_jax(jpipe, jps, pipe, ps, learner, args, tol):
    """Two JAX train blocks after the warm-up block. The port takes the JAX
    parameters and targets after the warm-up block, and before each train
    block the JAX counters; after each it trains, from its own learner
    state, on the JAX ring with JAX's sampled slots and imagine and
    diagnostic draws.
    ``tol`` None: the f32 tolerances, else |a - b| <= tol max(1, |b|)."""
    assert jpipe.warmup_blocks() == pipe.warmup_blocks() == 1
    jps, _ = jpipe.block(jps, train=False)
    _load(learner, flax_tree_to_numpy(jps.train.params),
          flax_tree_to_numpy(jps.train.target_params))
    for _ in range(2):
        episode, last_target = int(jps.episode), int(jps.last_target_episode)
        _, _, k_sample, k_train, k_diag = jax.random.split(jps.key, 5)
        jps, jstats = jpipe.block(jps, train=True)
        ring = {k: np.asarray(v) for k, v in jps.buffer.items()}
        idx = np.asarray(jpipe._sample_idx(k_sample, jps.episodes_in_buffer))
        jmetrics = jax.device_get(jstats["metrics"])

        for k, buf in ps.ring.items():
            assert tuple(buf.shape) == ring[k].shape, k
            buf.copy_(torch.as_tensor(np.array(ring[k])))
        ps.episodes_in_buffer.fill_(int(jps.episodes_in_buffer))
        ps.episode.fill_(episode)
        ps.last_target_episode.fill_(last_target)
        ne = ring["entities"].shape[2]
        draws = {"idx": torch.as_tensor(np.array(idx)).long(),
                 "imagine": _imagine_draws(k_train, ITERS, BATCH, ne)}
        if pipe.gt_diag:
            key_p, key_b = jax.random.split(k_diag)
            gp = jax.random.uniform(key_p, (BATCH, 1, 1))
            ga = jax.random.bernoulli(key_b, gp, (BATCH, 1, ne))
            draws["diag"] = (torch.as_tensor(np.array(gp)), torch.as_tensor(np.array(ga)))
        metrics = pipe.train_half(ps, draws=draws)

        assert set(metrics) == set(jmetrics)
        for k in sorted(metrics):
            got, want = float(metrics[k]), float(jmetrics[k])
            if tol is None:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=k)
            else:
                assert abs(got - want) <= tol * max(1.0, abs(want)), (k, got, want)
        for name, tree in (("params", jps.train.params), ("targets", jps.train.target_params)):
            modules = ((learner.mac.agent, learner.mixer) if name == "params"
                       else (learner.target_mac.agent, learner.target_mixer))
            for module, part in zip(modules, ("agent", "mixer")):
                want = unwrap(flax_tree_to_numpy(tree[part]))
                got = tparams.to_flax_params(module)
                if tol is None:
                    assert_trees_close(got, want, atol=1e-6)
                else:
                    assert_trees_close(got, want, atol=tol, rtol=tol)
        # a target sync in every train block: pre-increment episode - last >= 8
        assert int(ps.last_target_episode) == int(jps.last_target_episode) == episode
    return jps


def _own_blocks_keep_jax_counters(pipe, ps, jps):
    """The port's own warm-up and two train blocks leave the counters the
    JAX blocks left (they do not depend on the random streams)."""
    pipe.block(ps, train=False)
    for _ in range(2):
        stats = pipe.block(ps, train=True)
        assert np.isfinite(stats["metrics"]["loss"])
    for k in COUNTERS:
        assert int(getattr(ps, k)) == int(getattr(jps, k)), k


@pytest.mark.parametrize("ring", [B, 2 * B])
def test_group_matching_train_blocks_match_jax(ring):
    jpipe, _, _, jstate, _ = jax_gm_setup(buffer_size=ring, **LARGE)
    pipe, ps, learner, args = _port("refil_group_matching", "group_matching", ring, GM_SIZE)
    assert pipe.buffer_size == jpipe.buffer_size == ring
    jps = _train_blocks_match_jax(jpipe, jpipe.init_state(jstate, jax.random.PRNGKey(1)), pipe,
                                  ps, learner, args, tol=None)
    assert int(jps.buffer_index) == 3 * B % ring
    _own_blocks_keep_jax_counters(*_port("refil_group_matching", "group_matching", ring,
                                         GM_SIZE)[:2], jps)


def test_combat_bf16_train_blocks_match_jax():
    jpipe, jstate = _jax_combat_setup(B)
    pipe, ps, learner, args = _port("refil", "entity_battle", B, COMBAT_SIZE)
    assert learner.mac.agent.dtype == learner.mixer.dtype == torch.bfloat16
    jps = _train_blocks_match_jax(jpipe, jpipe.init_state(jstate, jax.random.PRNGKey(1)), pipe,
                                  ps, learner, args, tol=2e-2)
    _own_blocks_keep_jax_counters(*_port("refil", "entity_battle", B, COMBAT_SIZE)[:2], jps)


CLI = ["--config=refil_group_matching", "--env-config=group_matching", "with", "seed=3",
       "env_args.n_agents=3", "env_args.n_states=4", "env_args.episode_limit=1",
       "batch_size_run=16", "batch_size=4", "buffer_size=32", "target_update_interval=8",
       "training_iters=2", "attn_embed_dim=8", "attn_n_heads=2", "hypernet_embed=8",
       "mixing_embed_dim=8", "test_nepisode=4", "test_interval=12", "t_max=100"]


def _test_stats(results_dir):
    """[(key, t_env)] of every logged ``test_`` stat, in order."""
    mdir = os.path.join(results_dir, "metrics")
    (name,) = os.listdir(mdir)
    with open(os.path.join(mdir, name)) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [(r["key"], r["t"]) for r in rows if r["key"].startswith("test_")]


def test_fused_cli_test_cadence_matches_jax(tmp_path, monkeypatch):
    from refil_tpu.main import main as jmain

    jax_dispatches, jax_tests = [], []
    orig_pipeline = jax_pipeline_mod.FusedPipeline
    orig_run = JaxRunner.run

    class Capture(orig_pipeline):
        def run_blocks(self, ps, n_blocks, train=True):
            jax_dispatches.append(n_blocks)
            return super().run_blocks(ps, n_blocks, train=train)

    def run(self, *a, test_mode=False, batch_size=None, **kw):
        if test_mode:
            jax_tests.append(batch_size)
        return orig_run(self, *a, test_mode=test_mode, batch_size=batch_size, **kw)

    monkeypatch.setattr(jax_pipeline_mod, "FusedPipeline", Capture)
    monkeypatch.setattr(JaxRunner, "run", run)
    jmain(CLI + [f"local_results_path={tmp_path / 'jax'}"])
    summary = tmain.main(CLI + ["use_cuda=False", f"local_results_path={tmp_path / 'torch'}"])

    # each block (16 one-step episodes) crosses test_interval 12: one block a
    # dispatch, and a test rollout of all 16 envs after each
    assert summary["loop"] == "fused"
    assert [d["blocks"] for d in summary["dispatches"]] == jax_dispatches == [1] * 7
    assert [t["episodes"] for t in summary["tests"]] == jax_tests == [B] * 7
    assert [t["t_env"] for t in summary["tests"]] == [B * (i + 1) for i in range(7)]
    assert summary["test_blocks"] == 7
    stats = _test_stats(str(tmp_path / "torch"))
    assert stats == _test_stats(str(tmp_path / "jax"))
    assert ("test_return_mean", B) in stats
