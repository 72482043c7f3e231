"""refil_torch's fused block pipeline (``core/pipeline.py``) on the CPU, at
the Group Matching size of ``tests/test_pipeline.py:_setup`` (3 agents, 4
states, episodes of 5, widths 8, 2 heads).

* The train half of a block against the JAX ``FusedPipeline.block``: the
  port starts from the JAX ring after that block, the slots JAX sampled and
  its imagine and diagnostic draws; parameters and targets agree within
  1e-6, metrics within rtol 1e-5 (the tolerances of
  ``test_torch_learner.py``), ``last_target_episode`` exactly, with and
  without a target sync in the block.
* The ring and counters against JAX: capacity rounding, warm-up blocks, the
  storage dtype of each plane under ``buffer_dtype=bfloat16``.
* Mirrors of ``tests/test_pipeline.py`` on the port alone: a warm block
  equals a standalone rollout on the same generator state, the unaligned
  ring's insert, the target-sync cadence, ``run_blocks(3)`` against three
  ``block``s, and the Gumbel top-k sample.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_torch import config as tconfig
from refil_torch import params as tparams
from refil_torch import run as trun
from refil_torch.core.pipeline import FusedPipeline
from test_pipeline import _setup as jax_setup
from test_torch_learner import _imagine_draws
from torch_parity import assert_trees_close, flax_tree_to_numpy, unwrap

METRICS = ("loss", "loss_td", "im_loss", "grad_norm", "td_error_abs", "q_taken_mean",
           "target_mean", "ingroup_prop", "gt_ingroup_prop")


def _port(batch_size_run=4, batch_size=4, buffer_size=16, training_iters=2,
          target_update_interval=8, seed=0, **extra):
    """The port's pipeline at the size of ``tests/test_pipeline.py:_setup``."""
    overrides = [f"{k}={v}" for k, v in dict(
        batch_size_run=batch_size_run, batch_size=batch_size, buffer_size=buffer_size,
        training_iters=training_iters, target_update_interval=target_update_interval,
        attn_embed_dim=8, attn_n_heads=2, hypernet_embed=8, mixing_embed_dim=8, seed=seed,
        use_cuda=False, **extra).items()]
    overrides += ["env_args.n_agents=3", "env_args.n_states=4", "env_args.episode_limit=5"]
    cfg = tconfig.load_config(alg="refil_group_matching", env="group_matching",
                              overrides=overrides)
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, learner, gens = trun.build_training(args, None, torch.device("cpu"))
    pipe = FusedPipeline(runner, learner, args.buffer_size, args)
    return pipe, pipe.init_state(gens["sample"]), runner, learner, args


def _differs(a, b):
    return any(not torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("interval", [8, 4])  # pre-increment episode 4: no sync / a sync
def test_train_half_matches_jax_block(interval):
    jpipe, _, _, jstate, jargs = jax_setup(target_update_interval=interval)
    jps = jpipe.init_state(jstate, jax.random.PRNGKey(1))
    jps, _ = jpipe.block(jps, train=False)
    episode, last_target = int(jps.episode), int(jps.last_target_episode)
    params = flax_tree_to_numpy(jps.train.params)
    targets = flax_tree_to_numpy(jps.train.target_params)
    _, _, k_sample, k_train, k_diag = jax.random.split(jps.key, 5)
    jps, jstats = jpipe.block(jps, train=True)
    ring = {k: np.asarray(v) for k, v in jps.buffer.items()}
    idx = np.asarray(jpipe._sample_idx(k_sample, jps.episodes_in_buffer))
    jmetrics = jax.device_get(jstats["metrics"])

    pipe, ps, _, learner, args = _port(target_update_interval=interval)
    assert set(ps.ring) == set(ring)
    for k, buf in ps.ring.items():
        assert tuple(buf.shape) == ring[k].shape, k
        buf.copy_(torch.as_tensor(np.array(ring[k])))
    ps.episodes_in_buffer.fill_(int(jps.episodes_in_buffer))
    ps.episode.fill_(episode)
    ps.last_target_episode.fill_(last_target)
    for module, tree in ((learner.mac.agent, params["agent"]), (learner.mixer, params["mixer"]),
                         (learner.target_mac.agent, targets["agent"]),
                         (learner.target_mixer, targets["mixer"])):
        tparams.load_flax_params(module, tree)
    ne = ring["entities"].shape[2]
    key_p, key_b = jax.random.split(k_diag)
    gp = jax.random.uniform(key_p, (args.batch_size, 1, 1))
    ga = jax.random.bernoulli(key_b, gp, (args.batch_size, 1, ne))
    metrics = pipe.train_half(ps, draws={
        "idx": torch.as_tensor(np.array(idx)).long(),
        "imagine": _imagine_draws(k_train, args.training_iters, args.batch_size, ne),
        "diag": (torch.as_tensor(np.array(gp)), torch.as_tensor(np.array(ga)))})

    assert set(metrics) == set(jmetrics) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for module, ref in ((learner.mac.agent, jps.train.params["agent"]),
                        (learner.mixer, jps.train.params["mixer"]),
                        (learner.target_mac.agent, jps.train.target_params["agent"]),
                        (learner.target_mixer, jps.train.target_params["mixer"])):
        assert_trees_close(tparams.to_flax_params(module), unwrap(flax_tree_to_numpy(ref)),
                           atol=1e-6)
    assert int(ps.last_target_episode) == int(jps.last_target_episode) == (
        episode if interval == 4 else last_target)


def test_ring_and_counters_match_jax():
    # capacity rounds up to a multiple of batch_size_run, as JAX's does
    jpipe = jax_setup(batch_size_run=4, batch_size=4, buffer_size=10)[0]
    pipe, ps, runner, _, _ = _port(batch_size_run=4, batch_size=4, buffer_size=10)
    assert pipe.buffer_size == jpipe.buffer_size == 12
    assert ps.ring["entities"].shape[0] == 12
    for bs, bsr in ((4, 4), (8, 4), (9, 4), (2, 4)):
        assert _port(batch_size=bs, batch_size_run=bsr)[0].warmup_blocks() == \
            jax_setup(batch_size=bs, batch_size_run=bsr)[0].warmup_blocks()

    # the unaligned ring: starts 0, 4, 8 (the third block writes slots 8..11,
    # past the configured 10), then the index wraps to 0
    for _ in range(2):
        pipe.block(ps, train=False)
    assert int(ps.buffer_index) == 8
    gen_state = runner.generator.get_state()
    eps = runner.schedule.eval(ps.t_env.float())
    pipe.block(ps, train=False)
    runner.generator.set_state(gen_state)
    batch, _ = runner.rollout(eps, 4)
    assert int(ps.buffer_index) == 0 and int(ps.episodes_in_buffer) == 12
    for k in batch:
        torch.testing.assert_close(ps.ring[k][8:12], batch[k], rtol=0, atol=0, msg=k)

    # storage dtype of each plane under buffer_dtype=bfloat16
    jpipe, _, _, jstate, _ = jax_setup(buffer_dtype="bfloat16")
    jring = jpipe.init_state(jstate, jax.random.PRNGKey(0)).buffer
    ps = _port(buffer_dtype="bfloat16")[1]
    names = {jnp.bfloat16: "bfloat16", jnp.float32: "float32", jnp.bool_: "bool",
             jnp.int32: "int"}
    for k, buf in ps.ring.items():
        want = names[jring[k].dtype.type]
        got = "int" if buf.dtype == torch.int64 else str(buf.dtype).split(".")[1]
        assert got == want, (k, got, want)


def test_warm_block_matches_standalone_rollout():
    pipe, ps, runner, _, args = _port()
    gen_state = runner.generator.get_state()
    stats = pipe.block(ps, train=False)
    runner.generator.set_state(gen_state)
    batch, roll = runner.rollout(runner.schedule.eval(torch.tensor(0.0)), args.batch_size_run)
    B = args.batch_size_run
    for k in batch:
        torch.testing.assert_close(ps.ring[k][:B], batch[k], rtol=0, atol=0, msg=k)
        assert not ps.ring[k][B:].any(), k
    assert int(ps.episodes_in_buffer) == B and int(ps.buffer_index) == B % pipe.buffer_size
    assert int(ps.t_env) == int(roll["ep_lengths"].sum()) == int(stats["t_env"])
    np.testing.assert_array_equal(stats["ep_lengths"], roll["ep_lengths"].numpy())
    np.testing.assert_array_equal(stats["ep_returns"], roll["ep_returns"].numpy())
    assert float(stats["epsilon"]) == args.epsilon_start
    assert "metrics" not in stats and int(ps.episode) == B


def test_target_sync_cadence():
    pipe, ps, _, learner, _ = _port(target_update_interval=8)
    pipe.block(ps, train=False)  # episode -> 4
    before = [p.detach().clone() for p in learner.params]
    stats = pipe.block(ps, train=True)  # pre-increment episode 4 < 8: no sync
    assert np.isfinite(stats["metrics"]["loss"]) and _differs(learner.params, before)
    assert _differs(learner.params, learner.target_params), "targets lag before the cadence"
    assert int(ps.last_target_episode) == 0
    pipe.block(ps, train=True)  # pre-increment episode 8 >= 8: the sync, after the updates
    assert not _differs(learner.params, learner.target_params)
    assert int(ps.last_target_episode) == 8 and int(ps.episode) == 12


def test_run_blocks_matches_sequential_blocks():
    pipe_a, ps_a, _, learner_a, args = _port(seed=3)
    pipe_b, ps_b, _, learner_b, _ = _port(seed=3)
    for pipe, ps in ((pipe_a, ps_a), (pipe_b, ps_b)):
        pipe.block(ps, train=False)
    losses = [pipe_a.block(ps_a, train=True)["metrics"]["loss"] for _ in range(3)]
    stats = pipe_b.run_blocks(ps_b, 3, train=True)
    assert stats["ep_returns"].shape == (3, args.batch_size_run)
    assert stats["metrics"]["loss"].shape == (3,)
    np.testing.assert_allclose(stats["metrics"]["loss"], losses, rtol=1e-6)
    assert int(ps_a.t_env) == int(ps_b.t_env) == int(stats["t_env"][-1])
    for a, b in zip(learner_a.params, learner_b.params):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_sampling_only_hits_filled_slots():
    pipe = _port(buffer_size=32, training_iters=4000)[0]
    eib = torch.tensor(pipe.batch_size * 2, dtype=torch.int32)
    idx = pipe.sample_idx(eib, torch.Generator().manual_seed(9))
    assert idx.shape == (pipe.training_iters, pipe.batch_size) and idx.dtype == torch.int64
    assert int(idx.max()) < int(eib) and int(idx.min()) >= 0
    # without replacement within each row
    assert (idx.sort(dim=1).values.diff(dim=1) > 0).all()
    # uniform: each of the 8 filled slots is in a row with probability 1/2
    # (4000 rows: mean 2000, sd 32; 5 sd)
    counts = torch.bincount(idx.reshape(-1), minlength=int(eib))
    assert (counts - 2000).abs().max() < 160, counts
