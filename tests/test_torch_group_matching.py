"""The torch Group Matching env: bit-exact against the committed golden
trajectories (through the ``reset_draws``/``step_draws`` recipe) and step for
step against the JAX env on identical draws."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_matching_host import reset_draws, step_draws
from refil_tpu.envs.group_matching import GroupMatching as JaxGM
from refil_torch.envs.group_matching import GroupMatching

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "group_matching_seed*.npz")))
N_EPISODES = 3


def _cfg(blob):
    seed, n_agents, n_states, n_groups, limit = blob["config"].tolist()
    return dict(seed=seed, n_agents=n_agents, n_states=n_states, n_groups=n_groups,
                episode_limit=limit, rand_trans=float(blob["rand_trans"]))


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_torch_env_reproduces_golden(path):
    blob = np.load(path)
    cfg = _cfg(blob)
    env = GroupMatching(n_agents=cfg["n_agents"], n_states=cfg["n_states"],
                        n_groups=cfg["n_groups"], rand_trans=cfg["rand_trans"],
                        episode_limit=cfg["episode_limit"])
    rs = np.random.RandomState(cfg["seed"])  # one stream across all episodes
    for i in range(N_EPISODES):
        perm, partitions, locs0 = reset_draws(rs, cfg["n_agents"], cfg["n_groups"],
                                              cfg["n_states"])
        state, obs = env.reset(1, draws=(perm[None], partitions[None], locs0[None]))
        np.testing.assert_array_equal(obs["entities"][0].numpy(), blob[f"ep{i}_groups"])
        np.testing.assert_array_equal(obs["gt_mask"][0].numpy().astype(np.uint8),
                                      blob[f"ep{i}_gt_mask"])
        g_locs, g_actions = blob[f"ep{i}_locs"], blob[f"ep{i}_actions"]
        g_rewards = blob[f"ep{i}_rewards"]
        np.testing.assert_array_equal(state.locs[0].numpy(), g_locs[0])
        done = False
        for t in range(g_actions.shape[0]):
            rand_u, rand_a = step_draws(rs, g_actions[t], cfg["rand_trans"])
            state, obs, rew, done, info = env.step(
                state, torch.as_tensor(g_actions[t])[None],
                draws=(torch.as_tensor(rand_u)[None], torch.as_tensor(rand_a)[None]))
            np.testing.assert_array_equal(state.locs[0].numpy(), g_locs[t + 1])
            assert abs(float(rew[0]) - g_rewards[t]) < 1e-6, (t, float(rew[0]), g_rewards[t])
        assert bool(done[0])
        assert bool(info["solved"][0]) == bool(blob[f"ep{i}_solved"])


@pytest.mark.parametrize("seed,n_groups", [(0, 2), (1, 3), (2, 2)])
def test_torch_env_matches_jax_env_on_identical_draws(seed, n_groups):
    N, S, B, T = 8, 6, 4, 50
    rng = np.random.default_rng(seed)
    jenv = JaxGM(n_agents=N, n_states=S, n_groups=n_groups, rand_trans=0.3, episode_limit=T)
    tenv = GroupMatching(n_agents=N, n_states=S, n_groups=n_groups, rand_trans=0.3,
                         episode_limit=T)
    perm = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    mid = rng.integers(0, N, (B, n_groups - 1))
    partitions = np.concatenate([np.zeros((B, 1)), mid, np.full((B, 1), N)], 1).astype(np.int32)
    locs = rng.integers(0, S, (B, N)).astype(np.int32)

    from refil_tpu.envs.group_matching import GroupMatchingState

    member = jenv.membership_from_partitions(jnp.asarray(perm), jnp.asarray(partitions))
    jl = jnp.asarray(locs)
    jstate = GroupMatchingState(locs=jl, member=member,
                                prev_matches=jenv._matches(jl, member, S),
                                t=jnp.zeros((B,), jnp.int32))
    jobs = jenv.observe(jstate)
    tstate, tobs = tenv.reset(B, draws=(perm, partitions, locs))

    def same_obs(a, b):
        for k in ("entities", "obs_mask", "entity_mask", "gt_mask", "avail_actions"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)

    same_obs(jobs, tobs)
    np.testing.assert_array_equal(tstate.member.numpy(), np.asarray(member))
    for t in range(T):
        actions = rng.integers(0, 3, (B, N))
        rand_u = rng.random((B, N)).astype(np.float32)
        rand_a = rng.integers(0, 3, (B, N))
        locs_n = jenv.transition(jstate.locs, jnp.asarray(actions, jnp.int32),
                                 jnp.asarray(rand_u), jnp.asarray(rand_a, jnp.int32),
                                 jenv.rand_trans, S)
        matches = jenv._matches(locs_n, jstate.member, S)
        j_rew = -0.1 + 2.5 * (matches - jstate.prev_matches).astype(jnp.float32)
        jstate = GroupMatchingState(locs=locs_n, member=jstate.member, prev_matches=matches,
                                    t=jstate.t + 1)
        j_done = (matches == n_groups) | (jstate.t == T)
        tstate, tobs, rew, done, info = tenv.step(
            tstate, torch.as_tensor(actions), draws=(torch.as_tensor(rand_u),
                                                     torch.as_tensor(rand_a)))
        np.testing.assert_array_equal(tstate.locs.numpy(), np.asarray(locs_n))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(j_rew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))
        np.testing.assert_array_equal(info["episode_limit"].numpy(), np.asarray(jstate.t == T))
        same_obs(jenv.observe(jstate), tobs)


def test_overlapping_and_empty_groups_and_generator_draws():
    env = GroupMatching(n_agents=6, n_states=5, n_groups=3, rand_trans=0.0)
    jenv = JaxGM(n_agents=6, n_states=5, n_groups=3, rand_trans=0.0)
    perm = np.array([[3, 1, 5, 0, 2, 4]])
    partitions = np.array([[0, 4, 2, 6]])  # middle out of order: empty + overlap
    state, obs = env.reset(1, draws=(perm, partitions, np.zeros((1, 6), np.int64)))
    member = jenv.membership_from_partitions(jnp.asarray(perm), jnp.asarray(partitions))
    np.testing.assert_array_equal(state.member.numpy(), np.asarray(member))
    assert int(state.prev_matches[0]) == int(jenv._matches(jnp.zeros((1, 6), jnp.int32),
                                                           member, 5)[0])
    # generator draws: reproducible, and valid ranges
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    s1, o1 = env.reset(16, generator=g1)
    s2, o2 = env.reset(16, generator=g2)
    assert torch.equal(s1.locs, s2.locs) and torch.equal(s1.member, s2.member)
    assert int(s1.locs.min()) >= 0 and int(s1.locs.max()) < 5
    assert all(sorted(row) == list(range(6)) for row in env.draw_reset(4, g1)[0].tolist())
