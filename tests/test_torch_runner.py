"""refil_torch's lockstep runner and replay ring.

* A greedy rollout (epsilon 0) with injected env draws equals the JAX env +
  JAX ``EntityMAC.forward_step`` stepped by hand here with the same draws and
  weights: the whole batch dict.
* The filled / terminated / actions_onehot invariants on an episode that
  solves at its first step.
* The ring against the JAX ring: wraparound, sampling without replacement
  from the same index stream, and bf16 feature storage cast back on read.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu import config as jconfig
from refil_tpu.components.action_selectors import epsilon_greedy as jax_epsilon_greedy
from refil_tpu.controllers.mac import EntityMAC as JaxMAC
from refil_tpu.core.buffer import ReplayBuffer as JaxBuffer
from refil_tpu.core.schedules import DecayThenFlatSchedule as JaxSchedule
from refil_tpu.envs.group_matching import GroupMatching as JaxGM
from refil_tpu.envs.group_matching import GroupMatchingState
from refil_torch import config as tconfig
from refil_torch import params as tparams
from refil_torch.components.action_selectors import epsilon_greedy
from refil_torch.controllers.mac import EntityMAC
from refil_torch.core.buffer import FEATURE_RING_KEYS, ReplayBuffer
from refil_torch.core.schedules import DecayThenFlatSchedule
from refil_torch.envs.group_matching import GroupMatching
from refil_torch.runners.vector_runner import VectorRunner
from torch_parity import flax_tree_to_numpy

B, N, S, G, T = 6, 8, 3, 2, 12
OVERRIDES = ["attn_embed_dim=16", "attn_n_heads=2", "rnn_hidden_dim=16",
             f"batch_size_run={B}", f"env_args.n_states={S}", f"env_args.episode_limit={T}"]


def _args(cfg_mod, alg="refil_group_matching", extra=()):
    cfg = cfg_mod.load_config(alg=alg, env="group_matching", overrides=OVERRIDES + list(extra))
    return cfg_mod.config_to_args(cfg)


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    perm = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    mid = rng.integers(0, N, (B, G - 1))
    partitions = np.concatenate([np.zeros((B, 1)), mid, np.full((B, 1), N)], 1).astype(np.int32)
    locs = rng.integers(0, S, (B, N)).astype(np.int32)
    locs[0] = 0  # env 0 starts piled up ...
    rand_u = rng.random((T, B, N)).astype(np.float32)
    rand_a = rng.integers(0, 3, (T, B, N)).astype(np.int32)
    rand_u[0, 0], rand_a[0, 0] = 0.0, 1  # ... and is forced to stay: solved at step 0
    return perm, partitions, locs, rand_u, rand_a


def _jax_rollout(jenv, jmac, params, draws):
    """The reference's lockstep semantics, stepped by hand."""
    perm, partitions, locs, rand_u, rand_a = draws
    member = jenv.membership_from_partitions(jnp.asarray(perm), jnp.asarray(partitions))
    jl = jnp.asarray(locs)
    state = GroupMatchingState(locs=jl, member=member, prev_matches=jenv._matches(jl, member, S),
                               t=jnp.zeros((B,), jnp.int32))
    obs = jenv.observe(state)
    hidden = jmac.init_hidden(B)
    last_oh = jnp.zeros((B, N, 3))
    alive = np.ones(B, bool)
    rows = {k: [np.asarray(v)] for k, v in obs.items()}
    acts, rews, terms, fills = [], [], [], []
    for t in range(T):
        q, hidden = jmac.forward_step(params, obs, last_oh, hidden)
        a = np.asarray(jnp.argmax(jnp.where(obs["avail_actions"], q, -jnp.inf), -1))
        locs_n = jenv.transition(state.locs, jnp.asarray(a), jnp.asarray(rand_u[t]),
                                 jnp.asarray(rand_a[t]), jenv.rand_trans, S)
        matches = jenv._matches(locs_n, state.member, S)
        rew = np.asarray(-0.1 + 2.5 * (matches - state.prev_matches).astype(jnp.float32))
        new = GroupMatchingState(locs=locs_n, member=state.member, prev_matches=matches,
                                 t=state.t + 1)
        limit = np.asarray(new.t == T)
        done = np.asarray(matches == G) | limit
        keep = jnp.asarray(alive)
        state = jax.tree.map(lambda n, o: jnp.where(keep.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
                             new, state)
        obs = jenv.observe(state)
        a = np.where(alive[:, None], a, 0)
        last_oh = jax.nn.one_hot(a, 3) * alive[:, None, None]
        for k, v in obs.items():
            rows[k].append(np.asarray(v) * alive.reshape((B,) + (1,) * (v.ndim - 1)))
        acts.append(a)
        rews.append(rew * alive)
        terms.append(done & ~limit & alive)
        fills.append(alive.copy())
        alive = alive & ~done
    batch = {k: np.stack(v, 1).astype(np.asarray(obs[k]).dtype) for k, v in rows.items()}
    pad = lambda x: np.concatenate([x, np.zeros_like(x[:, :1])], 1)  # noqa: E731
    batch["actions"] = pad(np.stack(acts, 1))
    batch["reward"] = pad(np.stack(rews, 1))[..., None]
    batch["terminated"] = pad(np.stack(terms, 1))[..., None]
    filled = np.stack(fills, 1)[..., None]
    batch["filled"] = np.concatenate([np.ones_like(filled[:, :1]), filled], 1)
    written = np.concatenate([batch["filled"][:, 1:, 0], np.zeros((B, 1), bool)], 1)
    batch["actions_onehot"] = np.eye(3, dtype=np.float32)[batch["actions"]] * written[..., None, None]
    return batch


def test_greedy_rollout_matches_jax_stepped_by_hand():
    jargs = _args(jconfig)
    jenv = JaxGM(**jargs.env_args)
    info = jenv.env_info()
    jmac = JaxMAC(jargs, info)
    params = jmac.init_params(jax.random.PRNGKey(0))
    draws = _draws()
    ref = _jax_rollout(jenv, jmac, params, draws)

    targs = _args(tconfig, extra=["use_cuda=False"])
    env = GroupMatching(**targs.env_args)
    mac = EntityMAC(targs, env.env_info(), "cpu")
    tparams.load_flax_params(mac.agent, flax_tree_to_numpy(params))
    runner = VectorRunner(env, mac, targs, generator=torch.Generator().manual_seed(0))
    perm, partitions, locs, rand_u, rand_a = draws
    batch, stats = runner.rollout(0.0, B, env_draws={
        "reset": (perm, partitions, locs),
        "step": [(torch.as_tensor(rand_u[t]), torch.as_tensor(rand_a[t])) for t in range(T)]})

    assert set(batch) == set(ref)
    for k in ref:
        got = batch[k].numpy()
        assert got.shape == ref[k].shape, k
        np.testing.assert_array_equal(got, ref[k], err_msg=k)
    np.testing.assert_allclose(stats["ep_returns"], ref["reward"].sum((1, 2)), atol=1e-5)
    np.testing.assert_array_equal(stats["ep_lengths"], ref["filled"][:, 1:, 0].sum(1))

    # env 0 solved at its first step: the reference's filled/terminated rules
    f, term = batch["filled"][0, :, 0].numpy(), batch["terminated"][0, :, 0].numpy()
    assert f[:2].all() and not f[2:].any()
    assert term[0] and not term[1:].any()
    assert stats["final_info"]["solved"][0] == 1.0
    ao = batch["actions_onehot"][0].numpy()
    assert (ao[0].sum(-1) == 1).all() and not ao[1:].any()
    assert not batch["reward"][0, 1:].any() and not batch["entities"][0, 2:].any()
    # an env that runs to the limit is never terminated and always filled
    limit_envs = stats["ep_lengths"] == T
    assert limit_envs.any()
    assert batch["filled"][limit_envs].all() and not batch["terminated"][limit_envs].any()


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
def test_ring_matches_jax_ring(feature_dtype):
    rng = np.random.default_rng(1)

    def episodes(n):
        return {
            "entities": rng.standard_normal((n, 4, 3, 5)).astype(np.float32),
            "actions_onehot": rng.random((n, 4, 3, 2)).astype(np.float32),
            "reward": rng.standard_normal((n, 4, 1)).astype(np.float32),
            "filled": rng.random((n, 4, 1)) < 0.8,
            "actions": rng.integers(0, 2, (n, 4, 3)).astype(np.int32),
        }

    blocks = [episodes(3) for _ in range(3)]  # 9 episodes into a ring of 7: wraps
    jring = JaxBuffer({k: jnp.asarray(v) for k, v in blocks[0].items()}, 7, seed=3,
                      feature_dtype=feature_dtype)
    tring = ReplayBuffer({k: torch.as_tensor(v) for k, v in blocks[0].items()}, 7, seed=3,
                         feature_dtype=feature_dtype)
    for blk in blocks:
        jring.insert_episode_batch({k: jnp.asarray(v) for k, v in blk.items()})
        tring.insert_episode_batch({k: torch.as_tensor(v) for k, v in blk.items()})
    assert (tring.index, tring.episodes_in_buffer) == (jring.index, jring.episodes_in_buffer) == (2, 7)
    for k, buf in tring.data.items():
        want = torch.bfloat16 if (feature_dtype == "bfloat16" and k in FEATURE_RING_KEYS) \
            else torch.as_tensor(blocks[0][k]).dtype
        assert buf.dtype == want, k
        np.testing.assert_array_equal(buf.float().numpy(), np.asarray(jring.data[k], np.float32))
    # the two newest episodes overwrote slots 0 and 1
    np.testing.assert_array_equal(tring.data["reward"][:2].numpy(), blocks[2]["reward"][1:])

    assert not tring.can_sample(8) and tring.can_sample(7)
    for _ in range(2):
        js, ts = jring.sample(5), tring.sample(5)
        for k in js:
            assert ts[k].dtype == torch.as_tensor(blocks[0][k]).dtype  # cast back on read
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    jm, tm = jring.sample_many(4, 6), tring.sample_many(4, 6)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    # without replacement: no episode twice within one sample
    rewards = tm["reward"][:, :, 0, 0].numpy()
    assert all(len(set(row.tolist())) == 6 for row in rewards)


@pytest.mark.parametrize("epsilon", [0.0, 0.5, 1.0])
def test_epsilon_greedy_matches_jax_on_its_draws(epsilon):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, 4, 6)).astype(np.float32)
    avail = rng.random((5, 4, 6)) < 0.6
    avail[..., 0] = True
    key = jax.random.PRNGKey(3)
    ref = jax_epsilon_greedy(key, jnp.asarray(q), jnp.asarray(avail), jnp.float32(epsilon))
    k_pick, k_rand = jax.random.split(key)  # the draws epsilon_greedy makes from its key
    rand_actions = jax.random.categorical(k_rand, jnp.where(jnp.asarray(avail), 0.0, -jnp.inf))
    pick = jax.random.uniform(k_pick, (5, 4)) < epsilon
    got = epsilon_greedy(torch.as_tensor(q), torch.as_tensor(avail), epsilon,
                         pick_random=torch.as_tensor(np.array(pick)),
                         random_actions=torch.as_tensor(np.array(rand_actions)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # its own draws pick only available actions
    own = epsilon_greedy(torch.as_tensor(q), torch.as_tensor(avail), 1.0,
                         generator=torch.Generator().manual_seed(0))
    assert torch.as_tensor(avail).gather(2, own[..., None]).all()


def test_mac_last_action_block_matches_jax():
    """``entity_last_action``: the last action's one-hot in the first Na
    entity rows, zeros at t=0 and in the other rows."""
    extra = ["entity_last_action=True", "agent=entity_attend_ff"]
    jargs = _args(jconfig, extra=extra)
    info = JaxGM(**jargs.env_args).env_info()
    jmac = JaxMAC(jargs, info)
    params = jmac.init_params(jax.random.PRNGKey(1))
    targs = _args(tconfig, extra=extra + ["use_cuda=False"])
    mac = EntityMAC(targs, info, "cpu")
    tparams.load_flax_params(mac.agent, flax_tree_to_numpy(params))
    rng = np.random.default_rng(5)
    L = 4
    acts = rng.integers(0, 3, (2, L, N))
    batch = {
        "entities": rng.random((2, L, N, info["entity_shape"])).astype(np.float32),
        "obs_mask": rng.random((2, L, N, N)) < 0.2,
        "entity_mask": np.zeros((2, L, N), bool),
        "gt_mask": rng.random((2, L, N, N)) < 0.5,
        "actions_onehot": np.eye(3, dtype=np.float32)[acts],
    }
    jin = jmac.build_episode_inputs({k: jnp.asarray(v) for k, v in batch.items()})
    tin = mac.build_episode_inputs({k: torch.as_tensor(v) for k, v in batch.items()})
    for a, b in zip(tin, jin):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jq = jmac.forward_episode(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tq = mac.forward_episode({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5)
    obs = {k: torch.as_tensor(v[:, 1]) for k, v in batch.items() if k != "actions_onehot"}
    last = torch.as_tensor(batch["actions_onehot"][:, 0])
    q, _ = mac.forward_step(obs, last, mac.init_hidden(2))
    np.testing.assert_allclose(q.detach().numpy(), tq[:, 1].detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("decay", ["linear", "exp"])
def test_schedule_matches_jax(decay):
    """The host schedule equals the JAX one's ``eval_host``; the tensor one
    equals its traced ``eval`` in float32, bit for bit."""
    jsched = JaxSchedule(1.0, 0.05, 5000, decay=decay)
    sched = DecayThenFlatSchedule(1.0, 0.05, 5000, decay=decay)
    for t in (0, 1, 2500, 4999, 5000, 10 ** 6):
        assert sched.eval_host(t) == jsched.eval_host(t)
        got = sched.eval(torch.tensor(float(t)))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsched.eval(jnp.float32(t))))
