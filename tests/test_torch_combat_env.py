"""refil_torch's combat env against refil_tpu's on the same draws: the reset
given the draws JAX takes from its key splits, then 40 steps of the same
random legal actions, on five scenario sets (Marines; Stalkers and Zealots;
Marines, Marauders and Medivacs, whose heal branch runs; Stalkers, Zealots and
Colossi; and the asymmetric 6-11m_mandown, one Marine fewer than the enemy)
at three difficulty tiers. Bool and int planes equal, float planes within 1e-5.

A trajectory is a chain of range checks that one ulp can flip some steps
later, so both sides compute op by op: the JAX step is compiled without
XLA's fusion pass, which on the CPU would contract the sum of squares in a
norm into a fused multiply-add. The reset's float planes are compared within
the tolerance (XLA's float32 sin and cos and PyTorch's differ in the last ulp
for a few percent of angles); the port then steps on from the JAX reset
state, so the 40 steps that follow are compared from the same start."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu.envs.combat.env import EntityBattle as JaxBattle
from refil_tpu.envs.combat.scenarios import SCENARIO_REGISTRY as JAX_SCENARIOS
from refil_torch.envs.combat.env import EntityBattle
from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY

B, STEPS = 8, 40


def _jax_reset_draws(env, key, B):
    """The draws ``refil_tpu/envs/combat/env.py:reset`` takes from its key."""
    k_scen, k_theta, k_jit_a, k_jit_e, k_tag_a, k_tag_e = jax.random.split(key, 6)
    perm = lambda k, n: jax.vmap(lambda kk: jax.random.permutation(kk, n))(  # noqa: E731
        jax.random.split(k, B))
    draws = {
        "scen": jax.random.randint(k_scen, (B,), 0, env.sc.n_scenarios),
        "u_theta": jax.random.uniform(k_theta, (B,)),
        "u_jit_a": jax.random.uniform(k_jit_a, (B, env.n_groups_a, 2)),
        "u_jit_e": jax.random.uniform(k_jit_e, (B, env.n_groups_e, 2)),
        "perm_e": perm(k_tag_e, env.n_tags_e),
        "perm_a": perm(k_tag_a, env.n_tags_a),
    }
    return {k: np.array(v) for k, v in draws.items()}


def _assert_same(got, ref, what):
    for k in ref:
        g = got[k].numpy() if isinstance(got, dict) else getattr(got, k).numpy()
        r = np.asarray(ref[k] if isinstance(ref, dict) else getattr(ref, k))
        assert g.shape == r.shape, (what, k, g.shape, r.shape)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype), err_msg=f"{what} {k}")


def _from_jax(jstate, like):
    """The JAX state as the port's CombatState, in the port's dtypes."""
    return like._replace(**{k: torch.tensor(np.asarray(v)).to(getattr(like, k).dtype)
                            for k, v in jstate._asdict().items()})


@pytest.mark.parametrize("difficulty", ["1", "7", "A"])
@pytest.mark.parametrize("scenario", ["1-5m_symmetric", "3-8sz_symmetric", "3-8MMM_symmetric",
                                      "3-8csz_symmetric", "6-11m_mandown"])
def test_combat_env_matches_jax(scenario, difficulty):
    check_env(scenario, difficulty, zlib.crc32((scenario + difficulty).encode()) % 1000)


def check_env(scenario, difficulty, seed):
    jenv = JaxBattle(scenario_dict=JAX_SCENARIOS[scenario](), difficulty=difficulty)
    env = EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), difficulty=difficulty)
    assert env.env_info() == jenv.env_info()
    if scenario == "3-8sz_symmetric":
        assert env.get_entity_size() == 38

    key = jax.random.PRNGKey(seed)
    jstate, jobs = jenv.reset(key, B)
    state, obs = env.reset(B, draws=_jax_reset_draws(jenv, key, B))
    _assert_same(state, jstate._asdict(), "reset state")
    _assert_same(obs, jobs, "reset obs")
    state = _from_jax(jstate, state)

    jstep = jax.jit(jenv.step).lower(
        jstate, jnp.zeros((B, env.env_info()["n_agents"]), jnp.int32), jax.random.PRNGKey(0),
    ).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})
    rng = np.random.default_rng(0)
    healed = False
    for t in range(STEPS):
        avail = np.asarray(jobs["avail_actions"])
        # a random legal action per agent
        actions = np.array([[rng.choice(np.flatnonzero(a)) for a in row] for row in avail])
        if env.has_medivac:
            healed |= bool((actions >= 6 + env.n_tags_e).any())
        jstate, jobs, jrew, jdone, jinfo = jstep(jstate, jnp.asarray(actions, jnp.int32),
                                                jax.random.PRNGKey(t))
        state, obs, rew, done, info = env.step(state, torch.as_tensor(actions))
        what = f"step {t}"
        _assert_same(state, jstate._asdict(), what)
        _assert_same(obs, jobs, what)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-5, err_msg=what)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone), err_msg=what)
        for k in env.final_info_keys:
            np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]), err_msg=what)
    if env.has_medivac:
        assert healed  # the heal branch ran
