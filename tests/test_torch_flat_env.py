"""refil_torch's flat combat env (``flat_battle``, the reference's ``sc2``)
against refil_tpu's: the sizes of every ``MAP_REGISTRY`` map; the reset and
a few steps of the same random legal actions on 3m, MMM (the Medivacs' heal
block), corridor (the surrounding pathing values) and 2c_vs_64zg (the
terrain heights), with the last-action, timestep and obs-as-state options;
and ``get_obs_st_masks`` under each choice of the agent-input blocks.

As in ``test_torch_combat_env.py``, the JAX step is compiled without XLA's
fusion pass, the reset's float planes are compared within the tolerance and
the port steps on from the JAX reset state. Bool and int planes equal,
float planes within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu.config import Args
from refil_tpu.envs.combat.flat_env import MAP_REGISTRY as JAX_MAPS
from refil_tpu.envs.combat.flat_env import FlatBattle as JaxFlat
from refil_torch.envs import ENV_REGISTRY
from refil_torch.envs.combat.flat_env import MAP_REGISTRY, FlatBattle
from test_torch_combat_env import _assert_same, _from_jax, _jax_reset_draws

B, STEPS = 4, 12


def test_map_registry_and_sizes_match_jax():
    assert MAP_REGISTRY == JAX_MAPS
    assert ENV_REGISTRY["sc2"] is FlatBattle and ENV_REGISTRY["flat_battle"] is FlatBattle
    for name in MAP_REGISTRY:
        for kw in ({}, {"obs_pathing_grid": True, "obs_terrain_height": True,
                        "obs_last_action": True, "obs_timestep_number": True,
                        "state_timestep_number": True}, {"obs_instead_of_state": True}):
            env, jenv = FlatBattle(map_name=name, **kw), JaxFlat(map_name=name, **kw)
            assert env.env_info() == jenv.env_info(), (name, kw)
            np.testing.assert_array_equal(env.core.terrain_height.numpy(),
                                          np.asarray(jenv.core.terrain_height))
            np.testing.assert_array_equal(env.core.pathing_grid.numpy(),
                                          np.asarray(jenv.core.pathing_grid))
    with pytest.raises(ValueError, match="Unknown map"):
        FlatBattle(map_name="4m")
    with pytest.raises(ValueError, match="flat-scheme"):
        FlatBattle(entity_scheme=True)


def _core_from_jax(jstate, state):
    return state._replace(core=_from_jax(jstate.core, state.core),
                          last_action=torch.tensor(np.asarray(jstate.last_action)))


@pytest.mark.parametrize("map_name,kw", [
    ("3m", {"obs_last_action": True, "state_timestep_number": True}),
    ("MMM", {"obs_timestep_number": True}),
    ("corridor", {"obs_pathing_grid": True, "obs_instead_of_state": True}),
    ("2c_vs_64zg", {"obs_terrain_height": True, "obs_pathing_grid": True}),
])
def test_flat_env_matches_jax(map_name, kw):
    jenv, env = JaxFlat(map_name=map_name, **kw), FlatBattle(map_name=map_name, **kw)
    key = jax.random.PRNGKey(len(map_name))
    jstate, jobs = jax.jit(jenv.reset, static_argnums=1)(key, B)
    state, obs = env.reset(B, draws=_jax_reset_draws(jenv.core, key, B))
    _assert_same(obs, jobs, "reset obs")
    state = _core_from_jax(jstate, state)

    Na = env.n_agents
    jstep = jax.jit(jenv.step).lower(
        jstate, jnp.zeros((B, Na), jnp.int32), jax.random.PRNGKey(0),
    ).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})
    rng = np.random.default_rng(0)
    attacked = healed = False
    is_medivac = env.core.is_medivac_t[state.core.a_type].numpy()
    for t in range(STEPS):
        avail = np.asarray(jobs["avail_actions"])
        actions = np.array([[rng.choice(np.flatnonzero(a)) for a in row] for row in avail])
        attacked |= bool(((actions >= 6) & ~is_medivac).any())
        healed |= bool(((actions >= 6) & is_medivac).any())
        jstate, jobs, jrew, jdone, jinfo = jstep(jstate, jnp.asarray(actions, jnp.int32),
                                                jax.random.PRNGKey(t))
        state, obs, rew, done, info = env.step(state, torch.as_tensor(actions))
        what = f"{map_name} step {t}"
        _assert_same(state.core, jstate.core._asdict(), what)
        _assert_same({"last_action": state.last_action},
                     {"last_action": jstate.last_action}, what)
        _assert_same(obs, jobs, what)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-5, err_msg=what)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone), err_msg=what)
        for k in env.final_info_keys:
            np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]), err_msg=what)
    assert attacked  # the attack translation ran
    assert healed or not env.core.has_medivac  # and, on MMM, the heal translation


@pytest.mark.parametrize("last_action,agent_id,instead", [
    (True, True, False), (False, False, False), (True, False, True), (False, False, True)])
def test_obs_st_masks_match_jax(last_action, agent_id, instead):
    args = Args(obs_last_action=last_action, obs_agent_id=agent_id)
    for name in ("3m", "MMM", "2s3z"):
        env = FlatBattle(map_name=name, obs_instead_of_state=instead, obs_last_action=True)
        jenv = JaxFlat(map_name=name, obs_instead_of_state=instead, obs_last_action=True)
        for got, ref in zip(env.get_obs_st_masks(args), jenv.get_obs_st_masks(args)):
            np.testing.assert_array_equal(got, ref)
        info = env.env_info(args)
        obs_masks, state_masks = info["masks"]
        assert state_masks.shape == (env.n_agents + env.n_enemies, info["state_shape"])
        assert (state_masks.sum(0) >= 1).all()  # every state element has an owner
