"""refil_torch's scripted ally policy (``EntityBattle.heuristic_actions``,
``heuristic_ai``) against refil_tpu's on the same states: a JAX rollout of
20 steps driven by the JAX heuristic itself, the port's heuristic on each
state carried over (``_from_jax``) equal to JAX's as integers, in both emit
modes (``heuristic_rest``), on Marines, Stalkers and Zealots, and Marines,
Marauders and Medivacs (whose heal targets it picks). As in
``test_torch_combat_env.py``, the JAX function is compiled without XLA's
fusion pass, so both sides compute the distances op by op.

Then the port's counterparts of ``tests/test_heuristic.py``: it beats random
play, its actions are valid, and under ``heuristic_rest`` always legal; and
the runner acts with it under both spellings of ``heuristic_ai``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu.envs.combat.env import EntityBattle as JaxBattle
from refil_tpu.envs.combat.scenarios import SCENARIO_REGISTRY as JAX_SCENARIOS
from refil_torch.envs.combat.env import EntityBattle
from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY
from test_torch_combat_env import _from_jax, _jax_reset_draws

@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes on one thread: more gain nothing, and a loaded machine
    loses much."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, STEPS = 8, 20


@pytest.mark.parametrize("rest", [False, True])
@pytest.mark.parametrize("scenario", ["1-5m_symmetric", "3-8sz_symmetric", "3-8MMM_symmetric"])
def test_heuristic_matches_jax(scenario, rest):
    jenv = JaxBattle(scenario_dict=JAX_SCENARIOS[scenario](), heuristic_rest=rest)
    env = EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), heuristic_rest=rest)
    key = jax.random.PRNGKey(11 + rest)
    jstate, jobs = jenv.reset(key, B)
    state, _ = env.reset(B, draws=_jax_reset_draws(jenv, key, B))
    zero = jnp.zeros((B, env.max_na), jnp.int32)
    opts = {"xla_disable_hlo_passes": "fusion"}
    jheur = jax.jit(jenv.heuristic_actions).lower(jstate, jobs["avail_actions"]).compile(
        compiler_options=opts)
    jstep = jax.jit(jenv.step).lower(jstate, zero, jax.random.PRNGKey(0)).compile(
        compiler_options=opts)
    healed = False
    for t in range(STEPS):
        want = np.asarray(jheur(jstate, jobs["avail_actions"]))
        got = env.heuristic_actions(_from_jax(jstate, state),
                                    torch.as_tensor(np.array(jobs["avail_actions"])))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"step {t}")
        if env.has_medivac:
            healed |= bool((want >= 6 + env.n_tags_e).any())
        jstate, jobs, _, _, _ = jstep(jstate, jnp.asarray(want), jax.random.PRNGKey(t))
    if env.has_medivac:
        assert healed  # a Medivac picked a damaged ally


def _battle(scenario, **kw):
    return EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), **kw)


def test_heuristic_beats_random():
    env = _battle("1-5m_symmetric")
    gen = torch.Generator().manual_seed(2)

    def run(policy):
        state, obs = env.reset(8, generator=torch.Generator().manual_seed(3))
        total, done_all = torch.zeros(8), torch.zeros(8, dtype=torch.bool)
        for _ in range(60):
            if policy == "heuristic":
                acts = env.heuristic_actions(state)
            else:
                noise = torch.rand(obs["avail_actions"].shape, generator=gen)
                acts = (noise * obs["avail_actions"]).argmax(-1)
            state, obs, rew, done, _ = env.step(state, acts)
            total += rew * ~done_all
            done_all |= done
            if done_all.all():
                break
        return float(total.mean())

    r_h, r_r = run("heuristic"), run("random")
    # focused fire and chasing clearly beat random play
    assert r_h > r_r + 1.0, (r_h, r_r)


def test_heuristic_actions_valid():
    env = _battle("3-8MMM_symmetric")
    state, _ = env.reset(4, generator=torch.Generator().manual_seed(0))
    acts = env.heuristic_actions(state)
    assert acts.shape == (4, env.max_na)
    assert (acts >= 0).all() and (acts < env.n_actions).all()


@pytest.mark.parametrize("scenario", ["3-8MMM_symmetric", "1-5m_symmetric"])
def test_heuristic_actions_always_legal(scenario):
    """Under heuristic_rest every action is available at every step of a
    rollout, Medivacs included."""
    env = _battle(scenario, heuristic_rest=True)
    state, obs = env.reset(6, generator=torch.Generator().manual_seed(4))
    for t in range(40):
        avail = obs["avail_actions"]
        acts = env.heuristic_actions(state, avail)
        ok = avail.gather(-1, acts[..., None])[..., 0]
        assert ok.all(), (t, torch.nonzero(~ok), acts[~ok])
        state, obs, _, done, _ = env.step(state, acts)
        if done.all():
            break


@pytest.mark.parametrize("spelling", ["heuristic_ai=True", "env_args.heuristic_ai=True"])
def test_runner_acts_with_the_heuristic(spelling):
    """The runner's dispatch: every action of a rollout is the heuristic's on
    the state it acted in (the agent still steps), under either spelling of
    the knob; Group Matching's env has no heuristic, so its runner selects
    as usual (JAX ``vector_runner.py:138-141``)."""
    from refil_torch import config as tconfig
    from refil_torch import run as trun

    cfg = tconfig.load_config(alg="refil", env="entity_battle", overrides=[
        "scenario=3-8MMM_symmetric", "attn_embed_dim=16", "hypernet_embed=16",
        "mixing_embed_dim=8", "attn_n_heads=2", "rnn_hidden_dim=16", "batch_size_run=4",
        "env_args.episode_limit=12", "use_cuda=False", spelling])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, _, _ = trun.build_training(args, None, torch.device("cpu"))
    assert runner.heuristic
    seen = []
    heur = runner.env.heuristic_actions

    def spy(state, avail=None):
        seen.append(heur(state, avail))
        return seen[-1]

    runner.env.heuristic_actions = spy
    batch, _ = runner.rollout(1.0, 4)
    steps = batch["filled"][:, 1:, 0]  # the steps each env acted in
    assert len(seen) == runner.episode_limit
    acted = torch.stack(seen, 1)
    assert torch.equal(batch["actions"][:, :-1][steps], acted[steps])

    gm = tconfig.load_config(alg="refil_group_matching", env="group_matching",
                             overrides=["use_cuda=False", spelling])
    gm_runner, _, _ = trun.build_training(tconfig.config_to_args(
        tconfig.args_sanity_check(gm)), None, torch.device("cpu"))
    assert not gm_runner.heuristic
