"""refil_torch's replays and eval videos against refil_tpu's: ``render_state``
and a recording step's render extras (``info["render"]``: targets, facing,
whether a facing is shown, cooldown ratios) on the same states, each step
taken by both packages from the JAX state (ints and bools equal, floats
within 1e-5; the JAX step compiled without XLA's fusion pass, as in
``test_torch_combat_env.py``), on three scenario sets at three difficulty
tiers and on a flat map with walls; a step that does not record returns no
render extras; the runner's recording; ``render_frame``'s frame;
``save_replay``'s file against JAX's on the same recording; and an eval-only
CLI run that writes the replay and the video (an animated GIF where imageio
has no FFMPEG, as here)."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu.envs.combat import render as jrender
from refil_tpu.envs.combat.env import EntityBattle as JaxBattle
from refil_tpu.envs.combat.flat_env import FlatBattle as JaxFlat
from refil_tpu.envs.combat.scenarios import SCENARIO_REGISTRY as JAX_SCENARIOS
from refil_torch import main as tmain
from refil_torch.envs.combat import render as trender
from refil_torch.envs.combat.env import EntityBattle
from refil_torch.envs.combat.flat_env import FlatBattle
from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY
from test_torch_combat_env import _assert_same, _from_jax, _jax_reset_draws

@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes on one thread: more gain nothing, and a loaded machine
    loses much."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, STEPS = 8, 25


def _check_steps(jenv, env, jstate, jobs, state, to_port, what):
    """STEPS random legal steps, each from the JAX state in both packages:
    the port's recording step's extras and the new state's render_state
    equal JAX's."""
    Na = env.env_info()["n_agents"]
    jstep = jax.jit(jenv.step).lower(
        jstate, jnp.zeros((B, Na), jnp.int32), jax.random.PRNGKey(0),
    ).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})
    rng = np.random.default_rng(1)
    shown = targeted = False
    for t in range(STEPS):
        avail = np.asarray(jobs["avail_actions"])
        actions = np.array([[rng.choice(np.flatnonzero(a)) for a in row] for row in avail])
        jstate, jobs, _, _, jinfo = jstep(jstate, jnp.asarray(actions, jnp.int32),
                                          jax.random.PRNGKey(t))
        state, _, _, _, info = env.step(state, torch.as_tensor(actions), record=True)
        _assert_same(info["render"], jinfo["render"], f"{what} step {t} extras")
        state = to_port(jstate, state)
        _assert_same(env.render_state(state), jenv.render_state(jstate),
                     f"{what} step {t} render_state")
        shown |= bool(np.asarray(jinfo["render"]["facing_valid"]).any())
        targeted |= bool((np.asarray(jinfo["render"]["target"]) >= 0).any())
    assert shown and targeted


@pytest.mark.parametrize("scenario,difficulty", [("1-5m_symmetric", "1"),
                                                 ("3-8sz_symmetric", "A"),
                                                 ("3-8MMM_symmetric", "7")])
def test_render_extras_match_jax(scenario, difficulty):
    jenv = JaxBattle(scenario_dict=JAX_SCENARIOS[scenario](), difficulty=difficulty)
    env = EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), difficulty=difficulty)
    key = jax.random.PRNGKey(7)
    jstate, jobs = jenv.reset(key, B)
    state, _ = env.reset(B, draws=_jax_reset_draws(jenv, key, B))
    state = _from_jax(jstate, state)
    _assert_same(env.render_state(state), jenv.render_state(jstate), "reset render_state")
    _check_steps(jenv, env, jstate, jobs, state, _from_jax, scenario)
    # the training step computes no render extras
    _, _, _, _, info = env.step(state, torch.zeros((B, env.max_na), dtype=torch.long))
    assert set(info) == {"battle_won", "episode_limit"}


def test_flat_render_matches_jax():
    jenv, env = JaxFlat(map_name="corridor"), FlatBattle(map_name="corridor")
    key = jax.random.PRNGKey(3)
    jstate, jobs = jax.jit(jenv.reset, static_argnums=1)(key, B)
    state, _ = env.reset(B, draws=_jax_reset_draws(jenv.core, key, B))

    def to_port(js, s):
        return s._replace(core=_from_jax(js.core, s.core),
                          last_action=torch.tensor(np.asarray(js.last_action)))

    state = to_port(jstate, state)
    assert env.map_size == jenv.map_size
    _check_steps(jenv, env, jstate, jobs, state, to_port, "corridor")
    _, _, _, _, info = env.step(state, torch.zeros((B, env.n_agents), dtype=torch.long))
    assert "render" not in info


def _recording():
    """A recording rollout of the port's runner (tiny FF agent, 2 v 2
    Marines, random play): its ``last_recording``."""
    from refil_torch import config as tconfig
    from refil_torch import run as trun

    cfg = tconfig.load_config(alg="refil", env="entity_battle", overrides=[
        "scenario=1-5m_symmetric", "agent=entity_attend_ff", "attn_embed_dim=8",
        "attn_n_heads=2", "hypernet_embed=8", "mixing_embed_dim=8", "batch_size_run=2",
        "env_args.episode_limit=6", "use_cuda=False"])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, _, _ = trun.build_training(args, None, torch.device("cpu"))
    assert runner.last_recording is None
    runner.run(test_mode=False, record=True)
    return runner


def test_runner_records_targets_and_facing():
    runner = _recording()
    rec = runner.last_recording
    assert rec is not None and len(rec) == runner.episode_limit
    keys = {"pos", "health", "shield", "health_max", "shield_max", "type", "active",
            "is_ally", "target", "facing", "facing_valid", "cd_ratio"}
    assert all(set(r) == keys and all(isinstance(v, np.ndarray) for v in r.values())
               for r in rec)
    N = rec[0]["pos"].shape[1]
    tg = np.stack([r["target"] for r in rec])  # (T, B, N)
    assert tg.min() >= -1 and tg.max() < N
    assert np.stack([r["facing_valid"] for r in rec]).any()


def test_render_frame_and_replay_match_jax(tmp_path):
    runner = _recording()
    rec = runner.last_recording
    frame = trender.render_frame(rec[2], 0, runner.env.map_size)
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.dtype == np.uint8
    assert np.array_equal(frame, jrender.render_frame(rec[2], 0, runner.env.map_size))
    trender.save_replay(str(tmp_path / "port.npz"), rec)
    jrender.save_replay(str(tmp_path / "jax.npz"), rec)
    port, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape == (len(rec),) + rec[0][k].shape, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


NARROW = ["scenario=1-5m_symmetric", "attn_embed_dim=16", "hypernet_embed=16",
          "mixing_embed_dim=8", "attn_n_heads=2", "rnn_hidden_dim=16", "batch_size_run=4",
          "batch_size=4", "training_iters=2", "test_nepisode=4", "env_args.episode_limit=10",
          "use_cuda=False"]


def test_eval_cli_writes_replay_and_video(tmp_path):
    train = tmain.main(["--config=refil", "--env-config=entity_battle", "with", *NARROW,
                        "t_max=40", "save_model=True", f"local_results_path={tmp_path / 'a'}"])
    ckpt = os.path.dirname(train["saves"][-1]["path"])
    video = str(tmp_path / "videos" / "eval")
    out = tmain.main(["--config=refil", "--env-config=entity_battle", "with", *NARROW,
                      f"checkpoint_path={ckpt}", "save_replay=True", f"video_path={video}",
                      f"local_results_path={tmp_path / 'b'}"])
    assert out["loop"] == "evaluate"
    assert out["video"] in (video + ".mp4", video + ".gif") and os.path.getsize(out["video"]) > 0
    (replay,) = glob.glob(str(tmp_path / "b" / "replays" / "*.npz"))
    assert out["replay"] == replay
    z = np.load(replay)
    assert {"pos", "target", "facing", "cd_ratio"} <= set(z)
    assert z["pos"].shape == (10, 4, 10, 2)  # T, the test block's envs, Na + Ne units
