"""The combat env's step and observation kernels (``csrc/combat_env.cu``,
``ops/combat_env.py``).

On the CPU: what the wrapper hands the kernels (the unit tables and the
walkability grid equal the env's tensors; the constants are the float32
values ATen takes; the ctypes structures mirror the source's field for
field), that CPU tensors take the op path and launch nothing, and that no
kernel name carries a tag the benchmark's trace finds attention or GRU calls
by. On the card (``cuda`` marker; ``python -m pytest --noconftest -m cuda
tests/test_torch_combat_env_kernels.py``): the kernels beside the op path
from the same resets and the same random legal actions, through whole
episodes and past termination as the runner steps them, every state,
observation, reward, done and info tensor equal bit for bit.
"""
import os
import re

import numpy as np
import pytest
import torch

from benchmark import trace
from refil_torch.envs.combat import units as U
from refil_torch.envs.combat.env import EntityBattle
from refil_torch.envs.combat.flat_env import FlatBattle, FlatState
from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY
from refil_torch.ops import combat_env

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "refil_torch", "csrc", "combat_env.cu")
SETS = ("3-8sz_symmetric", "3-8MMM_symmetric", "3-8csz_symmetric")


def _env(scenario, difficulty="7", device="cpu"):
    return EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), difficulty=difficulty,
                        device=device)


def _source():
    with open(SOURCE) as f:
        return f.read()


def _c_fields(struct):
    """The field names of ``struct <name> {...}`` in the kernel source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, _source(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"[\s*]", "", n).split("const")[-1] for n in
                      re.sub(r"^(const\s+)?\w+\s*\**", "", decl).split(",")]
    return [n.lstrip("*") for n in names]


@pytest.mark.parametrize("struct,cls", [("Params", combat_env.Params),
                                        ("StepIO", combat_env.StepIO),
                                        ("ObserveIO", combat_env.ObserveIO)])
def test_ctypes_structures_mirror_the_source(struct, cls):
    assert _c_fields(struct) == [n for n, _ in cls._fields_]


@pytest.mark.parametrize("scenario", SETS)
def test_tables_equal_the_envs_tensors(scenario):
    env = _env(scenario)
    tb = env.kernel_tables
    rows = (env.health_max, env.shield_max, env.energy_max, env.damage, env.weapon_range,
            env.cooldown_frames, env.speed_step)
    assert tb["unit_f"].dtype == torch.float32 and tb["unit_f"].is_contiguous()
    for row, want in zip(tb["unit_f"], rows):
        assert torch.equal(row, want)
    assert tb["unit_i"].dtype == torch.int32
    for row, want in zip(tb["unit_i"], (env.is_medivac_t, env.ignores_pathing_t,
                                        env.local_type)):
        assert torch.equal(row.long(), want.long())
    assert tb["grid"].dtype == torch.uint8
    assert torch.equal(tb["grid"].bool(), env.pathing_grid)


def test_flat_maps_pack_their_walls():
    fenv = FlatBattle(map_name="corridor")
    core = fenv.core
    assert not core.trivial_pathing and core.kernel_params["trivial"] == 0
    assert torch.equal(core.kernel_tables["grid"].bool(), core.pathing_grid)
    assert core.kernel_params["M"] == core.pathing_grid.shape[0]
    assert core.kernel_tables["unit_i"][1].tolist() == U.IGNORES_PATHING.astype(int).tolist()


@pytest.mark.parametrize("scenario", SETS)
def test_params_are_the_floats_aten_takes(scenario):
    env = _env(scenario, difficulty="A")
    p = env.kernel_params
    assert set(p) == set(combat_env.PARAM_INTS + combat_env.PARAM_FLOATS) - {"B"}
    assert p["tier"] == 3 and p["nf"] == env.get_entity_size()
    assert p["has_medivac"] == int(scenario == "3-8MMM_symmetric")
    assert p["regen_delay"] == 28 and p["episode_limit"] == env.episode_limit
    st = combat_env.Params(B=3, **p)
    # each Python float rounded to float32, as ATen rounds a scalar operand
    assert st.slack == np.float32(0.1) and st.eps_focus == np.float32(1e-3)
    assert st.regen_amt == np.float32(2.0 * 8 / U.GAME_FPS)
    # a division by a Python float is a product with the float32 reciprocal
    want = np.float32(1.0) / np.float32(env.max_reward / env.reward_scale_rate)
    assert st.inv_scale == want and st.inv_map == np.float32(1.0 / 32.0)


@pytest.mark.parametrize("scenario", SETS)
def test_cpu_tensors_take_the_op_path_and_launch_nothing(scenario):
    env = _env(scenario)
    before = dict(combat_env.launches)
    g = torch.Generator().manual_seed(3)
    state, obs = env.reset(4, generator=g)
    for k, v in env.observe_plain(state).items():
        assert torch.equal(obs[k], v), k
    for _ in range(5):
        avail = obs["avail_actions"]
        actions = torch.rand(avail.shape, generator=g).masked_fill(~avail, -1.0).argmax(-1)
        got = env.step(state, actions)
        ref_state, ref_reward, ref_done, ref_info = env.step_state_plain(state, actions)
        assert all(torch.equal(a, b) for a, b in zip(got[0], ref_state))
        assert torch.equal(got[2], ref_reward) and torch.equal(got[3], ref_done)
        assert all(torch.equal(got[4][k], ref_info[k]) for k in ref_info)
        state, obs = got[0], got[1]
    assert combat_env.launches == before


def test_the_wrapper_refuses_cpu_tensors():
    env = _env("3-8sz_symmetric")
    state, _ = env.reset(2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA"):
        combat_env.observe(env, state)
    with pytest.raises(ValueError, match="CUDA"):
        combat_env.step(env, state, torch.zeros((2, env.max_na), dtype=torch.long))


def test_kernel_names_carry_no_trace_stage_tag():
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", _source())
    assert sorted(names) == ["combat_observe_kernel", "combat_step_kernel"]
    tags = {tag for stages in trace.STAGES.values() for tag in stages}
    assert not [(n, t) for n in names for t in tags if t in n]


# ---------------------------------------------------------------- the card
def _assert_equal(what, got, ref):
    bad = []
    for k in ref:
        g, r = got[k], ref[k]
        if g.dtype != r.dtype or g.shape != r.shape:
            bad.append(f"{k}: {g.dtype} {tuple(g.shape)} != {r.dtype} {tuple(r.shape)}")
        elif not torch.equal(g, r):
            idx = (g != r).nonzero()
            first = tuple(idx[0].tolist())
            bad.append(f"{k}: {len(idx)} differ, first at {first}: {g[first].item()!r} "
                       f"!= {r[first].item()!r}")
    assert not bad, f"{what}:\n  " + "\n  ".join(bad)


def side_by_side(core, reset, B, seed, flat=None):
    """Resets (its observation from both paths), then steps every env with
    uniformly random legal actions for the episode limit, the kernels and
    the op path from the same state each step; a finished env keeps its
    state from then on, as the runner's ``_select`` keeps it, and its
    observation is taken again from the kept state. Returns the share of
    envs whose battle ended before the limit."""
    dev = core.device
    g = torch.Generator(device=dev).manual_seed(seed)
    state, obs = reset(B, g)
    if flat is not None:
        state = state.core
        obs = core.observe(state)
    _assert_equal("reset observe", obs, core.observe_plain(state))
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    ended = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(core.episode_limit):
        avail = obs["avail_actions"] if flat is None else \
            flat.get_avail_actions(FlatState(core=state, last_action=None))
        u = torch.rand(avail.shape, generator=g, device=dev)
        actions = u.masked_fill(~avail, -1.0).argmax(-1)
        if flat is not None:
            actions = flat._to_entity_actions(actions, state)
        new, reward, done, info = core.step_state(state, actions)
        ref_new, ref_reward, ref_done, ref_info = core.step_state_plain(state, actions)
        _assert_equal(f"step {t}", {**new._asdict(), "reward": reward, "done": done, **info},
                      {**ref_new._asdict(), "reward": ref_reward, "done": ref_done, **ref_info})
        _assert_equal(f"observe {t}", core.observe(new), core.observe_plain(new))
        ended |= alive & done & ~info["episode_limit"]
        state = type(state)(*[torch.where(alive.view((B,) + (1,) * (n.dim() - 1)), n, o)
                              for n, o in zip(new, state)])
        alive = alive & ~done
        obs = core.observe(state)
        _assert_equal(f"kept observe {t}", obs, core.observe_plain(state))
    return float(ended.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 37, 4096])
@pytest.mark.parametrize("difficulty", ["1", "4", "7", "A"])
@pytest.mark.parametrize("scenario", SETS)
def test_kernels_equal_the_op_path_on_the_card(scenario, difficulty, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the combat env kernels have no CPU mode")
    env = _env(scenario, difficulty, device="cuda")
    before = dict(combat_env.launches)
    ended = side_by_side(env, lambda B, g: env.reset(B, generator=g), B,
                         seed=B * 31 + ord(difficulty) + len(scenario))
    print(f"{scenario} {difficulty} B {B}: {ended:.3f} of the battles ended before the limit")
    steps = env.episode_limit
    assert combat_env.launches["combat_step"] - before["combat_step"] == steps
    # the reset's and each step's observation, and the runner's select's
    assert combat_env.launches["combat_observe"] - before["combat_observe"] == 1 + 2 * steps


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 37])
@pytest.mark.parametrize("map_name", ["corridor", "2c_vs_64zg"])
def test_flat_maps_step_on_the_kernel(map_name, B):
    """The flat env's dynamics on walls (corridor) and a cliff only Colossi
    cross (2c_vs_64zg, 64 enemies): ``FlatBattle`` steps its core through
    ``step_state``, so through the step kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the combat env kernels have no CPU mode")
    fenv = FlatBattle(map_name=map_name, device="cuda")
    ended = side_by_side(fenv.core, lambda B, g: fenv.reset(B, generator=g), B, seed=B,
                         flat=fenv)
    print(f"{map_name} B {B}: {ended:.3f} of the battles ended before the limit")
