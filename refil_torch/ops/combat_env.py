"""The combat env's step and observation as CUDA kernels (``csrc/combat_env.cu``).

``EntityBattle.step_state`` (without ``record``) and ``EntityBattle.observe``
dispatch on the device of the state they are given:

  * CUDA tensors come here: ``step`` launches ``combat_step_kernel``, one
    launch for the whole step; ``observe`` launches ``combat_observe_kernel``,
    one launch for the observation, the available actions included. A launch
    that fails raises; nothing falls back.
  * CPU tensors take the plain op path (``EntityBattle.step_state_plain``,
    ``observe_plain``), the CPU tests' path and the kernels' yardstick.

The kernels replace no TPU kernel: the JAX env is jnp ops. They give what the
op path gives on the card bit for bit, in the same dtypes; ``tables`` and
``params`` hand them the env's unit tables, walkability grid and constants,
each Python float rounded to float32 as ATen rounds a scalar operand.

``launches`` counts the launches of each kernel, so a run can show its env
went through them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import numpy as np
import torch

from ..envs.combat import units as U

launches = {"combat_step": 0, "combat_observe": 0}

_LIB = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# ``Params``, ``StepIO`` and ``ObserveIO`` of csrc/combat_env.cu, field for
# field and in order
PARAM_INTS = ("B", "Na", "Ne", "nte", "nta", "A", "n_types", "M", "tier", "has_medivac",
              "trivial", "episode_limit", "regen_delay", "only_positive", "sparse", "scale",
              "utb", "sb", "nf")
PARAM_FLOATS = ("lo", "hi", "move_amount", "half_move", "shoot_range", "sight_range",
                "step_mul", "slack", "eps_focus", "eps_div", "far_", "regen_amt", "rdv", "neg",
                "rdv_neg", "reward_win", "reward_defeat", "inv_scale", "inv_map", "center_x",
                "center_y", "heal_per_step", "energy_per_step", "energy_regen")
PARAM_TABLES = ("unit_f", "unit_i", "grid")
STATE_IN = ("a_type", "e_type", "a_active", "e_active", "a_pos", "e_pos", "a_health",
            "a_shield", "a_cd", "a_energy", "e_health", "e_shield", "e_cd")
STEP_IN = STATE_IN + ("e_slot_of_tag", "a_slot_of_tag", "a_last_hit", "e_last_hit",
                      "attack_point", "prev_a_hp", "prev_e_hp", "dead_a", "dead_e", "t",
                      "actions")
STEP_STATE_OUT = ("a_pos", "e_pos", "a_health", "a_shield", "a_cd", "a_energy", "e_health",
                  "e_shield", "e_cd", "a_last_hit", "e_last_hit", "prev_a_hp", "prev_e_hp",
                  "dead_a", "dead_e", "t")
STEP_OUT = STEP_STATE_OUT + ("reward", "done", "won", "at_limit")
OBSERVE_IN = STATE_IN + ("a_tags", "e_tags")
OBSERVE_OUT = ("entities", "obs_mask", "entity_mask", "avail")


class Params(ctypes.Structure):
    _fields_ = ([(n, _I) for n in PARAM_INTS] + [(n, _F) for n in PARAM_FLOATS]
                + [(n, _P) for n in PARAM_TABLES])


class StepIO(ctypes.Structure):
    _fields_ = [(n, _P) for n in STEP_IN] + [("o_" + n, _P) for n in STEP_OUT]


class ObserveIO(ctypes.Structure):
    _fields_ = [(n, _P) for n in OBSERVE_IN] + [("o_" + n, _P) for n in OBSERVE_OUT]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("combat_env")
        lib.combat_step_launch.argtypes = [ctypes.POINTER(Params), ctypes.POINTER(StepIO), _P]
        lib.combat_step_launch.restype = _I
        lib.combat_observe_launch.argtypes = [ctypes.POINTER(Params),
                                              ctypes.POINTER(ObserveIO), _P]
        lib.combat_observe_launch.restype = _I
        lib.combat_error_string.argtypes = [_I]
        lib.combat_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def tables(env) -> Dict[str, torch.Tensor]:
    """The unit tables by unit id and the walkability grid, on the env's
    device, as the kernels read them: ``unit_f`` (7, types) float32 rows
    health_max, shield_max, energy_max, damage, weapon_range,
    cooldown_frames, speed_step; ``unit_i`` (3, types) int32 rows
    is_medivac, ignores_pathing, local_type; ``grid`` (M, M) uint8."""
    return {
        "unit_f": torch.stack([env.health_max, env.shield_max, env.energy_max, env.damage,
                               env.weapon_range, env.cooldown_frames, env.speed_step]
                              ).contiguous(),
        "unit_i": torch.stack([env.is_medivac_t.int(), env.ignores_pathing_t.int(),
                               env.local_type.int()]).contiguous(),
        "grid": env.pathing_grid.to(torch.uint8).contiguous(),
    }


def params(env) -> Dict[str, float]:
    """The env's sizes, switches and constants (all of ``Params`` but ``B``
    and the tables). A Python float that ATen takes as a scalar operand is
    rounded to float32 by the structure, as ATen rounds it; a division by a
    Python float is, on the card, a product with the float32 reciprocal
    (``inv_scale``, ``inv_map``)."""
    f32 = np.float32
    scale_div = env.max_reward / env.reward_scale_rate
    n_tags = env.n_tags_e + env.n_tags_a
    nf = env.get_entity_size()
    if nf != n_tags + env.n_actions - 2 + env.unit_type_bits + 1 + env.shield_bits + 2 + 4:
        raise ValueError(f"combat_env: entity size {nf} is not the kernel's feature layout")
    return dict(
        Na=env.max_na, Ne=env.max_ne, nte=env.n_tags_e, nta=env.n_tags_a, A=env.n_actions,
        n_types=U.N_UNIT_TYPES, M=env.pathing_grid.shape[0], tier=env.enemy_tier,
        has_medivac=int(env.has_medivac), trivial=int(env.trivial_pathing),
        episode_limit=env.episode_limit, regen_delay=int(10.0 * U.GAME_FPS / env.step_mul),
        only_positive=int(env.reward_only_positive), sparse=int(env.reward_sparse),
        scale=int(env.reward_scale), utb=env.unit_type_bits, sb=env.shield_bits, nf=nf,
        lo=1.0, hi=env.map_size - 1.0, move_amount=env.move_amount,
        half_move=env.move_amount / 2.0, shoot_range=env.shoot_range,
        sight_range=env.sight_range, step_mul=env.step_mul, slack=0.1, eps_focus=1e-3,
        eps_div=1e-6, far_=1000.0, regen_amt=2.0 * env.step_mul / U.GAME_FPS,
        rdv=env.reward_death_value, neg=env.reward_negative_scale,
        rdv_neg=env.reward_death_value * env.reward_negative_scale, reward_win=env.reward_win,
        reward_defeat=env.reward_defeat,
        inv_scale=float(f32(1.0) / f32(scale_div)) if env.reward_scale else 1.0,
        inv_map=float(f32(1.0) / f32(env.map_size)), center_x=env.map_size / 2.0,
        center_y=env.map_size / 2.0, heal_per_step=U.MEDIVAC_HEAL_PER_STEP,
        energy_per_step=U.MEDIVAC_ENERGY_PER_STEP, energy_regen=U.MEDIVAC_ENERGY_REGEN)


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.combat_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _specs(env):
    """Each input's dtype and trailing shape ((B,) + tail), by the env's sizes."""
    Na, Ne = env.max_na, env.max_ne
    f, i, b = torch.float32, torch.int64, torch.bool
    return {
        "a_type": (i, (Na,)), "e_type": (i, (Ne,)), "a_active": (b, (Na,)),
        "e_active": (b, (Ne,)), "a_pos": (f, (Na, 2)), "e_pos": (f, (Ne, 2)),
        "a_health": (f, (Na,)), "a_shield": (f, (Na,)), "a_cd": (f, (Na,)),
        "a_energy": (f, (Na,)), "e_health": (f, (Ne,)), "e_shield": (f, (Ne,)),
        "e_cd": (f, (Ne,)), "e_slot_of_tag": (i, (env.n_tags_e,)),
        "a_slot_of_tag": (i, (env.n_tags_a,)), "a_last_hit": (i, (Na,)),
        "e_last_hit": (i, (Ne,)), "attack_point": (f, (2,)), "prev_a_hp": (f, (Na,)),
        "prev_e_hp": (f, (Ne,)), "dead_a": (b, (Na,)), "dead_e": (b, (Ne,)), "t": (i, ()),
        "a_tags": (i, (Na,)), "e_tags": (i, (Ne,)), "actions": (i, (Na,)),
    }


def _inputs(env, state, names, actions=None):
    """The state's tensors the kernel reads, checked and contiguous."""
    B, dev = state.t.shape[0], state.t.device
    if dev.type != "cuda":
        raise ValueError(f"combat_env kernels take CUDA tensors, not {dev}")
    if B < 1:
        raise ValueError("combat_env kernels need at least one env")
    if env.kernel_tables["unit_f"].device != dev:
        raise ValueError(f"combat_env: the env's tables lie on "
                         f"{env.kernel_tables['unit_f'].device}, the state on {dev}")
    specs, out = _specs(env), {}
    for n in names:
        t = actions.long() if n == "actions" else getattr(state, n)
        dtype, tail = specs[n]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (B,) + tail:
            raise ValueError(f"combat_env: {n} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"not {dtype} {(B,) + tail} on {dev}")
        out[n] = t.contiguous()
    return out


def _params(env, B: int) -> Params:
    tb = env.kernel_tables
    return Params(B=B, **env.kernel_params, **{k: tb[k].data_ptr() for k in PARAM_TABLES})


def step(env, state, actions):
    """``EntityBattle.step_state(state, actions)`` in one launch:
    (state, reward (B,), done (B,), info)."""
    ins = _inputs(env, state, STEP_IN, actions)
    B, dev = state.t.shape[0], state.t.device
    like = {n: ins[n] for n in STEP_STATE_OUT}
    out = {n: torch.empty_like(t) for n, t in like.items()}
    if not env.has_medivac:  # energy changes only with Medivacs: the input passes through
        out["a_energy"] = state.a_energy
    out["reward"] = torch.empty((B,), dtype=torch.float32, device=dev)
    for n in ("done", "won", "at_limit"):
        out[n] = torch.empty((B,), dtype=torch.bool, device=dev)
    io = StepIO(**{n: t.data_ptr() for n, t in ins.items()},
                **{"o_" + n: t.data_ptr() for n, t in out.items()})
    lib = _lib()
    p = _params(env, B)
    _check(lib, lib.combat_step_launch(ctypes.byref(p), ctypes.byref(io),
                                       torch.cuda.current_stream(dev).cuda_stream),
           "combat_step")
    launches["combat_step"] += 1
    new_state = state._replace(**{n: out[n] for n in STEP_STATE_OUT})
    info = {"battle_won": out["won"], "episode_limit": out["at_limit"]}
    return new_state, out["reward"], out["done"], info


def observe(env, state) -> Dict[str, torch.Tensor]:
    """``EntityBattle.observe(state)`` in one launch."""
    ins = _inputs(env, state, OBSERVE_IN)
    B, dev = state.t.shape[0], state.t.device
    Na, N = env.max_na, env.max_na + env.max_ne
    out = {"entities": torch.empty((B, N, env.kernel_params["nf"]), dtype=torch.float32,
                                   device=dev),
           "obs_mask": torch.empty((B, N, N), dtype=torch.bool, device=dev),
           "entity_mask": torch.empty((B, N), dtype=torch.bool, device=dev),
           "avail": torch.empty((B, Na, env.n_actions), dtype=torch.bool, device=dev)}
    io = ObserveIO(**{n: t.data_ptr() for n, t in ins.items()},
                   **{"o_" + n: t.data_ptr() for n, t in out.items()})
    lib = _lib()
    p = _params(env, B)
    _check(lib, lib.combat_observe_launch(ctypes.byref(p), ctypes.byref(io),
                                          torch.cuda.current_stream(dev).cuda_stream),
           "combat_observe")
    launches["combat_observe"] += 1
    return {"entities": out["entities"], "obs_mask": out["obs_mask"],
            "entity_mask": out["entity_mask"], "avail_actions": out["avail"]}


def bytes_per_step(env, B: int) -> Dict[str, int]:
    """Device bytes each kernel reads and writes at ``B`` envs (each input
    and output once): the kernels' bound, with 3.35 TB/s."""
    specs = _specs(env)

    def nbytes(names):
        return sum(B * math.prod(specs[n][1]) * torch.empty((), dtype=specs[n][0]).element_size()
                   for n in names)

    Na, N = env.max_na, env.max_na + env.max_ne
    step_out = nbytes([n for n in STEP_STATE_OUT
                       if n != "a_energy" or env.has_medivac]) + B * (4 + 3)
    obs_out = B * (N * env.get_entity_size() * 4 + N * N + N + Na * env.n_actions)
    return {"combat_step": nbytes(STEP_IN) + step_out,
            "combat_observe": nbytes(OBSERVE_IN) + obs_out}
