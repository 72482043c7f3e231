"""EntityBattle: the batched combat stand-in for the reference's custom
StarCraft II env, port of ``refil_tpu/envs/combat/env.py``.

The same observable contract (entity features, masks, available actions,
action semantics, random per-episode tags, scenario sampling, reward and
termination) over the same closed-form combat model (units move, chase, fire
with per-type damage, cooldown and range, shields absorb first, Medivacs
heal; the enemy army follows one of four scripted policies by difficulty).
State is a tuple of tensors on the env's device, batched over B envs with
active-prefix slot masks.

Randomness: ``reset`` takes a ``torch.Generator`` or explicit draws (the
scenario index, the rotation uniform, the per-group jitter uniforms and the
tag permutations), so tests can hand it the draws the JAX env takes from its
key splits; ``step`` draws nothing.

``heuristic_actions`` is the scripted ally policy (``heuristic_ai``) in both
of its emit modes (``heuristic_rest``); ``render_state`` and, on a recording
step (``step(..., record=True)``), ``info["render"]`` are what ``render.py``
draws and ``save_replay`` stores. A step that does not record computes none
of the render extras, so a captured training block holds no kernel for them.
The flat env (``flat_env.py``) runs these dynamics on per-map pathing and
terrain-height grids.
Determinism on CUDA: every scatter-add with colliding indices is a one-hot
product and a sum (no atomics); ``argmin``/``argmax`` pick the first index of
a tie, as in JAX.

On CUDA ``step_state`` (without ``record``) and ``observe`` are one kernel
each (``ops/combat_env.py``, ``csrc/combat_env.cu``), bit for bit the op
path's result there; ``step_state_plain`` and ``observe_plain`` are the op
path, which the CPU runs and the kernels are held to.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops import combat_env
from ..base import register_env, warn_unused_env_args
from . import units as U
from .scenarios import compile_scenarios

_FAR = 1000.0
# chasers stop this far inside weapon range, so the post-move `dist <=
# w_range` fire check is not floating-point luck; kiters hold threats at the
# same slack inside max range
_RANGE_SLACK = 0.1
# enemy-bot difficulty ladder: SC2 levels onto four scripted policies
#   "1"-"3"  tier 0: attack-move only, never chase
#   "4"-"6"  tier 1: chase the nearest visible ally into weapon range
#   "7"-"9"  tier 2: + overkill-aware focus fire on the lowest-health ally in range
#   "A"      tier 3: + range-kiting while the weapon cools down
_DIFF_TIER = {"1": 0, "2": 0, "3": 0, "4": 1, "5": 1, "6": 1, "7": 2, "8": 2, "9": 2, "A": 3}


class CombatState(NamedTuple):
    scen: torch.Tensor  # (B,) int64
    a_type: torch.Tensor  # (B, Na) int64 global unit id
    a_active: torch.Tensor  # (B, Na) bool: slot exists this episode
    e_type: torch.Tensor
    e_active: torch.Tensor
    a_pos: torch.Tensor  # (B, Na, 2)
    e_pos: torch.Tensor
    a_health: torch.Tensor
    a_shield: torch.Tensor
    a_cd: torch.Tensor  # weapon cooldown, game frames
    a_energy: torch.Tensor
    e_health: torch.Tensor
    e_shield: torch.Tensor
    e_cd: torch.Tensor
    a_tags: torch.Tensor  # (B, Na) tag ids in [n_tags_e, n_tags_e + n_tags_a)
    e_tags: torch.Tensor  # (B, Ne) in [0, n_tags_e)
    e_slot_of_tag: torch.Tensor  # (B, n_tags_e) int64
    a_slot_of_tag: torch.Tensor  # (B, n_tags_a) int64
    a_last_hit: torch.Tensor  # (B, Na) step of the last damage taken
    e_last_hit: torch.Tensor
    attack_point: torch.Tensor  # (B, 2)
    prev_a_hp: torch.Tensor  # health + shield snapshot for reward deltas
    prev_e_hp: torch.Tensor
    dead_a: torch.Tensor  # (B, Na) bool: death already counted for reward
    dead_e: torch.Tensor
    t: torch.Tensor  # (B,) int64


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` computes it
    op by op, with a correctly rounded float32 sqrt. PyTorch's vectorised
    sqrt on the CPU is not always correctly rounded (about 0.6% of inputs
    land one ulp off), so there it goes through float64; CUDA's float32 sqrt
    is correctly rounded and is used as it is."""
    s = (x * x).sum(-1)
    return torch.sqrt(s) if s.is_cuda else torch.sqrt(s.double()).float()


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order: the order XLA's CPU reduction adds
    in, so float sums over unit slots match the JAX reference bit for bit
    (a trajectory is a chain of range checks that one ulp can flip)."""
    x = x.movedim(dim, 0)
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at per-row slot indices idx (B, M) -> (B, M, ...)."""
    i = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return x.gather(1, i)


def _scatter_sum(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[b, j] = sum over i with idx[b, i] == j of values[b, i]: a one-hot
    product and a sum, deterministic where indices collide."""
    return _seq_sum(values[..., None] * F.one_hot(idx, n).to(values.dtype), 1)


@register_env("entity_battle")
class EntityBattle:
    final_info_keys = ("battle_won", "episode_limit")

    def __init__(self, scenario_dict: Dict, entity_scheme: bool = True,
                 episode_limit: Optional[int] = None, move_amount: float = 2.0,
                 step_mul: int = 8, sight_range: float = 9.0, shoot_range: float = 6.0,
                 random_tags: bool = True, reward_death_value: float = 10.0,
                 reward_win: float = 200.0, reward_defeat: float = 0.0,
                 reward_negative_scale: float = 0.5, reward_only_positive: bool = True,
                 reward_scale: bool = True, reward_scale_rate: float = 20.0,
                 reward_sparse: bool = False, map_size: float = 32.0, pathing_grid=None,
                 terrain_height=None, difficulty: str = "7", heuristic_rest: bool = False,
                 device="cpu", **unused):
        if not entity_scheme:
            raise ValueError("EntityBattle only supports the entity scheme")
        # reference keys with no effect here (SC2 process options, flat-scheme
        # observation flags); heuristic_ai is the runner's switch
        warn_unused_env_args(
            "EntityBattle", unused,
            accepted=("continuing_episode", "game_version", "seed", "replay_dir",
                      "replay_prefix", "debug", "heuristic_ai", "obs_all_health",
                      "obs_instead_of_state", "obs_own_health", "obs_last_action",
                      "obs_pathing_grid", "obs_terrain_height", "obs_timestep_number",
                      "state_last_action", "state_timestep_number"))
        self.device = dev = torch.device(device)
        self.difficulty = str(difficulty)
        if self.difficulty not in _DIFF_TIER:
            logging.getLogger("refil_torch").warning(
                "EntityBattle: unknown difficulty %r (known: %s); defaulting to tier 2 "
                "(SC2 '7'-'9', focus-fire)", self.difficulty, sorted(_DIFF_TIER))
        self.enemy_tier = _DIFF_TIER.get(self.difficulty, 2)
        self.heuristic_rest = bool(heuristic_rest)
        self.sc = compile_scenarios(scenario_dict)
        self.scenario_names = self.sc.names
        self.rotate = bool(scenario_dict.get("rotate", False))
        self.ally_centered = bool(scenario_dict.get("ally_centered", False))
        self.separation = float(scenario_dict.get("separation", 10))
        self.jitter = float(scenario_dict.get("jitter", 0))
        self.n_extra_tags = int(scenario_dict.get("n_extra_tags", 0))
        self.episode_limit = int(episode_limit or scenario_dict.get("episode_limit", 100))

        self.max_na = self.sc.max_n_agents
        self.max_ne = self.sc.max_n_enemies
        self.n_tags_e = self.max_ne + self.n_extra_tags
        self.n_tags_a = self.max_na + self.n_extra_tags
        self.has_medivac = U.UNIT_ID["Medivac"] in self.sc.unit_type_set
        self.n_actions = 6 + self.n_tags_e + (self.n_tags_a if self.has_medivac else 0)

        uts = self.sc.unit_type_set
        self.unit_type_bits = len(uts) if len(uts) > 1 else 0
        local = np.zeros((U.N_UNIT_TYPES,), np.int64)
        for i, u in enumerate(uts):
            local[u] = i
        self.local_type = torch.as_tensor(local, device=dev)
        self.shield_bits = int(any(U.SHIELD_MAX[u] > 0 for u in uts))

        self.move_amount = float(move_amount)
        self.step_mul = int(step_mul)
        self.sight_range = float(sight_range)
        self.shoot_range = float(shoot_range)
        self.random_tags = bool(random_tags)
        self.map_size = float(map_size)
        self.center = torch.tensor([map_size / 2.0, map_size / 2.0], dtype=torch.float32,
                                   device=dev)

        # walkability and terrain-height grids (cell = 1 map unit, indexed
        # [x, y]); None is the empty map every custom scenario uses: all
        # walkable, flat (the flat env passes real maps; only its
        # observation reads the height)
        M = int(np.ceil(map_size))
        if pathing_grid is None:
            pathing_grid = np.ones((M, M), bool)
        if terrain_height is None:
            terrain_height = np.full((M, M), 0.5, np.float32)
        self.pathing_grid = torch.as_tensor(np.asarray(pathing_grid, bool), device=dev)
        self.terrain_height = torch.as_tensor(np.asarray(terrain_height, np.float32), device=dev)
        self.trivial_pathing = bool(np.asarray(pathing_grid).all())
        self.ignores_pathing_t = torch.as_tensor(U.IGNORES_PATHING, device=dev)

        self.reward_death_value = reward_death_value
        self.reward_win = reward_win
        self.reward_defeat = reward_defeat
        self.reward_negative_scale = reward_negative_scale
        self.reward_only_positive = bool(reward_only_positive)
        self.reward_scale = bool(reward_scale)
        self.reward_scale_rate = reward_scale_rate
        self.reward_sparse = bool(reward_sparse)

        mx_ally, mx_enemy = scenario_dict["max_types_and_units_scenario"]
        enemy_hp = sum(n * (U.HEALTH_MAX[U.UNIT_ID[t]] + U.SHIELD_MAX[U.UNIT_ID[t]])
                       for n, t in mx_enemy)
        self.max_reward = float(enemy_hp) + self.max_ne * reward_death_value + reward_win

        f32 = dict(dtype=torch.float32, device=dev)
        dt = self.step_mul / U.GAME_FPS
        self.speed_step = torch.as_tensor(U.SPEED * dt, **f32)
        self.health_max = torch.as_tensor(U.HEALTH_MAX, **f32)
        self.shield_max = torch.as_tensor(U.SHIELD_MAX, **f32)
        self.energy_max = torch.as_tensor(U.ENERGY_MAX, **f32)
        self.damage = torch.as_tensor(U.DAMAGE, **f32)
        self.weapon_range = torch.as_tensor(U.WEAPON_RANGE, **f32)
        self.cooldown_frames = torch.as_tensor(U.COOLDOWN_FRAMES, **f32)
        self.is_medivac_t = torch.as_tensor(U.IS_MEDIVAC, device=dev)
        # the step's constant vectors live on the device from here, so a step
        # copies nothing from the host (a CUDA graph captures it)
        self.move_dirs = torch.tensor([[0, 0], [0, 0], [0, 1], [0, -1], [1, 0], [-1, 0]], **f32)
        self.axis_x = torch.tensor([1.0, 0.0], **f32)
        self.axis_y = torch.tensor([0.0, 1.0], **f32)
        m = self.move_amount / 2.0
        self.move_probe = torch.tensor([[0.0, m], [0.0, -m], [m, 0.0], [-m, 0.0]], **f32)
        self.noop_only = torch.arange(self.n_actions, device=dev) == 0

        # within-group spawn spread: golden-angle spiral over a unit's rank
        i = np.arange(max(self.max_na, self.max_ne))
        r = 0.55 * np.sqrt(i + 0.25)
        th = 2.39996 * i
        self.rank_spread = torch.as_tensor(
            np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32), device=dev)
        self.n_groups_a = int(self.sc.ally_group.max()) + 1
        self.n_groups_e = int(self.sc.enemy_group.max()) + 1
        self.sc_t = {k: torch.as_tensor(getattr(self.sc, k), device=dev).long()
                     if getattr(self.sc, k).dtype != bool
                     else torch.as_tensor(getattr(self.sc, k), device=dev)
                     for k in ("ally_types", "ally_active", "enemy_types", "enemy_active",
                               "ally_group", "enemy_group", "ally_rank", "enemy_rank")}
        # what the step and observation kernels read (ops/combat_env.py)
        self.kernel_tables = combat_env.tables(self)
        self.kernel_params = combat_env.params(self)

    # ------------------------------------------------------------------
    def env_info(self) -> Dict[str, Any]:
        return {
            "entity_shape": self.get_entity_size(),
            "n_actions": self.n_actions,
            "n_agents": self.max_na,
            "n_entities": self.max_na + self.max_ne,
            "episode_limit": self.episode_limit,
        }

    def get_entity_size(self) -> int:
        nf = self.n_tags_e + self.n_tags_a  # tag one-hot
        nf += self.n_actions - 2  # avail actions minus no-op/stop
        nf += self.unit_type_bits
        nf += 1 + self.shield_bits  # health (+shield)
        nf += 2  # energy + cooldown (allies)
        nf += 4  # center-relative + CoM-relative positions
        return nf

    # ------------------------------------------------------------------
    def draw_reset(self, batch_size: int, generator: Optional[torch.Generator]):
        """The reset's randomness: scenario index (B,), rotation uniform (B,),
        per-group jitter uniforms (B, Ga, 2) and (B, Ge, 2), enemy and ally
        tag permutations (B, n_tags_e) and (B, n_tags_a)."""
        B, dev = batch_size, self.device
        rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)  # noqa: E731
        return {
            "scen": torch.randint(0, self.sc.n_scenarios, (B,), generator=generator, device=dev),
            "u_theta": rand(B),
            "u_jit_a": rand(B, self.n_groups_a, 2),
            "u_jit_e": rand(B, self.n_groups_e, 2),
            "perm_e": rand(B, self.n_tags_e).argsort(dim=1),
            "perm_a": rand(B, self.n_tags_a).argsort(dim=1),
        }

    def reset(self, batch_size: int, generator: Optional[torch.Generator] = None,
              test: bool = False, index: Optional[int] = None, draws=None):
        B, dev = batch_size, self.device
        dr = draws if draws is not None else self.draw_reset(B, generator)
        dr = {k: torch.as_tensor(v, device=dev) for k, v in dr.items()}
        scen = dr["scen"].long()
        if index is not None and index >= 0:
            scen = torch.full((B,), int(index), dtype=torch.long, device=dev)
        sc = self.sc_t
        a_type, a_active = sc["ally_types"][scen], sc["ally_active"][scen]
        e_type, e_active = sc["enemy_types"][scen], sc["enemy_active"][scen]

        if self.rotate:
            theta = dr["u_theta"].float() * 2 * math.pi
        else:
            theta = torch.full((B,), math.pi, dtype=torch.float32, device=dev)
        r = self.separation if self.ally_centered else self.separation / 2.0
        offs = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
        a_anchor = self.center + (0.0 if self.ally_centered else 1.0) * offs
        e_anchor = self.center - offs
        # each (count, type) group draws its own jitter around the army anchor
        jit_a = (dr["u_jit_a"].float() - 0.5) * 2 * self.jitter
        jit_e = (dr["u_jit_e"].float() - 0.5) * 2 * self.jitter
        a_jit = _take(jit_a, sc["ally_group"][scen])
        e_jit = _take(jit_e, sc["enemy_group"][scen])
        a_rs = self.rank_spread[sc["ally_rank"][scen]]
        e_rs = self.rank_spread[sc["enemy_rank"][scen]]
        lo, hi = 1.0, self.map_size - 1.0
        a_pos = (a_anchor[:, None] + a_jit + a_rs).clamp(lo, hi)
        e_pos = (e_anchor[:, None] + e_jit + e_rs).clamp(lo, hi)

        a_health = self.health_max[a_type] * a_active
        a_shield = self.shield_max[a_type] * a_active
        e_health = self.health_max[e_type] * e_active
        e_shield = self.shield_max[e_type] * e_active
        a_energy = torch.where(self.is_medivac_t[a_type] & a_active,
                               U.MEDIVAC_START_ENERGY, 0.0).float()

        if self.random_tags:
            e_tags = dr["perm_e"].long()[:, :self.max_ne]
            a_tags = self.n_tags_e + dr["perm_a"].long()[:, :self.max_na]
        else:
            e_tags = torch.arange(self.max_ne, device=dev).expand(B, -1)
            a_tags = (self.n_tags_e + torch.arange(self.max_na, device=dev)).expand(B, -1)
        # tags are a permutation: the scatter has no colliding indices
        e_slot_of_tag = torch.full((B, self.n_tags_e), -1, dtype=torch.long, device=dev).scatter(
            1, e_tags, torch.arange(self.max_ne, device=dev).expand(B, -1))
        a_slot_of_tag = torch.full((B, self.n_tags_a), -1, dtype=torch.long, device=dev).scatter(
            1, a_tags - self.n_tags_e, torch.arange(self.max_na, device=dev).expand(B, -1))

        attack_point = _seq_sum(a_pos * a_active[..., None], 1) / \
            a_active.sum(1, keepdim=True).clamp(min=1)
        state = CombatState(
            scen=scen, a_type=a_type, a_active=a_active, e_type=e_type, e_active=e_active,
            a_pos=a_pos, e_pos=e_pos, a_health=a_health, a_shield=a_shield,
            a_cd=torch.zeros_like(a_health), a_energy=a_energy, e_health=e_health,
            e_shield=e_shield, e_cd=torch.zeros_like(e_health), a_tags=a_tags.contiguous(),
            e_tags=e_tags.contiguous(), e_slot_of_tag=e_slot_of_tag,
            a_slot_of_tag=a_slot_of_tag,
            a_last_hit=torch.full((B, self.max_na), -1000, dtype=torch.long, device=dev),
            e_last_hit=torch.full((B, self.max_ne), -1000, dtype=torch.long, device=dev),
            attack_point=attack_point, prev_a_hp=a_health + a_shield,
            prev_e_hp=e_health + e_shield, dead_a=torch.zeros_like(a_active),
            dead_e=torch.zeros_like(e_active),
            t=torch.zeros((B,), dtype=torch.long, device=dev))
        return state, self.observe(state)

    # ------------------------------------------------------------------
    def _dists(self, state: CombatState) -> torch.Tensor:
        """Pairwise distances (B, Na+Ne, Na+Ne); _FAR where either unit is
        dead, 0 on the diagonal."""
        pos = torch.cat([state.a_pos, state.e_pos], 1)
        alive = torch.cat([state.a_health > 0, state.e_health > 0], 1)
        d = _norm(pos[:, :, None] - pos[:, None, :])
        d = torch.where(alive[:, :, None] & alive[:, None, :], d, _FAR)
        eye = torch.eye(d.shape[1], dtype=torch.bool, device=d.device)
        return torch.where(eye[None], 0.0, d)

    def _walkable(self, pos: torch.Tensor) -> torch.Tensor:
        """Whether each position's grid cell is pathable; out of bounds is not.
        ``pos``: (..., 2)."""
        M = self.pathing_grid.shape[0]
        xi = torch.floor(pos[..., 0]).long()
        yi = torch.floor(pos[..., 1]).long()
        inb = (xi >= 0) & (xi < M) & (yi >= 0) & (yi < M)
        return inb & self.pathing_grid[xi.clamp(0, M - 1), yi.clamp(0, M - 1)]

    def _apply_pathing(self, pos, disp, types):
        """A movement against the walkability grid: blocked moves slide along
        walls (x-only, then y-only) or cancel; flyers and cliff-walkers pass;
        the map border always clips."""
        lo, hi = 1.0, self.map_size - 1.0
        full = (pos + disp).clamp(lo, hi)
        if self.trivial_pathing:
            return full
        ok = self._walkable(full) | self.ignores_pathing_t[types]
        x_only = (pos + disp * self.axis_x).clamp(lo, hi)
        y_only = (pos + disp * self.axis_y).clamp(lo, hi)
        ok_x, ok_y = self._walkable(x_only), self._walkable(y_only)
        return torch.where(ok[..., None], full, torch.where(
            ok_x[..., None], x_only, torch.where(ok_y[..., None], y_only, pos)))

    def get_avail_actions(self, state: CombatState) -> torch.Tensor:
        """(B, Na, A) bool."""
        B = state.t.shape[0]
        Na = self.max_na
        dev = state.t.device
        a_alive = (state.a_health > 0) & state.a_active
        d = self._dists(state)
        d_aa, d_ae = d[:, :Na, :Na], d[:, :Na, Na:]

        avail = torch.zeros((B, Na, self.n_actions), dtype=torch.bool, device=dev)
        avail[:, :, 1] = True  # stop
        m = self.move_amount / 2.0
        pos = state.a_pos
        can = [pos[..., 1] + m < self.map_size - 1.0, pos[..., 1] - m > 1.0,
               pos[..., 0] + m < self.map_size - 1.0, pos[..., 0] - m > 1.0]  # n, s, e, w
        if not self.trivial_pathing:
            walk = self._walkable(pos[:, :, None, :] + self.move_probe[None, None])
            walk = walk | self.ignores_pathing_t[state.a_type][..., None]
            can = [c & walk[..., i] for i, c in enumerate(can)]
        for i, c in enumerate(can):
            avail[:, :, 2 + i] = c

        is_medivac = self.is_medivac_t[state.a_type]
        # attack: enemies within shoot range -> action slot 6 + enemy tag
        in_range_e = (d_ae <= self.shoot_range) & ~is_medivac[:, :, None]
        tag_oh_e = F.one_hot(state.e_tags, self.n_tags_e).float()
        avail[:, :, 6:6 + self.n_tags_e] = torch.bmm(in_range_e.float(), tag_oh_e) > 0
        if self.has_medivac:
            # heal: non-flying (non-medivac) allies within range
            target_ok = ((d_aa <= self.shoot_range)
                         & ~self.is_medivac_t[state.a_type][:, None, :]
                         & is_medivac[:, :, None])
            tag_oh_a = F.one_hot(state.a_tags - self.n_tags_e, self.n_tags_a).float()
            avail[:, :, 6 + self.n_tags_e:] = torch.bmm(target_ok.float(), tag_oh_a) > 0
        # dead and inactive agents: only no-op
        return torch.where(a_alive[:, :, None], avail, self.noop_only[None, None])

    # ------------------------------------------------------------------
    def step(self, state: CombatState, actions: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None, record: bool = False):
        """(state, obs, reward (B,), done (B,), info). Draws nothing: the
        generator and draws are the runner's interface. ``record`` adds
        ``info["render"]`` (``step_state``)."""
        new_state, reward, done, info = self.step_state(state, actions, record)
        return new_state, self.observe(new_state), reward, done, info

    def _focus_fire(self, state, d_ea, nearest_a, e_alive):
        """Tier >= 2 targets: enemies pick in slot order, each the
        lowest-(health + shield) ally in weapon range whose hp is not already
        lethally covered by earlier picks this step; with every in-range ally
        covered, restack on the lowest hp; out of range, chase the nearest
        ally without reserving damage on it."""
        Na, Ne = self.max_na, self.max_ne
        a_hp_now = state.a_health + state.a_shield
        in_rng = d_ea <= self.weapon_range[state.e_type][:, :, None]
        e_dmg_pot = self.damage[state.e_type] * e_alive
        alloc = torch.zeros_like(a_hp_now)
        picks = []
        for i in range(Ne):
            eff = a_hp_now - alloc
            rng_i, d_i = in_rng[:, i], d_ea[:, i]
            score = torch.where(rng_i & (eff > 0), eff + 1e-3 * d_i, math.inf)
            fallback = torch.where(rng_i, a_hp_now + 1e-3 * d_i, math.inf)
            none_left = ~torch.isfinite(score).any(-1, keepdim=True)
            tgt = torch.where(none_left, fallback, score).argmin(-1)
            can_fire = rng_i.any(-1)
            tgt = torch.where(can_fire, tgt, nearest_a[:, i])
            alloc = alloc + F.one_hot(tgt, Na).float() * (e_dmg_pot[:, i] * can_fire)[:, None]
            picks.append(tgt)
        return torch.stack(picks, 1)

    def step_state(self, state: CombatState, actions: torch.Tensor, record: bool = False):
        """Combat dynamics only: (state, reward, done, info). With ``record``,
        ``info["render"]`` holds this step's render extras. On CUDA a step
        that does not record is one kernel (``ops/combat_env.step``), bit for
        bit the op path's result; a recording step and a CPU step run the op
        path, ``step_state_plain``."""
        if state.t.is_cuda and not record:
            return combat_env.step(self, state, actions)
        return self.step_state_plain(state, actions, record)

    def step_state_plain(self, state: CombatState, actions: torch.Tensor, record: bool = False):
        """``step_state`` op by op: the CPU's path and the kernel's yardstick."""
        Na, Ne = self.max_na, self.max_ne
        a_alive = (state.a_health > 0) & state.a_active
        e_alive = (state.e_health > 0) & state.e_active
        actions = actions.long()

        # ---- decode agent actions ----
        is_move = (actions >= 2) & (actions <= 5)
        move_dir = self.move_dirs[actions.clamp(0, 5)]
        tag = (actions - 6).clamp(0, self.n_tags_e + self.n_tags_a - 1)
        is_attack = actions >= 6
        is_medivac = self.is_medivac_t[state.a_type]
        atk_slot = state.e_slot_of_tag.gather(1, tag.clamp(0, self.n_tags_e - 1)).clamp(0, Ne - 1)
        heal_slot = state.a_slot_of_tag.gather(
            1, (tag - self.n_tags_e).clamp(0, self.n_tags_a - 1)).clamp(0, Na - 1)
        is_agent_attack = is_attack & ~is_medivac & a_alive
        is_agent_heal = is_attack & is_medivac & a_alive

        # ---- enemy targeting by difficulty tier ----
        d_ea = _norm(state.e_pos[:, :, None] - state.a_pos[:, None, :])  # (B, Ne, Na)
        d_ea = torch.where(a_alive[:, None, :], d_ea, _FAR)
        nearest_dist, nearest_a = d_ea.min(2)
        nearest_a = d_ea.argmin(2)  # the first index of a tie, as jnp.argmin
        if self.enemy_tier >= 2:
            e_target = self._focus_fire(state, d_ea, nearest_a, e_alive)
        else:
            e_target = nearest_a
        e_sees = nearest_dist <= self.sight_range
        e_engage = e_alive & e_sees & ~self.is_medivac_t[state.e_type]

        # ---- movement ----
        a_speed = self.speed_step[state.a_type]
        move_step = a_speed.clamp(max=self.move_amount)[..., None] * move_dir
        tgt_pos = torch.where(is_medivac[..., None], _take(state.a_pos, heal_slot),
                              _take(state.e_pos, atk_slot))
        delta = tgt_pos - state.a_pos
        dist_t = _norm(delta)
        w_range = self.weapon_range[state.a_type]  # doubles as the Medivac heal range
        chase_needed = dist_t > w_range - _RANGE_SLACK
        chase_amt = torch.minimum(a_speed, (dist_t - (w_range - _RANGE_SLACK)).clamp(min=0.0))
        unit_delta = delta / dist_t.clamp(min=1e-6)[..., None]
        chase_step = chase_amt[..., None] * unit_delta * chase_needed[..., None]
        a_disp = torch.where((is_move & a_alive)[..., None], move_step, torch.where(
            (is_agent_attack | is_agent_heal)[..., None], chase_step, 0.0))
        a_pos = self._apply_pathing(state.a_pos, a_disp, state.a_type)

        e_speed = self.speed_step[state.e_type]
        e_wr = self.weapon_range[state.e_type]
        e_tgt_pos = _take(state.a_pos, e_target)
        if self.enemy_tier == 0:
            # attack-move only: march on the attack point
            e_delta = state.attack_point[:, None, :] - state.e_pos
            e_dist = _norm(e_delta)
            e_amt = torch.minimum(e_speed, e_dist)
        else:
            # chase the target into weapon range, or advance on the attack point
            goal = torch.where(e_engage[..., None], e_tgt_pos, state.attack_point[:, None, :])
            e_delta = goal - state.e_pos
            e_dist = _norm(e_delta)
            e_stop_at = torch.where(e_engage, e_wr - _RANGE_SLACK, 0.0)
            e_amt = torch.minimum(e_speed, (e_dist - e_stop_at).clamp(min=0.0))
        e_disp = e_amt[..., None] * e_delta / e_dist.clamp(min=1e-6)[..., None] \
            * e_alive[..., None]
        if self.enemy_tier >= 3:
            # range-kite while the weapon cools down: hold the nearest
            # out-ranged ally at max weapon range
            cooling = (state.e_cd - self.step_mul) > 0
            a_wr = self.weapon_range[state.a_type]
            outranged = a_wr[:, None, :] < e_wr[:, :, None] - 1e-3
            d_thr = torch.where(outranged, d_ea, _FAR)
            thr_dist, thr = d_thr.min(2)
            thr = d_thr.argmin(2)
            kite = e_engage & cooling & (thr_dist <= e_wr)
            away = state.e_pos - _take(state.a_pos, thr)
            away = away / _norm(away).clamp(min=1e-6)[..., None]
            back = torch.minimum(e_speed, ((e_wr - _RANGE_SLACK) - thr_dist).clamp(min=0.0))
            e_disp = torch.where(kite[..., None], back[..., None] * away * e_alive[..., None],
                                 e_disp)
        e_pos = self._apply_pathing(state.e_pos, e_disp, state.e_type)

        # ---- combat resolution (post-movement positions) ----
        a_cd = (state.a_cd - self.step_mul).clamp(min=0.0)
        e_cd = (state.e_cd - self.step_mul).clamp(min=0.0)
        atk_dist = _norm(_take(e_pos, atk_slot) - a_pos)
        tgt_alive = e_alive.gather(1, atk_slot)
        a_fires = is_agent_attack & (a_cd <= 0) & (atk_dist <= w_range) & tgt_alive
        dmg_on_e = _scatter_sum(self.damage[state.a_type] * a_fires, atk_slot, Ne)
        e_atk_dist = _norm(_take(a_pos, e_target) - e_pos)
        e_fires = e_engage & (e_cd <= 0) & (e_atk_dist <= e_wr)
        dmg_on_a = _scatter_sum(self.damage[state.e_type] * e_fires, e_target, Na)

        # shields absorb first
        e_shield_new = (state.e_shield - dmg_on_e).clamp(min=0.0)
        e_health_new = (state.e_health - (dmg_on_e - state.e_shield).clamp(min=0.0)).clamp(min=0.0)
        a_shield_new = (state.a_shield - dmg_on_a).clamp(min=0.0)
        a_health_new = (state.a_health - (dmg_on_a - state.a_shield).clamp(min=0.0)).clamp(min=0.0)

        if self.has_medivac:
            heal_dist = _norm(_take(a_pos, heal_slot) - a_pos)
            can_heal = (is_agent_heal & (heal_dist <= w_range) & a_alive.gather(1, heal_slot)
                        & (state.a_energy >= U.MEDIVAC_ENERGY_PER_STEP))
            heal_amt = _scatter_sum(U.MEDIVAC_HEAL_PER_STEP * can_heal.float(), heal_slot, Na)
            a_health_new = torch.where(
                a_health_new > 0,
                torch.minimum(a_health_new + heal_amt, self.health_max[state.a_type]),
                a_health_new)
            a_energy = torch.minimum(
                (state.a_energy - U.MEDIVAC_ENERGY_PER_STEP * can_heal
                 + U.MEDIVAC_ENERGY_REGEN * is_medivac * a_alive).clamp(min=0.0),
                self.energy_max[state.a_type])
        else:
            a_energy = state.a_energy

        a_cd = torch.where(a_fires, self.cooldown_frames[state.a_type], a_cd)
        e_cd = torch.where(e_fires, self.cooldown_frames[state.e_type], e_cd)

        # Protoss shield regeneration after ~10 s without damage
        t1 = state.t[:, None] + 1
        a_last_hit = torch.where(dmg_on_a > 0, t1, state.a_last_hit)
        e_last_hit = torch.where(dmg_on_e > 0, t1, state.e_last_hit)
        regen_delay = int(10.0 * U.GAME_FPS / self.step_mul)
        regen_amt = 2.0 * self.step_mul / U.GAME_FPS
        a_can_regen = ((t1 - a_last_hit) >= regen_delay) & (a_health_new > 0)
        e_can_regen = ((t1 - e_last_hit) >= regen_delay) & (e_health_new > 0)
        a_shield_new = torch.minimum(a_shield_new + regen_amt * a_can_regen,
                                     self.shield_max[state.a_type])
        e_shield_new = torch.minimum(e_shield_new + regen_amt * e_can_regen,
                                     self.shield_max[state.e_type])
        e_shield_new = torch.where(e_health_new > 0, e_shield_new, 0.0)
        a_shield_new = torch.where(a_health_new > 0, a_shield_new, 0.0)

        # ---- reward ----
        hp_e = e_health_new + e_shield_new
        hp_a = a_health_new + a_shield_new
        newly_dead_e = ~state.dead_e & state.e_active & (e_health_new <= 0)
        newly_dead_a = ~state.dead_a & state.a_active & (a_health_new <= 0)
        alive_track_e = ~state.dead_e & state.e_active & (e_health_new > 0)
        alive_track_a = ~state.dead_a & state.a_active & (a_health_new > 0)
        delta_enemy = _seq_sum(state.prev_e_hp * newly_dead_e, 1) + \
            _seq_sum((state.prev_e_hp - hp_e) * alive_track_e, 1)
        delta_deaths = self.reward_death_value * newly_dead_e.sum(1)
        neg = self.reward_negative_scale
        delta_ally = neg * (_seq_sum(state.prev_a_hp * newly_dead_a, 1)
                            + _seq_sum((state.prev_a_hp - hp_a) * alive_track_a, 1))
        if self.reward_only_positive:
            reward = (delta_enemy + delta_deaths).abs()
        else:
            reward = (delta_enemy + delta_deaths - delta_ally
                      - self.reward_death_value * neg * newly_dead_a.sum(1))

        # ---- termination (incl. only-Medivacs-left) ----
        a_combat_alive = ((a_health_new > 0) & state.a_active
                          & ~self.is_medivac_t[state.a_type]).sum(1)
        e_combat_alive = ((e_health_new > 0) & state.e_active
                          & ~self.is_medivac_t[state.e_type]).sum(1)
        n_a = ((a_health_new > 0) & state.a_active).sum(1)
        n_e = ((e_health_new > 0) & state.e_active).sum(1)
        if self.has_medivac:
            lost = (a_combat_alive == 0) & (n_e > 0)
            won = (e_combat_alive == 0) & (n_a > 0)
        else:
            lost = (n_a == 0) & (n_e > 0)
            won = (n_e == 0) & (n_a > 0)
        battle_over = lost | won | ((n_a == 0) & (n_e == 0))

        if self.reward_sparse:
            reward = torch.where(won, 1.0, torch.where(lost, -1.0, 0.0))
        else:
            reward = reward + torch.where(won, self.reward_win, 0.0)
            reward = reward + torch.where(lost, self.reward_defeat, 0.0)
        t = state.t + 1
        at_limit = (t >= self.episode_limit) & ~battle_over
        done = battle_over | at_limit
        if self.reward_scale and not self.reward_sparse:
            reward = reward / (self.max_reward / self.reward_scale_rate)

        new_state = state._replace(
            a_pos=a_pos, e_pos=e_pos, a_health=a_health_new, a_shield=a_shield_new, a_cd=a_cd,
            a_energy=a_energy, e_health=e_health_new, e_shield=e_shield_new, e_cd=e_cd,
            a_last_hit=a_last_hit, e_last_hit=e_last_hit, prev_a_hp=hp_a, prev_e_hp=hp_e,
            dead_a=state.dead_a | newly_dead_a, dead_e=state.dead_e | newly_dead_e, t=t)
        info = {"battle_won": won, "episode_limit": at_limit}
        if record:
            # what the reference's renderer draws from the engine's unit
            # orders (JAX :907-942), from this step's decoded actions: each
            # unit's target (allies 0..Na-1, enemies Na + slot, -1 none), its
            # facing (movement direction while moving, else toward its
            # target) and whether it has one, its cooldown over its weapon's
            a_target = torch.where(
                is_agent_attack & e_alive.gather(1, atk_slot), Na + atk_slot,
                torch.where(is_agent_heal & a_alive.gather(1, heal_slot), heal_slot, -1))
            a_moved, e_moved = _norm(a_disp) > 1e-6, _norm(e_disp) > 1e-6
            a_face = torch.where(a_moved, torch.atan2(a_disp[..., 1], a_disp[..., 0]),
                                 torch.atan2(delta[..., 1], delta[..., 0]))
            e_face = torch.where(e_moved, torch.atan2(e_disp[..., 1], e_disp[..., 0]),
                                 torch.atan2(e_delta[..., 1], e_delta[..., 0]))
            cdf_a = self.cooldown_frames[state.a_type].clamp(min=1.0)
            cdf_e = self.cooldown_frames[state.e_type].clamp(min=1.0)
            info["render"] = {
                "target": torch.cat([a_target, torch.where(e_engage, e_target, -1)], 1),
                "facing": torch.cat([a_face, e_face], 1),
                "facing_valid": torch.cat([a_moved | is_agent_attack | is_agent_heal,
                                           e_moved | e_engage], 1),
                "cd_ratio": torch.cat([a_cd / cdf_a, e_cd / cdf_e], 1),
            }
        return new_state, reward, done, info

    # ------------------------------------------------------------------
    def heuristic_actions(self, state: CombatState,
                          avail: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The scripted ally policy (``heuristic_ai``; JAX
        ``refil_tpu/envs/combat/env.py:946-1042``): attackers target the
        nearest living enemy; Medivacs heal the nearest damaged, living,
        non-Medivac ally. ``heuristic_rest`` picks the emit mode:

        * False (the reference default): the raw attack or heal at the
          target whether or not it is available (the step chases an
          out-of-range target); an agent with no target, or dead, no-ops;
        * True: in range, the attack or heal; out of range, a move toward
          the target; no target, stop; dead, no-op; then the first available
          of [that, move toward the target, N, S, E, W, stop, no-op], by
          ``avail`` (B, Na, A) (default: ``get_avail_actions``).

        Returns (B, Na) int64 actions. Ties between equal distances go to the
        first slot, as ``jnp.argmin``'s do; nothing here waits for the device,
        so a captured block can hold it."""
        a_alive = (state.a_health > 0) & state.a_active
        e_alive = (state.e_health > 0) & state.e_active
        is_med = self.is_medivac_t[state.a_type]

        d_ae = _norm(state.a_pos[:, :, None] - state.e_pos[:, None, :])
        d_ae = torch.where(e_alive[:, None, :], d_ae, _FAR)
        tgt_e, tgt_e_dist = d_ae.argmin(2), d_ae.amin(2)
        attack_act = 6 + state.e_tags.gather(1, tgt_e)

        d_aa = _norm(state.a_pos[:, :, None] - state.a_pos[:, None, :])
        damaged = a_alive & (state.a_health < self.health_max[state.a_type]) & ~is_med
        d_heal = torch.where(damaged[:, None, :], d_aa, _FAR)
        tgt_a, tgt_a_dist = d_heal.argmin(2), d_heal.amin(2)
        heal_act = 6 + state.a_tags.gather(1, tgt_a)  # ally tags lie in the heal range

        want = torch.where(is_med, heal_act, attack_act)
        has_target = torch.where(is_med, tgt_a_dist < _FAR, tgt_e_dist < _FAR)
        tgt_pos = torch.where(is_med[..., None], _take(state.a_pos, tgt_a),
                              _take(state.e_pos, tgt_e))
        delta = tgt_pos - state.a_pos
        ew = torch.where(delta[..., 0] > 0, 4, 5)  # east / west
        ns = torch.where(delta[..., 1] > 0, 2, 3)  # north / south
        move_act = torch.where(delta[..., 0].abs() > delta[..., 1].abs(), ew, ns)

        if not self.heuristic_rest:
            return torch.where(has_target & a_alive, want, 0)

        in_range = torch.where(is_med, tgt_a_dist, tgt_e_dist) <= self.shoot_range
        act = torch.where(in_range, want, move_act)
        act = torch.where(has_target, act, 1)
        act = torch.where(a_alive, act, 0)
        if avail is None:
            avail = self.get_avail_actions(state)
        # stop (alive) or no-op (dead) is always available: the chain ends
        cands = torch.stack([act, move_act] + [torch.full_like(act, a)
                                               for a in (2, 3, 4, 5, 1, 0)], -1)
        first = avail.gather(-1, cands).to(torch.uint8).argmax(-1, keepdim=True)
        return cands.gather(-1, first)[..., 0]

    def render_state(self, state: CombatState) -> Dict[str, torch.Tensor]:
        """One step's snapshot for ``render.py`` (JAX ``:1044-1061``): every
        unit's position, health, shield and their maxima, type, whether its
        slot is active and whether it is an ally; (B, Na + Ne, ...)."""
        B = state.t.shape[0]
        N = self.max_na + self.max_ne
        types = torch.cat([state.a_type, state.e_type], 1)
        return {
            "pos": torch.cat([state.a_pos, state.e_pos], 1),
            "health": torch.cat([state.a_health, state.e_health], 1),
            "shield": torch.cat([state.a_shield, state.e_shield], 1),
            "health_max": self.health_max[types],
            "shield_max": self.shield_max[types],
            "type": types,
            "active": torch.cat([state.a_active, state.e_active], 1),
            "is_ally": (torch.arange(N, device=types.device) < self.max_na).expand(B, N),
        }

    # ------------------------------------------------------------------
    def observe(self, state: CombatState) -> Dict[str, torch.Tensor]:
        """The entity observation, masks and available actions. On CUDA one
        kernel (``ops/combat_env.observe``), bit for bit the op path's
        result; on the CPU the op path, ``observe_plain``."""
        if state.t.is_cuda:
            return combat_env.observe(self, state)
        return self.observe_plain(state)

    def observe_plain(self, state: CombatState) -> Dict[str, torch.Tensor]:
        """``observe`` op by op: the CPU's path and the kernel's yardstick."""
        B = state.t.shape[0]
        Na, Ne = self.max_na, self.max_ne
        a_alive = (state.a_health > 0) & state.a_active
        e_alive = (state.e_health > 0) & state.e_active
        avail = self.get_avail_actions(state)

        n_tags = self.n_tags_e + self.n_tags_a
        pos = torch.cat([state.a_pos, state.e_pos], 1)
        active = torch.cat([state.a_active, state.e_active], 1)
        alive = torch.cat([a_alive, e_alive], 1)
        types = torch.cat([state.a_type, state.e_type], 1)
        health = torch.cat([state.a_health, state.e_health], 1)
        shield = torch.cat([state.a_shield, state.e_shield], 1)
        tags = torch.cat([state.a_tags, state.e_tags], 1)
        act_f, alive_f = active[..., None].float(), alive[..., None].float()

        # centre of mass over real units; dead units keep their last position
        nact = active.sum(1, keepdim=True).clamp(min=1)
        com = _seq_sum(pos * act_f, 1) / nact
        d_com = _norm(pos - com[:, None])
        max_d_com = (d_com * active).max(1, keepdim=True).values.clamp(min=1e-6)

        feats = [F.one_hot(tags, n_tags).float() * act_f]  # tags of real units, dead included
        av = torch.zeros((B, Na + Ne, self.n_actions - 2), device=pos.device)
        av[:, :Na] = avail[:, :, 2:].float()
        feats.append(av * act_f)
        if self.unit_type_bits > 0:
            feats.append(F.one_hot(self.local_type[types], self.unit_type_bits).float() * act_f)
        feats.append((health / self.health_max[types].clamp(min=1e-6))[..., None] * alive_f)
        if self.shield_bits:
            feats.append((shield / self.shield_max[types].clamp(min=1e-6))[..., None] * alive_f)
        # energy and cooldown for ally units only
        is_ally = torch.zeros((Na + Ne,), dtype=torch.bool, device=pos.device)
        is_ally[:Na] = True
        energy = torch.cat([state.a_energy, torch.zeros_like(state.e_health)], 1)
        cd = torch.cat([state.a_cd, state.e_cd], 1)
        emax = self.energy_max[types]
        energy_f = torch.where(emax > 0, energy / emax.clamp(min=1e-6), 0.0)
        cd_f = cd / self.cooldown_frames[types]
        ally_gate = (is_ally[None] & alive)[..., None].float()
        feats.append(energy_f[..., None] * ally_gate)
        feats.append(cd_f[..., None] * ally_gate)
        # positions: centre-relative and CoM-relative
        feats.append((pos - self.center[None, None]) / self.map_size * alive_f)
        feats.append((pos - com[:, None]) / max_d_com[..., None] * alive_f)

        obs_mask = self._dists(state) > self.sight_range
        obs_mask = obs_mask | ~active[:, :, None] | ~active[:, None, :]
        return {
            "entities": torch.cat(feats, -1),
            "obs_mask": obs_mask,
            "entity_mask": ~active,
            "avail_actions": avail,
        }
