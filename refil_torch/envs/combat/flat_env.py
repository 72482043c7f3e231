"""FlatBattle: the fixed-map, flat-observation combat env, port of
``refil_tpu/envs/combat/flat_env.py`` (the stand-in for the reference's
standard SMAC env).

The flat scheme's contract:
  * per-agent observation vectors: move feats ++ enemy feats ++ ally feats ++
    own feats (``obs`` (B, Na, obs_size));
  * the global state: ally and enemy unit rows ++ the last-action block
    (``state`` (B, state_size)), or the agents' observations laid end to end
    under ``obs_instead_of_state``;
  * ``6 + n_enemies`` actions with slot-indexed attack (Medivacs heal the
    ally slot with the same id, the SMAC MMM convention);
  * ``get_obs_st_masks``: per-entity masks over the flat obs and state
    vectors, which let the flat ``QMixer`` mix over imagined groups.

The combat dynamics are ``EntityBattle``'s (``env.py``), on the map's
pathing and terrain-height grids (``map_geometry``); this class translates
the flat action space and builds the flat features from the same
``CombatState``. Like the entity env it draws nothing in ``step``, and
nothing in it waits for the device, so the fused pipeline's CUDA graph can
capture a rollout.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import register_env
from .env import CombatState, EntityBattle
from .scenarios import fixed_armies

# Classic SMAC map compositions (map name -> ally army, enemy army, episode
# limit), restricted to the stand-in's unit roster.
MAP_REGISTRY: Dict[str, Tuple[list, list, int]] = {
    "3m": ([(3, "Marine")], [(3, "Marine")], 60),
    "8m": ([(8, "Marine")], [(8, "Marine")], 120),
    "25m": ([(25, "Marine")], [(25, "Marine")], 150),
    "5m_vs_6m": ([(5, "Marine")], [(6, "Marine")], 70),
    "8m_vs_9m": ([(8, "Marine")], [(9, "Marine")], 120),
    "10m_vs_11m": ([(10, "Marine")], [(11, "Marine")], 150),
    "27m_vs_30m": ([(27, "Marine")], [(30, "Marine")], 180),
    "MMM": ([(1, "Medivac"), (2, "Marauder"), (7, "Marine")],
            [(1, "Medivac"), (2, "Marauder"), (7, "Marine")], 150),
    "MMM2": ([(1, "Medivac"), (2, "Marauder"), (7, "Marine")],
             [(1, "Medivac"), (3, "Marauder"), (8, "Marine")], 180),
    "2s3z": ([(2, "Stalker"), (3, "Zealot")], [(2, "Stalker"), (3, "Zealot")], 120),
    "3s5z": ([(3, "Stalker"), (5, "Zealot")], [(3, "Stalker"), (5, "Zealot")], 150),
    "3s5z_vs_3s6z": ([(3, "Stalker"), (5, "Zealot")], [(3, "Stalker"), (6, "Zealot")], 170),
    "1c3s5z": ([(1, "Colossus"), (3, "Stalker"), (5, "Zealot")],
               [(1, "Colossus"), (3, "Stalker"), (5, "Zealot")], 180),
    "2m_vs_1z": ([(2, "Marine")], [(1, "Zealot")], 150),
    "2s_vs_1sc": ([(2, "Stalker")], [(1, "SpineCrawler")], 300),
    "3s_vs_3z": ([(3, "Stalker")], [(3, "Zealot")], 150),
    "3s_vs_4z": ([(3, "Stalker")], [(4, "Zealot")], 200),
    "3s_vs_5z": ([(3, "Stalker")], [(5, "Zealot")], 250),
    "6h_vs_8z": ([(6, "Hydralisk")], [(8, "Zealot")], 150),
    "2c_vs_64zg": ([(2, "Colossus")], [(64, "Zergling")], 400),
    "bane_vs_bane": ([(4, "Baneling"), (20, "Zergling")],
                     [(4, "Baneling"), (20, "Zergling")], 200),
    "so_many_baneling": ([(7, "Zealot")], [(32, "Baneling")], 100),
    "corridor": ([(6, "Zealot")], [(24, "Zergling")], 400),
}


def map_geometry(map_name: str, map_size: float):
    """(walkable (M, M) bool, height (M, M) float32) of maps whose identity
    is their geometry; the others are open flat fields. Grid cell = 1 map
    unit, indexed ``[x, y]``, heights in [0, 1]. The armies' anchors sit at
    centre ± separation/2 along x, so the geometry keeps those walkable."""
    M = int(np.ceil(map_size))
    walk = np.ones((M, M), bool)
    height = np.full((M, M), 0.5, np.float32)
    c = M // 2
    if map_name == "corridor":
        # two open chambers joined by a narrow choke
        walk[:] = False
        walk[: c - 4, :] = True
        walk[c + 4:, :] = True
        walk[c - 4: c + 4, c - 2: c + 2] = True
    elif map_name == "2c_vs_64zg":
        # high ground and low ground split by a cliff band only Colossi
        # cross; ground units detour by the ramps at the top and bottom
        height[: c - 1, :] = 0.25
        height[c + 1:, :] = 0.75
        height[c - 1: c + 1, :] = 0.5
        walk[c - 1: c + 1, 4: M - 4] = False
    elif map_name == "so_many_baneling":
        # rocks behind the ally spawn
        walk[c - 13: c - 11, : c] = False
    return walk, height


class FlatState(NamedTuple):
    core: CombatState
    last_action: torch.Tensor  # (B, Na, A) one-hot of each agent's last action


@register_env("flat_battle")
class FlatBattle:
    final_info_keys = ("battle_won", "episode_limit")

    def __init__(self, map_name: str = "3m", entity_scheme: bool = False,
                 episode_limit: Optional[int] = None, obs_all_health: bool = True,
                 obs_own_health: bool = True, obs_last_action: bool = False,
                 obs_instead_of_state: bool = False, state_last_action: bool = True,
                 state_timestep_number: bool = False, obs_timestep_number: bool = False,
                 obs_pathing_grid: bool = False, obs_terrain_height: bool = False,
                 sight_range: float = 9.0, device="cpu", **combat_kwargs):
        if entity_scheme:
            raise ValueError("FlatBattle is the flat-scheme env (entity_scheme=False)")
        if map_name not in MAP_REGISTRY:
            raise ValueError(f"Unknown map {map_name!r}; available: {sorted(MAP_REGISTRY)}")
        ally, enemy, default_limit = MAP_REGISTRY[map_name]
        self.map_name = map_name
        self.scenario_names = [map_name]  # one fixed army composition (eval)
        scen = fixed_armies(ally, enemy, rotate=False, separation=14, jitter=1,
                            episode_limit=episode_limit or default_limit)
        combat_kwargs.pop("scenario_dict", None)
        walk, height = map_geometry(map_name, combat_kwargs.get("map_size", 32.0))
        self.core = EntityBattle(scenario_dict=scen, entity_scheme=True, random_tags=False,
                                 sight_range=sight_range, pathing_grid=walk,
                                 terrain_height=height, device=device, **combat_kwargs)
        self.device = self.core.device
        self.n_agents = self.core.max_na
        self.n_enemies = self.core.max_ne
        self.n_actions = 6 + self.n_enemies
        self.episode_limit = self.core.episode_limit
        self.obs_all_health = obs_all_health
        self.obs_own_health = obs_own_health or obs_all_health
        self.obs_last_action = obs_last_action
        self.obs_instead_of_state = obs_instead_of_state
        self.state_last_action = state_last_action
        self.state_timestep_number = state_timestep_number
        self.obs_timestep_number = obs_timestep_number
        # the pathing and height values at the reference's 8 and 9 points
        # around each agent
        self.obs_pathing_grid = obs_pathing_grid
        self.obs_terrain_height = obs_terrain_height
        self.n_obs_pathing = 8
        self.n_obs_height = 9
        ma = self.core.move_amount
        self._surround = torch.tensor(
            [(0, 2 * ma), (0, -2 * ma), (2 * ma, 0), (-2 * ma, 0),
             (ma, ma), (-ma, -ma), (ma, -ma), (-ma, ma), (0, 0)],
            dtype=torch.float32, device=self.device)
        self.unit_type_bits = self.core.unit_type_bits
        self.shield_bits_ally = self.core.shield_bits
        self.shield_bits_enemy = self.core.shield_bits
        # row i lists the agent ids other than i, in order
        idx = np.zeros((self.n_agents, max(self.n_agents - 1, 1)), np.int64)
        for i in range(self.n_agents):
            idx[i, : self.n_agents - 1] = [j for j in range(self.n_agents) if j != i]
        self._offdiag = torch.as_tensor(idx, device=self.device)

    # --- sizes ---
    @property
    def nf_al_obs(self) -> int:
        nf = 4 + self.unit_type_bits
        if self.obs_all_health:
            nf += 1 + self.shield_bits_ally
        if self.obs_last_action:
            nf += self.n_actions
        return nf

    @property
    def nf_en_obs(self) -> int:
        nf = 4 + self.unit_type_bits
        if self.obs_all_health:
            nf += 1 + self.shield_bits_enemy
        return nf

    @property
    def nf_own(self) -> int:
        nf = self.unit_type_bits
        if self.obs_own_health:
            nf += 1 + self.shield_bits_ally
        if self.obs_timestep_number:
            nf += 1
        return nf

    @property
    def move_feats_len(self) -> int:
        n = 4
        if self.obs_pathing_grid:
            n += self.n_obs_pathing
        if self.obs_terrain_height:
            n += self.n_obs_height
        return n

    def get_obs_size(self) -> int:
        return (self.move_feats_len + self.n_enemies * self.nf_en_obs
                + (self.n_agents - 1) * self.nf_al_obs + self.nf_own)

    @property
    def nf_al_state(self) -> int:
        return 4 + self.shield_bits_ally + self.unit_type_bits

    @property
    def nf_en_state(self) -> int:
        return 3 + self.shield_bits_enemy + self.unit_type_bits

    def get_state_size(self) -> int:
        if self.obs_instead_of_state:
            return self.get_obs_size() * self.n_agents
        size = self.n_agents * self.nf_al_state + self.n_enemies * self.nf_en_state
        if self.state_last_action:
            size += self.n_agents * self.n_actions
        if self.state_timestep_number:
            size += 1
        return size

    def env_info(self, args=None) -> Dict[str, Any]:
        """Sizes; with ``args``, also ``masks``: ``get_obs_st_masks(args)``."""
        info = {"state_shape": self.get_state_size(), "obs_shape": self.get_obs_size(),
                "n_actions": self.n_actions, "n_agents": self.n_agents,
                "episode_limit": self.episode_limit}
        if args is not None:
            info["masks"] = self.get_obs_st_masks(args)
        return info

    # ------------------------------------------------------------------
    def reset(self, batch_size: int, generator: Optional[torch.Generator] = None,
              test: bool = False, index: Optional[int] = None, draws=None):
        """The map's one army composition (``index`` has nothing to pick);
        ``draws`` are ``EntityBattle.reset``'s."""
        core, _ = self.core.reset(batch_size, generator=generator, test=test, index=0,
                                  draws=draws)
        state = FlatState(core=core, last_action=torch.zeros(
            (batch_size, self.n_agents, self.n_actions), device=self.device))
        return state, self.observe(state)

    def _to_entity_actions(self, actions: torch.Tensor, core: CombatState) -> torch.Tensor:
        """Flat action (a - 6 = target slot) -> EntityBattle action id:
        attackers 6 + enemy slot (tags are slots here), Medivacs heal the
        ally of that slot, 6 + n_tags_e + slot."""
        is_medivac = self.core.is_medivac_t[core.a_type]
        tgt = (actions - 6).clamp(min=0)
        ent = torch.where(is_medivac, 6 + self.core.n_tags_e + tgt, 6 + tgt)
        return torch.where(actions >= 6, ent, actions)

    def render_state(self, state: FlatState) -> Dict[str, torch.Tensor]:
        return self.core.render_state(state.core)

    @property
    def map_size(self) -> float:
        return self.core.map_size

    def step(self, state: FlatState, actions: torch.Tensor,
             generator: Optional[torch.Generator] = None, draws=None, record: bool = False):
        """(state, obs, reward (B,), done (B,), info). Draws nothing; with
        ``record``, the core's ``info["render"]``."""
        actions = actions.long()
        core, reward, done, info = self.core.step_state(
            state.core, self._to_entity_actions(actions, state.core), record)
        a_alive = (state.core.a_health > 0) & state.core.a_active
        last = F.one_hot(actions, self.n_actions).float() * a_alive[..., None]
        new_state = FlatState(core=core, last_action=last)
        return new_state, self.observe(new_state), reward, done, info

    # ------------------------------------------------------------------
    def get_avail_actions(self, state: FlatState) -> torch.Tensor:
        """(B, Na, 6 + n_enemies) bool from the entity env's; Medivac rows
        take the heal block."""
        ent_avail = self.core.get_avail_actions(state.core)
        Ne, nte = self.n_enemies, self.core.n_tags_e
        attack = ent_avail[:, :, 6:6 + Ne]
        if self.core.has_medivac:
            heal = ent_avail[:, :, 6 + nte:6 + nte + Ne]
            is_medivac = self.core.is_medivac_t[state.core.a_type][..., None]
            attack = torch.where(is_medivac, heal, attack)
        return torch.cat([ent_avail[:, :, :6], attack], dim=2)

    def _type_onehot(self, types: torch.Tensor) -> torch.Tensor:
        return F.one_hot(self.core.local_type[types], self.unit_type_bits).float()

    def observe(self, state: FlatState) -> Dict[str, torch.Tensor]:
        env, core = self.core, state.core
        B = core.t.shape[0]
        Na, Ne = self.n_agents, self.n_enemies
        a_alive = (core.a_health > 0) & core.a_active
        e_alive = (core.e_health > 0) & core.e_active
        avail = self.get_avail_actions(state)
        d = env._dists(core)
        d_ae, d_aa = d[:, :Na, Na:], d[:, :Na, :Na]
        sight = env.sight_range

        # enemy features (B, Na, Ne, nf_en), gated by visible and alive
        vis_e = (d_ae < sight) & e_alive[:, None, :] & a_alive[:, :, None]
        rel_e = (core.e_pos[:, None, :, :] - core.a_pos[:, :, None, :]) / sight
        en = [avail[:, :, 6:6 + Ne].float()[..., None], (d_ae / sight)[..., None], rel_e]
        if self.obs_all_health:
            hmax = env.health_max[core.e_type]
            en.append((core.e_health / hmax.clamp(min=1e-6))[:, None, :, None]
                      .expand(B, Na, Ne, 1))
            if self.shield_bits_enemy:
                smax = env.shield_max[core.e_type].clamp(min=1e-6)
                en.append((core.e_shield / smax)[:, None, :, None].expand(B, Na, Ne, 1))
        if self.unit_type_bits:
            en.append(self._type_onehot(core.e_type)[:, None]
                      .expand(B, Na, Ne, self.unit_type_bits))
        enemy_block = torch.cat(en, -1) * vis_e[..., None]

        # ally features (B, Na, Na, nf_al), then each agent's own row dropped
        vis_a = (d_aa < sight) & a_alive[:, None, :] & a_alive[:, :, None]
        rel_a = (core.a_pos[:, None, :, :] - core.a_pos[:, :, None, :]) / sight
        al = [torch.ones((B, Na, Na, 1), device=self.device), (d_aa / sight)[..., None], rel_a]
        if self.obs_all_health:
            hmax = env.health_max[core.a_type]
            al.append((core.a_health / hmax.clamp(min=1e-6))[:, None, :, None]
                      .expand(B, Na, Na, 1))
            if self.shield_bits_ally:
                smax = env.shield_max[core.a_type].clamp(min=1e-6)
                al.append((core.a_shield / smax)[:, None, :, None].expand(B, Na, Na, 1))
        if self.unit_type_bits:
            al.append(self._type_onehot(core.a_type)[:, None]
                      .expand(B, Na, Na, self.unit_type_bits))
        if self.obs_last_action:
            al.append(state.last_action[:, None].expand(B, Na, Na, self.n_actions))
        ally_full = torch.cat(al, -1) * vis_a[..., None]
        if Na > 1:
            idx = self._offdiag[None, :, :, None].expand(B, Na, Na - 1, ally_full.shape[-1])
            ally_block = ally_full.gather(2, idx)
        else:
            ally_block = ally_full[:, :, :0]

        # move and own features
        move = avail[:, :, 2:6].float()
        if self.obs_pathing_grid or self.obs_terrain_height:
            # grid values at the surrounding points; out of bounds reads 1
            pts = core.a_pos[:, :, None, :] + self._surround[None, None]  # (B, Na, 9, 2)
            M = env.pathing_grid.shape[0]
            xi = torch.floor(pts[..., 0]).long()
            yi = torch.floor(pts[..., 1]).long()
            inb = (xi >= 0) & (xi < M) & (yi >= 0) & (yi < M)
            xi_c, yi_c = xi.clamp(0, M - 1), yi.clamp(0, M - 1)
            if self.obs_pathing_grid:
                pvals = (env.pathing_grid[xi_c, yi_c] | ~inb).float()
                move = torch.cat([move, pvals[..., :self.n_obs_pathing]], -1)
            if self.obs_terrain_height:
                hvals = torch.where(inb, env.terrain_height[xi_c, yi_c], 1.0)
                move = torch.cat([move, hvals], -1)
        own = []
        if self.obs_own_health:
            hmax = env.health_max[core.a_type]
            own.append((core.a_health / hmax.clamp(min=1e-6))[..., None])
            if self.shield_bits_ally:
                smax = env.shield_max[core.a_type].clamp(min=1e-6)
                own.append((core.a_shield / smax)[..., None])
        if self.unit_type_bits:
            own.append(self._type_onehot(core.a_type))
        own_block = (torch.cat(own, -1) * a_alive[..., None] if own
                     else torch.zeros((B, Na, 0), device=self.device))
        if self.obs_timestep_number:
            ts = (core.t.float() / self.episode_limit)[:, None, None].expand(B, Na, 1)
            own_block = torch.cat([own_block, ts], -1)

        obs = torch.cat([move.reshape(B, Na, -1), enemy_block.reshape(B, Na, -1),
                         ally_block.reshape(B, Na, -1), own_block], dim=2)
        obs = obs * a_alive[..., None]  # dead agents observe zeros
        if self.obs_instead_of_state:
            return {"obs": obs, "state": obs.reshape(B, -1), "avail_actions": avail}

        # the global state
        ctr, msz = env.center, env.map_size
        max_cd = env.cooldown_frames[core.a_type].clamp(min=1e-6)
        cd_or_energy = torch.where(env.is_medivac_t[core.a_type], core.a_energy / max_cd,
                                   core.a_cd / max_cd)
        al_state = [(core.a_health / env.health_max[core.a_type].clamp(min=1e-6))[..., None],
                    cd_or_energy[..., None], (core.a_pos - ctr[None, None]) / msz]
        if self.shield_bits_ally:
            smax = env.shield_max[core.a_type].clamp(min=1e-6)
            al_state.append((core.a_shield / smax)[..., None])
        if self.unit_type_bits:
            al_state.append(self._type_onehot(core.a_type))
        al_state = torch.cat(al_state, -1) * a_alive[..., None]
        en_state = [(core.e_health / env.health_max[core.e_type].clamp(min=1e-6))[..., None],
                    (core.e_pos - ctr[None, None]) / msz]
        if self.shield_bits_enemy:
            smax = env.shield_max[core.e_type].clamp(min=1e-6)
            en_state.append((core.e_shield / smax)[..., None])
        if self.unit_type_bits:
            en_state.append(self._type_onehot(core.e_type))
        en_state = torch.cat(en_state, -1) * e_alive[..., None]
        parts = [al_state.reshape(B, -1), en_state.reshape(B, -1)]
        if self.state_last_action:
            parts.append(state.last_action.reshape(B, -1))
        if self.state_timestep_number:
            parts.append((core.t.float() / self.episode_limit)[:, None])
        return {"obs": obs, "state": torch.cat(parts, dim=1), "avail_actions": avail}

    # ------------------------------------------------------------------
    def get_obs_st_masks(self, args):
        """(obs_masks (Na+Ne, Na, agent input size), state_masks (Na+Ne,
        state size)) float32 numpy: which elements of each agent's input
        (obs ++ last action ++ agent id, as ``BasicMAC`` builds it) and of
        the state belong to each entity. Under ``obs_instead_of_state`` the
        state masks are the raw-obs masks laid end to end (the JAX
        package's choice: the reference reshapes the agent-input masks,
        whose width matches the state only with both input blocks off)."""
        Na, Ne = self.n_agents, self.n_enemies
        nf_al, nf_en, nf_own = self.nf_al_obs, self.nf_en_obs, self.nf_own
        move_len = self.move_feats_len
        last_action = bool(getattr(args, "obs_last_action", False))
        agent_id = bool(getattr(args, "obs_agent_id", False))
        obs_size = (self.get_obs_size() + (self.n_actions if last_action else 0)
                    + (Na if agent_id else 0))
        obs_masks = np.zeros((Na + Ne, Na, obs_size), np.float32)
        raw_masks = np.zeros((Na + Ne, Na, self.get_obs_size()), np.float32)
        for i in range(Na + Ne):
            for j in range(Na):
                move = np.zeros(move_len, np.float32)
                en = np.zeros((Ne, nf_en), np.float32)
                al = np.zeros((max(Na - 1, 0), nf_al), np.float32)
                ownm = np.zeros(nf_own, np.float32)
                last_ac = np.zeros(self.n_actions, np.float32)
                if i == j:
                    move[:] = 1
                    ownm[:] = 1
                    last_ac[:] = 1
                elif i < Na:
                    al[i if i < j else i - 1] = 1
                else:
                    en[i - Na] = 1
                cur = np.concatenate([move, en.ravel(), al.ravel(), ownm])
                raw_masks[i, j] = cur
                if last_action:
                    cur = np.append(cur, last_ac)
                if agent_id:
                    cur = np.append(cur, np.ones(Na, np.float32))
                obs_masks[i, j] = cur
        if self.obs_instead_of_state:
            return obs_masks, raw_masks.reshape(Na + Ne, -1)

        state_masks = np.zeros((Na + Ne, self.get_state_size()), np.float32)
        for i in range(Na + Ne):
            al = np.zeros((Na, self.nf_al_state), np.float32)
            en = np.zeros((Ne, self.nf_en_state), np.float32)
            last = np.zeros((Na, self.n_actions), np.float32)
            if i < Na:
                al[i] = 1
                last[i] = 1
            else:
                en[i - Na] = 1
            cur = np.concatenate([al.ravel(), en.ravel()])
            if self.state_last_action:
                cur = np.append(cur, last.ravel())
            if self.state_timestep_number:
                cur = np.append(cur, np.ones(1, np.float32))
            state_masks[i] = cur
        return obs_masks, state_masks
