"""Scenario generation for the combat stand-in: the port's own copy of
``refil_tpu/envs/combat/scenarios.py`` (numpy only).

Parity target: reference ``src/envs/starcraft2/custom_scenarios.py`` — the
same five named scenario sets, the same team-combinatorics
(``get_all_unique_teams``: all unit-type multisets within count ranges), the
same symmetric/asymmetric builders, and the positioning parameters consumed by
the env (rotate / separation / jitter / ally_centered).

``compile_scenarios`` lowers the scenario list into static int arrays so the
env can select a scenario with one gather (variable team sizes are
padded to the max and masked, exactly like the reference pads entities,
``starcraft2custom.py:1024-1135``).
"""
from __future__ import annotations

from functools import partial
from itertools import combinations_with_replacement, product
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .units import UNIT_ID


def get_all_unique_teams(all_types, min_len, max_len):
    """All unit-type multisets of sizes [min_len, max_len] as (count, type)
    lists (reference ``custom_scenarios.py:7-16``)."""
    all_uniq = []
    for i in range(min_len, max_len + 1):
        all_uniq += list(combinations_with_replacement(all_types, i))
    out = []
    for scen in all_uniq:
        curr_uniq = list(set(scen))
        out.append(list(zip([scen.count(u) for u in curr_uniq], curr_uniq)))
    return out


def _teams_from_spec(army_spec):
    subs = [
        get_all_unique_teams(types, rng[0], rng[1]) for types, rng in army_spec
    ]
    return [sum(prod, []) for prod in product(*subs)]


def _max_team(teams):
    return sorted(
        teams, key=lambda x: (len(x), sum(num for num, _ in x)), reverse=True
    )[0]


def symmetric_armies(
    army_spec,
    ally_centered=False,
    rotate=False,
    separation=10,
    jitter=0,
    episode_limit=100,
    map_name="empty_passive",
    n_extra_tags=0,
):
    """Reference ``custom_scenarios.py:33-63``."""
    teams = _teams_from_spec(army_spec)
    mx = _max_team(teams)
    return {
        "scenarios": list(zip(teams, teams)),
        "max_types_and_units_scenario": (mx, mx),
        "ally_centered": ally_centered,
        "rotate": rotate,
        "separation": separation,
        "jitter": jitter,
        "episode_limit": episode_limit,
        "n_extra_tags": n_extra_tags,
        "map_name": map_name,
    }


def asymm_armies(
    army_spec,
    spec_delta,
    ally_centered=False,
    rotate=False,
    separation=10,
    jitter=0,
    episode_limit=100,
    map_name="empty_passive",
    n_extra_tags=0,
):
    """Reference ``custom_scenarios.py:66-103``: enemy teams from the spec,
    ally teams shifted by per-type deltas."""
    enemy_teams = _teams_from_spec(army_spec)
    agent_teams = [
        [(max(num + spec_delta.get(typ, 0), 0), typ) for num, typ in team]
        for team in enemy_teams
    ]
    return {
        "scenarios": list(zip(agent_teams, enemy_teams)),
        "max_types_and_units_scenario": (_max_team(agent_teams), _max_team(enemy_teams)),
        "ally_centered": ally_centered,
        "rotate": rotate,
        "separation": separation,
        "jitter": jitter,
        "episode_limit": episode_limit,
        "n_extra_tags": n_extra_tags,
        "map_name": map_name,
    }


def fixed_armies(ally_army, enemy_army, ally_centered=False, rotate=False,
                 separation=10, jitter=0, episode_limit=100,
                 map_name="empty_passive", n_extra_tags=0):
    """Reference ``custom_scenarios.py:19-30``."""
    return {
        "scenarios": [(ally_army, enemy_army)],
        "max_types_and_units_scenario": (ally_army, enemy_army),
        "ally_centered": ally_centered,
        "rotate": rotate,
        "separation": separation,
        "jitter": jitter,
        "episode_limit": episode_limit,
        "n_extra_tags": n_extra_tags,
        "map_name": map_name,
    }


# the five named sets of the reference (custom_scenarios.py:108-142)
SCENARIO_REGISTRY = {
    "3-8m_symmetric": partial(
        symmetric_armies,
        [(("Marine",), (3, 8))],
        rotate=True, ally_centered=False, separation=14, jitter=1,
        episode_limit=100,
    ),
    "6-11m_mandown": partial(
        asymm_armies,
        [(("Marine",), (6, 11))],
        {"Marine": -1},
        rotate=True, ally_centered=False, separation=14, jitter=1,
        episode_limit=100,
    ),
    "3-8sz_symmetric": partial(
        symmetric_armies,
        [(("Stalker", "Zealot"), (3, 8))],
        rotate=True, ally_centered=False, separation=14, jitter=1,
        episode_limit=150,
    ),
    "3-8MMM_symmetric": partial(
        symmetric_armies,
        [(("Marine", "Marauder"), (3, 6)), (("Medivac",), (0, 2))],
        rotate=True, ally_centered=False, separation=14, jitter=1,
        episode_limit=150,
    ),
    "3-8csz_symmetric": partial(
        symmetric_armies,
        [(("Stalker", "Zealot"), (3, 6)), (("Colossus",), (0, 2))],
        rotate=True, ally_centered=False, separation=14, jitter=1,
        episode_limit=150,
    ),
    # tiny debug set (not in the reference registry; handy for tests/bench)
    "1-5m_symmetric": partial(
        symmetric_armies,
        [(("Marine",), (1, 5))],
        rotate=True, ally_centered=False, separation=14, jitter=1,
        episode_limit=50,
    ),
}


class CompiledScenarios(NamedTuple):
    """Static arrays describing every scenario, padded to the max team sizes."""

    n_scenarios: int
    max_n_agents: int
    max_n_enemies: int
    ally_types: np.ndarray  # (S, max_na) int32 unit-id, 0 where inactive
    ally_active: np.ndarray  # (S, max_na) bool
    enemy_types: np.ndarray  # (S, max_ne) int32
    enemy_active: np.ndarray  # (S, max_ne) bool
    # per-slot index of the (count, type)-group a unit came from, used for
    # spawn-position clustering (each group shares a jittered anchor like the
    # reference's per-group DebugCreateUnit positions, starcraft2custom.py:1666-1692)
    ally_group: np.ndarray  # (S, max_na) int32
    enemy_group: np.ndarray  # (S, max_ne) int32
    # rank of a unit within its group (0..num-1): drives the within-group
    # spawn spread (the stand-in for SC2 physically separating the
    # quantity=num units created at one Point2D)
    ally_rank: np.ndarray  # (S, max_na) int32
    enemy_rank: np.ndarray  # (S, max_ne) int32
    names: List[str]
    unit_type_set: List[int]  # sorted unit ids present anywhere


def _team_to_slots(team, max_n):
    types = np.zeros((max_n,), np.int32)
    active = np.zeros((max_n,), bool)
    group = np.zeros((max_n,), np.int32)
    rank = np.zeros((max_n,), np.int32)
    i = 0
    # stable order: sort groups by unit id to mirror the reference's
    # sorted(unit_type, x, y) slot ordering (starcraft2custom.py:1734-1738)
    for gi, (num, typ) in enumerate(sorted(team, key=lambda x: UNIT_ID[x[1]])):
        for r in range(num):
            types[i] = UNIT_ID[typ]
            active[i] = True
            group[i] = gi
            rank[i] = r
            i += 1
    return types, active, group, rank


def compile_scenarios(scenario_dict: Dict) -> CompiledScenarios:
    scens = scenario_dict["scenarios"]
    max_na = max(sum(n for n, _ in ally) for ally, _ in scens)
    max_ne = max(sum(n for n, _ in enemy) for _, enemy in scens)
    S = len(scens)
    at = np.zeros((S, max_na), np.int32)
    aa = np.zeros((S, max_na), bool)
    ag = np.zeros((S, max_na), np.int32)
    ar = np.zeros((S, max_na), np.int32)
    et = np.zeros((S, max_ne), np.int32)
    ea = np.zeros((S, max_ne), bool)
    eg = np.zeros((S, max_ne), np.int32)
    er = np.zeros((S, max_ne), np.int32)
    names = []
    unit_ids = set()
    for s, (ally, enemy) in enumerate(scens):
        at[s], aa[s], ag[s], ar[s] = _team_to_slots(ally, max_na)
        et[s], ea[s], eg[s], er[s] = _team_to_slots(enemy, max_ne)
        for num, typ in ally + enemy:
            unit_ids.add(UNIT_ID[typ])
        names.append(
            "-".join(
                "%i%s" % (count, name[:3])
                for count, name in sorted(ally, key=lambda x: x[1])
            )
        )
    return CompiledScenarios(
        n_scenarios=S,
        max_n_agents=max_na,
        max_n_enemies=max_ne,
        ally_types=at,
        ally_active=aa,
        enemy_types=et,
        enemy_active=ea,
        ally_group=ag,
        enemy_group=eg,
        ally_rank=ar,
        enemy_rank=er,
        names=names,
        unit_type_set=sorted(unit_ids),
    )
