"""Unit stat tables for the combat stand-in: the port's own copy of
``refil_tpu/envs/combat/units.py`` (numpy only).

The reference drives the real StarCraft II binary; unit behavior there is
game data. This module defines the stand-in's combat model for the same unit
roster (``starcraft2custom.py:62-131`` name<->type mapping;
``unit_max_cooldown`` table at ``starcraft2custom.py:1325-1347``). Health,
shield, damage, range and speed follow the public SC2 unit data; cooldowns are
the reference's own table (in game frames; the env advances ``step_mul``
frames per step, ``sc2custom.yaml: step_mul: 8``).

All stats live in flat arrays indexed by a stable unit id so scenario tables
compile to static int arrays.
"""
from __future__ import annotations

import numpy as np

# stable unit ids (alphabetical, matching the reference's sorted-unit-type
# ordering convention for type bits, starcraft2custom.py:385-389)
UNIT_NAMES = [
    "Baneling",
    "Colossus",
    "Hydralisk",
    "Marauder",
    "Marine",
    "Medivac",
    "SpineCrawler",
    "Stalker",
    "Zealot",
    "Zergling",
]
UNIT_ID = {n: i for i, n in enumerate(UNIT_NAMES)}

_F = np.float32
# columns: health_max, shield_max, energy_max, damage, weapon_range,
#          cooldown_frames (reference unit_max_cooldown), speed (units/sec),
#          heal? (medivac), radius
UNIT_STATS = {
    #               hp   shield energy dmg  rng  cd   speed
    "Baneling": (30.0, 0.0, 0.0, 16.0, 2.2, 1.0, 2.95),
    "Colossus": (200.0, 150.0, 0.0, 24.0, 7.0, 24.0, 3.15),
    "Hydralisk": (80.0, 0.0, 0.0, 12.0, 5.0, 10.0, 3.15),
    "Marauder": (125.0, 0.0, 0.0, 10.0, 6.0, 25.0, 3.15),
    "Marine": (45.0, 0.0, 0.0, 6.0, 5.0, 15.0, 3.15),
    "Medivac": (150.0, 0.0, 200.0, 0.0, 4.0, 200.0, 3.5),
    # rooted defense structure (2s_vs_1sc): speed 0 keeps it stationary
    "SpineCrawler": (300.0, 0.0, 0.0, 25.0, 7.0, 41.0, 0.0),
    "Stalker": (80.0, 80.0, 0.0, 13.0, 6.0, 35.0, 4.13),
    "Zealot": (100.0, 50.0, 0.0, 16.0, 1.5, 22.0, 3.15),
    "Zergling": (35.0, 0.0, 0.0, 5.0, 1.0, 11.0, 4.13),
}

N_UNIT_TYPES = len(UNIT_NAMES)

HEALTH_MAX = np.array([UNIT_STATS[n][0] for n in UNIT_NAMES], _F)
SHIELD_MAX = np.array([UNIT_STATS[n][1] for n in UNIT_NAMES], _F)
ENERGY_MAX = np.array([UNIT_STATS[n][2] for n in UNIT_NAMES], _F)
DAMAGE = np.array([UNIT_STATS[n][3] for n in UNIT_NAMES], _F)
WEAPON_RANGE = np.array([UNIT_STATS[n][4] for n in UNIT_NAMES], _F)
COOLDOWN_FRAMES = np.array([UNIT_STATS[n][5] for n in UNIT_NAMES], _F)
SPEED = np.array([UNIT_STATS[n][6] for n in UNIT_NAMES], _F)
IS_MEDIVAC = np.array([n == "Medivac" for n in UNIT_NAMES], bool)
# units that ignore the walkability grid: flying (Medivac) and cliff-walking
# (Colossus — the mechanic that defines 2c_vs_64zg)
IGNORES_PATHING = np.array(
    [n in ("Medivac", "Colossus") for n in UNIT_NAMES], bool
)

# Medivac healing model: ~12.6 hp/s in game; per 8-frame step at 22.4 fps
# that is ~4.5 hp. Energy: 1 energy per 3 hp healed; passive regen 0.79/s.
MEDIVAC_HEAL_PER_STEP = 4.5
MEDIVAC_ENERGY_PER_STEP = 1.5
MEDIVAC_ENERGY_REGEN = 0.28
MEDIVAC_START_ENERGY = 50.0
GAME_FPS = 22.4
