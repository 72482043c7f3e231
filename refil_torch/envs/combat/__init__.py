from .env import EntityBattle  # noqa: F401  (registers "entity_battle")
from .scenarios import SCENARIO_REGISTRY  # noqa: F401
