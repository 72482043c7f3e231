from .env import EntityBattle  # noqa: F401  (registers "entity_battle")
from .flat_env import FlatBattle  # noqa: F401  (registers "flat_battle")
from .scenarios import SCENARIO_REGISTRY  # noqa: F401
