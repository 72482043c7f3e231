"""Environment registry. Ported: Group Matching and the entity-scheme combat
env (``entity_battle``); the flat combat env is a later slice."""
from . import combat, group_matching  # noqa: F401  (register their envs)
from .base import ENV_REGISTRY, register_env  # noqa: F401
