"""Environment registry. Ported: Group Matching; the combat and flat envs are
a later slice."""
from . import group_matching  # noqa: F401  (registers "group_matching")
from .base import ENV_REGISTRY, register_env  # noqa: F401
