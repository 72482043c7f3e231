"""Environment registry. Ported: Group Matching and the entity-scheme combat
env (``entity_battle``, also under the reference's name ``sc2custom``); the
flat combat env (``flat_battle``, ``sc2``) is a later slice."""
from . import combat, group_matching  # noqa: F401  (register their envs)
from .base import ENV_REGISTRY, register_env  # noqa: F401

# the reference's env name resolves to the combat stand-in, as in
# refil_tpu/envs/__init__.py
ENV_REGISTRY.setdefault("sc2custom", ENV_REGISTRY["entity_battle"])
