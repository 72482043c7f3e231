"""Environment registry: Group Matching, the entity-scheme combat env
(``entity_battle``, also under the reference's name ``sc2custom``) and the
flat combat env (``flat_battle``, also under the reference's name ``sc2``)."""
from . import combat, group_matching  # noqa: F401  (register their envs)
from .base import ENV_REGISTRY, register_env  # noqa: F401

# the reference's env names resolve to the combat stand-ins, as in
# refil_tpu/envs/__init__.py
ENV_REGISTRY.setdefault("sc2custom", ENV_REGISTRY["entity_battle"])
ENV_REGISTRY.setdefault("sc2", ENV_REGISTRY["flat_battle"])
