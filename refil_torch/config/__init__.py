"""Three-layer YAML config system with CLI overrides.

Parity target: reference ``src/main.py:57-102`` (default.yaml -> env yaml -> alg
yaml deep-merge, then sacred ``with k=v`` CLI overrides). Sacred is replaced by a
dependency-free loader; key names are identical to the reference so parity runs
map one-to-one.
"""
from __future__ import annotations

import ast
import copy
import os
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import yaml

_CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))

# reference env-config names (src/config/envs/{sc2custom,sc2}.yaml) map onto
# the stand-in battle envs, so reference invocations work verbatim
ENV_CONFIG_ALIASES = {"sc2custom": "entity_battle", "sc2": "flat_battle"}


def recursive_dict_update(d: Dict, u: Dict) -> Dict:
    """Deep-merge ``u`` into ``d`` (reference ``src/main.py:65-71``)."""
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            d[k] = recursive_dict_update(d[k], v)
        else:
            d[k] = v
    return d


def _load_yaml(path: str) -> Dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def _parse_value(s: str) -> Any:
    """Parse a CLI override value: try python literal, fall back to string."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        if s.lower() in ("true", "false"):
            return s.lower() == "true"
        if s.lower() in ("null", "none"):
            return None
        return s


def _apply_override(config: Dict, key: str, value: Any) -> None:
    """Apply a dotted override like ``env_args.n_agents=4``."""
    parts = key.split(".")
    node = config
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(
    alg: Optional[str] = None,
    env: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    config_dir: str = _CONFIG_DIR,
) -> Dict:
    """Load default.yaml, deep-merge env then alg configs, apply ``k=v`` overrides.

    Merge order matches reference ``src/main.py:79-84``: default <- env <- alg.
    """
    config = _load_yaml(os.path.join(config_dir, "default.yaml"))
    if env is not None:
        # reference env-config names ship as real files; the alias is a
        # fallback for custom config dirs that only carry the stand-in names
        if not os.path.isfile(os.path.join(config_dir, "envs", f"{env}.yaml")):
            env = ENV_CONFIG_ALIASES.get(env, env)
        env_cfg = _load_yaml(os.path.join(config_dir, "envs", f"{env}.yaml"))
        config = recursive_dict_update(config, env_cfg)
    if alg is not None:
        alg_cfg = _load_yaml(os.path.join(config_dir, "algs", f"{alg}.yaml"))
        config = recursive_dict_update(config, alg_cfg)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must look like key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        _apply_override(config, key.strip(), _parse_value(raw.strip()))
    return config


def args_sanity_check(config: Dict) -> Dict:
    """Coerce test_nepisode to a multiple of batch_size_run
    (reference ``src/run.py:315-326``)."""
    if config["test_nepisode"] < config["batch_size_run"]:
        config["test_nepisode"] = config["batch_size_run"]
    else:
        config["test_nepisode"] = (
            config["test_nepisode"] // config["batch_size_run"]
        ) * config["batch_size_run"]
    return config


class Args(SimpleNamespace):
    """Attribute-style access with ``.get`` fallback, mirroring how the
    reference accesses config (``SimpleNamespace``, ``src/run.py:29``)."""

    def get(self, key, default=None):
        return getattr(self, key, default)


def config_to_args(config: Dict) -> Args:
    return Args(**copy.deepcopy(config))
