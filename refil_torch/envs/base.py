"""Environment interface for the batched torch envs, port of
``refil_tpu/envs/base.py``.

An env object holds static configuration; episode state is an explicit tuple
of tensors threaded through ``reset``/``step``, batched over a leading env
axis B. Random draws come from a ``torch.Generator`` or are passed in
explicitly, so tests can feed the JAX env and this one the same randomness.

Observation dict keys (entity scheme):
  * ``entities``      (B, Ne, D) float32
  * ``obs_mask``      (B, Ne, Ne) bool, True = cannot see
  * ``entity_mask``   (B, Ne) bool, True = inactive slot
  * ``avail_actions`` (B, Na, A) bool
  * optional ``gt_mask`` (B, Na, Ne) bool

``step`` returns ``(state, obs, reward (B,), done (B,), info)``;
``info['episode_limit']`` marks time-limit truncation.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

ENV_REGISTRY: Dict[str, Any] = {}

_warned_env_args: set = set()


def warn_unused_env_args(env_name: str, unused: Dict[str, Any],
                         accepted: Tuple[str, ...] = ()) -> None:
    """Warn once per env class about ``env_args`` keys the env does not use;
    keys in ``accepted`` are reference keys with no effect and stay silent."""
    unknown = sorted(k for k in unused if k not in accepted)
    if not unknown or (env_name, tuple(unknown)) in _warned_env_args:
        return
    _warned_env_args.add((env_name, tuple(unknown)))
    logging.getLogger("refil_torch").warning(
        "%s: ignoring unrecognized env_args %s (accepted-but-inert reference keys are: %s)",
        env_name, unknown, sorted(accepted))


def register_env(name: str):
    def deco(cls):
        ENV_REGISTRY[name] = cls
        return cls

    return deco
