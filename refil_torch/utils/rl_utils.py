"""RL target helpers, port of ``refil_tpu/utils/rl_utils.py``."""
from __future__ import annotations

import torch


def build_td_lambda_targets(rewards: torch.Tensor, terminated: torch.Tensor,
                            mask: torch.Tensor, target_qs: torch.Tensor, gamma: float,
                            td_lambda: float) -> torch.Tensor:
    """TD(λ) returns, the JAX package's recursion as a reverse loop over T.

    ``rewards``, ``terminated``, ``mask``: (B, T, 1) for transitions 0..T-1;
    ``target_qs``: (B, T+1, n) bootstrap values for states 0..T. Returns
    (B, T, n):
      ret_T = Q_T · (1 − Σ_t term_t)
      ret_t = λγ·ret_{t+1} + m_t·(r_t + (1−λ)γ·Q_{t+1}·(1−term_t))
    """
    T = rewards.shape[1]
    terminated = terminated.to(rewards.dtype)
    mask = mask.to(rewards.dtype)
    ret = target_qs[:, -1] * (1.0 - terminated.sum(dim=1))
    rets = []
    for t in range(T - 1, -1, -1):
        ret = td_lambda * gamma * ret + mask[:, t] * (
            rewards[:, t] + (1 - td_lambda) * gamma * target_qs[:, t + 1] * (1.0 - terminated[:, t]))
        rets.append(ret)
    return torch.stack(rets[::-1], dim=1)
