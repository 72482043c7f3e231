"""The plain PyTorch GRU recurrence, port of
``refil_tpu/ops/pallas_gru.py:gru_sequence_xla``.

flax ``GRUCell`` gates over a hoisted input projection, in the order
[r | z | n], with no hidden bias on r and z and ``b_hn`` inside ``r * (...)``:

  r = sigmoid(xw_r + h @ W_hr)
  z = sigmoid(xw_z + h @ W_hz)
  n = tanh(xw_n + r * (h @ W_hn + b_hn))
  h' = (1 - z) * n + z * h

The carry and the recurrent product are float32 even when ``xw`` is
bfloat16; ``hs`` comes back in ``xw``'s dtype. A Python loop over T: the
CPU tests and the CUDA kernel's checks use it (``ops/gru_kernel.py``).
"""
from __future__ import annotations

import torch


def gru_sequence(xw: torch.Tensor, wh: torch.Tensor, bhn: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
    """``xw`` (T, R, 3H) input projection (its biases included), ``wh``
    (H, 3H) recurrent kernels [hr | hz | hn], ``bhn`` (H,), ``h0`` (R, H).
    Returns hs (T, R, H) in ``xw``'s dtype."""
    H = h0.shape[-1]
    wh32, b = wh.float(), bhn.float()
    h = h0.float()
    hs = []
    for t in range(xw.shape[0]):
        gh = h @ wh32
        x = xw[t]
        r = torch.sigmoid(x[:, :H] + gh[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * (gh[:, 2 * H:] + b))
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs).to(xw.dtype)
