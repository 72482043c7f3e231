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
``gru_backward_staged`` is the plain version of the CUDA backward's stages.
"""
from __future__ import annotations

from typing import NamedTuple

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


class GRUBackward(NamedTuple):
    """What ``gru_backward_staged`` returns, float32."""
    d_xw: torch.Tensor  # (T, R, 3H)
    d_wh: torch.Tensor  # (H, 3H)
    d_bhn: torch.Tensor  # (H,)
    d_h0: torch.Tensor  # (R, H)


def gru_backward_staged(xw: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                        wh: torch.Tensor, bhn: torch.Tensor, g: torch.Tensor) -> GRUBackward:
    """The gradients of ``gru_sequence`` for the output gradient ``g``, from
    the saved ``hs``, in the stages of the CUDA backward (``csrc/gru.cu``,
    ``launch_bwd``), the gate gradients as
    ``refil_tpu/ops/pallas_gru.py:_bwd_kernel`` forms them:

      (i)   GH = h_prev W_h for every step at once, h_prev = [h0, hs[:T-1]];
      (ii)  the dh recurrence from T-1 down to 0: the gates from xw and GH,
            dxw = [dpre_r | dpre_z | dpre_n], dgh = [dpre_r | dpre_z | da_hn],
            dh_{t-1} = dh z + dgh W_h^T;
      (iii) dW_h = h_prev^T dgh and db_hn = the sum of dgh's n third, over
            all T * R rows.

    All in float32; ``xw``, ``hs`` and ``g`` are read in their dtype."""
    T, R, H3 = xw.shape
    H = H3 // 3
    w, b = wh.float(), bhn.float()
    h_prev = torch.cat([h0.float()[None], hs[:-1].float()])  # (T, R, H)
    gh = h_prev @ w  # (i)
    x, gg = xw.float(), g.float()
    dxw = torch.empty((T, R, H3), dtype=torch.float32, device=xw.device)
    dgh = torch.empty_like(dxw)
    dh = torch.zeros((R, H), dtype=torch.float32, device=xw.device)
    for t in reversed(range(T)):  # (ii)
        r = torch.sigmoid(x[t, :, :H] + gh[t, :, :H])
        z = torch.sigmoid(x[t, :, H:2 * H] + gh[t, :, H:2 * H])
        ghn_b = gh[t, :, 2 * H:] + b
        n = torch.tanh(x[t, :, 2 * H:] + r * ghn_b)
        d = gg[t] + dh
        dpre_n = d * (1.0 - z) * (1.0 - n * n)
        dpre_r = dpre_n * ghn_b * r * (1.0 - r)
        dpre_z = d * (h_prev[t] - n) * z * (1.0 - z)
        dxw[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        dgh[t] = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
        dh = d * z + dgh[t] @ w.T
    dwh = h_prev.reshape(-1, H).T @ dgh.reshape(-1, H3)  # (iii)
    return GRUBackward(dxw, dwh, dgh[..., 2 * H:].sum((0, 1)), dh)
