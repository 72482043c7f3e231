"""Device-resident episode replay ring, port of ``refil_tpu/core/buffer.py``.

Storage is ``{key: (buffer_size, T+1, ...)}`` on one device. Insertion
writes at ``(index + arange(B)) % size``; sampling is uniform without
replacement over the filled episodes, with indices drawn on the host by
``np.random.default_rng(seed)``, the same stream the JAX ring draws, so the
two rings sample the same episodes.

``buffer_dtype="bfloat16"`` stores the float32 feature planes
(``FEATURE_RING_KEYS``) compressed and casts them back on read; reward,
terminated and the masks keep their dtype.

Under a data mesh (``mesh``, as the JAX ring's ``sharding``) each rank holds
``buffer_size / n`` episodes, one contiguous chunk of the global slots
(``RingLayout`` with period ``buffer_size``: the insert positions wrap at any
offset, so they are not aligned to a block): it inserts, from the gathered
episode batch, the rows whose slots it holds, and ``sample_many`` draws the
same global slots on every rank and returns this rank's shard of the sample
(``MeshContext.gather_sample``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# the feature planes eligible for bf16 storage (one place for the whole port)
FEATURE_RING_KEYS = frozenset({"entities", "obs", "state", "actions_onehot"})


def storage_dtype(key: str, dtype: torch.dtype, feature_dtype: str) -> torch.dtype:
    """The ring's storage dtype of plane ``key`` under ``buffer_dtype``."""
    if feature_dtype == "bfloat16" and key in FEATURE_RING_KEYS and dtype == torch.float32:
        return torch.bfloat16
    return dtype


class ReplayBuffer:
    def __init__(self, template: Dict[str, torch.Tensor], buffer_size: int, seed: int = 0,
                 device=None, feature_dtype: str = "float32", mesh=None):
        """``template``: one episode batch (B, T+1, ...) giving shapes and dtypes.
        ``device``: where the ring lives (default: the template's device).
        ``mesh``: a ``parallel.mesh.MeshContext`` to shard the ring over."""
        if feature_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"buffer_dtype must be float32 or bfloat16, not {feature_dtype!r}")
        self.buffer_size = buffer_size
        first = next(iter(template.values()))
        self.device = torch.device(device) if device is not None else first.device
        self._out_dtypes = {k: v.dtype for k, v in template.items()}
        self.mesh = mesh
        self.layout = None if mesh is None else mesh.ring_layout(buffer_size, buffer_size)
        local = buffer_size if mesh is None else self.layout.local_size
        self.data = {
            k: torch.zeros((local,) + tuple(x.shape[1:]),
                           dtype=storage_dtype(k, x.dtype, feature_dtype), device=self.device)
            for k, x in template.items()
        }
        self.index = 0
        self.episodes_in_buffer = 0
        self._rng = np.random.default_rng(seed)

    def insert_episode_batch(self, batch: Dict[str, torch.Tensor]) -> None:
        B = next(iter(batch.values())).shape[0]
        slots = (self.index + np.arange(B)) % self.buffer_size
        rows = np.arange(B)
        if self.layout is not None:  # the rows whose slots this rank holds
            rows = rows[self.layout.owner(slots) == self.layout.rank]
            slots = self.layout.local(slots[rows])
        positions = torch.as_tensor(slots, device=self.device)
        rows = torch.as_tensor(rows)
        for k, buf in self.data.items():
            x = batch[k]
            buf[positions] = x[rows.to(x.device)].to(device=self.device, dtype=buf.dtype)
        self.index = int((self.index + B) % self.buffer_size)
        self.episodes_in_buffer = min(self.episodes_in_buffer + B, self.buffer_size)

    def can_sample(self, batch_size: int) -> bool:
        return self.episodes_in_buffer >= batch_size

    def _gather(self, idx: np.ndarray, device) -> Dict[str, torch.Tensor]:
        index = torch.as_tensor(idx, device=self.device)
        if self.mesh is not None:
            rows = self.mesh.gather_sample(self.data, index.reshape(-1, idx.shape[-1]),
                                           self.layout, device=device)
            return {k: v.reshape(idx.shape[:-1] + v.shape[1:]).to(dtype=self._out_dtypes[k])
                    for k, v in rows.items()}
        return {k: self.data[k][index].to(device=device, dtype=self._out_dtypes[k])
                for k in self.data}

    def sample(self, batch_size: int, device=None) -> Dict[str, torch.Tensor]:
        """Uniform sample without replacement, (batch_size, T+1, ...); under a
        mesh this rank's (batch_size / n, T+1, ...) shard of it."""
        if not self.can_sample(batch_size):
            raise ValueError(f"{self.episodes_in_buffer} episodes cannot give {batch_size}")
        if self.episodes_in_buffer == batch_size:
            idx = np.arange(batch_size)
        else:
            idx = self._rng.choice(self.episodes_in_buffer, batch_size, replace=False)
        return self._gather(idx, device or self.device)

    def sample_many(self, n_iters: int, batch_size: int, device=None) -> Dict[str, torch.Tensor]:
        """``n_iters`` independent samples stacked on a leading axis
        (n_iters, batch_size, T+1, ...), gathered in one indexing op per plane
        (under a mesh, one exchange for all: this rank's (n_iters,
        batch_size / n, T+1, ...) shard)."""
        if not self.can_sample(batch_size):
            raise ValueError(f"{self.episodes_in_buffer} episodes cannot give {batch_size}")
        if self.episodes_in_buffer == batch_size:
            idx = np.tile(np.arange(batch_size), (n_iters, 1))
        else:
            idx = np.stack([self._rng.choice(self.episodes_in_buffer, batch_size, replace=False)
                            for _ in range(n_iters)])
        return self._gather(idx, device or self.device)
