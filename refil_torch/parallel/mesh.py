"""Multi-process data parallelism, the counterpart of
``refil_tpu/parallel/mesh.py``.

The JAX package runs one SPMD program over a device mesh, with the env batch,
the replay ring and the replay-sample batch sharded over its ``data`` axis.
Here each process drives one device (``torch.distributed``: NCCL on CUDA
cards, gloo on the CPU), and the world of processes is the data axis:

* every random draw is made at the global shape on every rank, from
  generators seeded alike, and each rank keeps its slice (``shard``), which
  is what JAX's SPMD program does with one key;
* each rank rolls out its ``batch_size_run / n`` envs; one ``all_gather`` a
  block (``gather_batch``) puts the block's stats on every rank (the classic
  loop gathers its episode batch too);
* the replay ring is sharded: each rank holds ``buffer_size / n`` episodes,
  the global slots a ``RingLayout`` gives it, so a fused block's insert is
  local; every rank draws the same global sample slots, fills the rows it
  holds, and one ``reduce_scatter`` a train block (``gather_sample``) hands
  each rank its ``batch_size / n`` rows of every update, bit for bit;
* each rank trains on its shard of that sample, with the loss and the
  metrics over the global mask count (one ``all_reduce`` of a block's
  counts), and one ``all_reduce`` an update (``all_reduce_``) sums the
  gradients and the metric sums, so the clip and RMSprop see the global
  gradient and the parameters stay equal on every rank.

A checkpoint's ring is gathered to rank 0 in global slot order
(``gather_ring``), so it equals a one-process ring and restores at any world
size that divides the sizes. Rank 0 alone writes logs, TensorBoard and
checkpoints.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# how long a collective, or the rendezvous, waits for the other ranks
TIMEOUT = datetime.timedelta(minutes=10)
# the flat all_gather; newer releases renamed all_gather_into_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)
# the bytes of a gather_ring chunk on each rank's device, at most
RING_CHUNK_BYTES = 256 << 20


def maybe_init_distributed(config: Dict[str, Any]) -> bool:
    """Joins the process group when ``distributed`` is set; returns True
    when this call created it (the caller destroys it at the end).

    ``coordinator_address`` (host:port of rank 0), ``num_processes`` and
    ``process_id`` give the rendezvous; where they are null, torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` give it.
    The backend is NCCL when the run uses the card (``use_cuda``), gloo on
    the CPU, and each rank uses card ``rank % device_count``. Must run before
    the first device access."""
    if not config.get("distributed", False) or dist.is_initialized():
        return False
    addr = config.get("coordinator_address")
    world = config.get("num_processes")
    rank = config.get("process_id")
    world = int(world if world is not None else _env_int("WORLD_SIZE", "num_processes"))
    rank = int(rank if rank is not None else _env_int("RANK", "process_id"))
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside a world of {world} processes")
    use_cuda = bool(config.get("use_cuda", True))
    if use_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed=True with use_cuda=True but no CUDA device is "
                               "available; pass use_cuda=False to run over gloo on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if addr is None and not os.environ.get("MASTER_ADDR"):
        raise ValueError("distributed=True needs coordinator_address (host:port of rank 0) "
                         "or torchrun's MASTER_ADDR and MASTER_PORT")
    dist.init_process_group("nccl" if use_cuda else "gloo",
                            init_method="env://" if addr is None else f"tcp://{addr}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return True


def _env_int(name: str, key: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(f"distributed=True needs {key} or torchrun's {name}")
    return int(value)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


class RingLayout:
    """Which rank holds each global slot of a replay ring of ``size``
    episodes sharded over ``n`` ranks, and where. The slots fall in periods
    of ``period`` (a divisor of ``size``, a multiple of ``n``); within each,
    rank r holds the r-th run of ``period / n`` slots, kept one after the
    other at local indices ``0 .. size / n``:

        owner(s) = (s mod period) // (period / n)
        local(s) = (s // period) (period / n) + (s mod period) mod (period / n)

    The fused ring's period is ``batch_size_run`` (a block's insert starts at
    a multiple of it), so each rank holds exactly the slots its own envs
    fill; the classic ring's is its size (contiguous chunks)."""

    def __init__(self, size: int, period: int, n: int, rank: int):
        if size % period or period % n:
            raise ValueError(f"a ring of {size} episodes in periods of {period} cannot be "
                             f"sharded over {n} ranks")
        self.size, self.period, self.n, self.rank = int(size), int(period), int(n), int(rank)
        self.run = self.period // self.n  # slots a rank holds in each period
        self.local_size = self.size // self.n

    def owner(self, s: torch.Tensor) -> torch.Tensor:
        return (s % self.period) // self.run

    def local(self, s: torch.Tensor) -> torch.Tensor:
        return (s // self.period) * self.run + (s % self.period) % self.run

    def held_slots(self, rank: Optional[int] = None, device=None) -> torch.Tensor:
        """The global slots of ``rank`` (default: this one), in its local order."""
        r = self.rank if rank is None else rank
        i = torch.arange(self.local_size, device=device)
        return (i // self.run) * self.period + r * self.run + i % self.run


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as uint8, its last axis widened by its element size; a
    sum of one rank's bytes and the others' zeros is exact bit for bit (a
    -0.0 and a NaN's payload survive it)."""
    return x.contiguous().view(torch.uint8)


class MeshContext:
    """The data axis over the process group's ranks: ``n_data`` (the world
    size), ``rank`` and the collectives the loops use. ``launches`` counts
    each collective where it is launched, beside the kernel wrappers'
    counts (``core/pipeline.py:launch_counts``), and ``payload_bytes`` the
    bytes this rank hands to each kind."""

    def __init__(self, device: torch.device):
        if not dist.is_initialized():
            raise ValueError("a MeshContext needs a process group (distributed=True)")
        self.n_data = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.launches = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}
        self.payload_bytes = dict.fromkeys(self.launches, 0)
        # one eager collective: it checks that every rank is there and, on
        # NCCL, creates the communicator before any CUDA graph captures one
        probe = torch.ones(1, device=self.device)
        dist.all_reduce(probe)
        if int(probe.item()) != self.n_data:
            raise RuntimeError(f"the process group's first all_reduce gave {probe.item()}, "
                               f"not its {self.n_data} ranks")

    def check_divisible(self, size: int, what: str = "batch size") -> None:
        if int(size) % self.n_data != 0:
            raise ValueError(f"{what} {size} must divide over {self.n_data} data shards "
                             f"(processes)")

    def shard(self, tree):
        """This rank's slice of the leading (global batch) axis of every
        tensor in ``tree`` (dicts, tuples and named tuples kept); views."""
        def cut(x):
            b = x.shape[0] // self.n_data
            return x[self.rank * b:(self.rank + 1) * b]

        return _rebuild(tree, iter([cut(x) for x in _leaves(tree)]))

    def gather_batch(self, tree):
        """Every rank's ``tree`` laid end to end on the leading axis, rank by
        rank: one ``all_gather`` of every tensor's bytes in one flat buffer."""
        leaves = _leaves(tree)
        parts = [x.contiguous().reshape(-1).view(torch.uint8) for x in leaves]
        flat = torch.cat(parts)
        out = torch.empty(self.n_data * flat.numel(), dtype=torch.uint8, device=flat.device)
        self._count("all_gather", flat)
        _all_gather_single(out, flat)
        out = out.view(self.n_data, flat.numel())
        gathered, off = [], 0
        for x, p in zip(leaves, parts):
            n = p.numel()
            piece = out[:, off:off + n].contiguous().view(x.dtype)
            gathered.append(piece.reshape((self.n_data * x.shape[0],) + tuple(x.shape[1:])))
            off += n
        return _rebuild(tree, iter(gathered))

    def _count(self, kind: str, payload: torch.Tensor) -> None:
        self.launches[kind] += 1
        self.payload_bytes[kind] += payload.numel() * payload.element_size()

    def ring_layout(self, size: int, period: int) -> RingLayout:
        """This rank's ``RingLayout`` of a ring of ``size`` episodes."""
        return RingLayout(size, period, self.n_data, self.rank)

    def gather_sample(self, ring: Dict[str, torch.Tensor], idx: torch.Tensor,
                      layout: RingLayout, device=None) -> Dict[str, torch.Tensor]:
        """This rank's shard of the sample ``{k: ring[k][idx]}`` of the global
        ring that ``ring`` (this rank's part of it, laid out by ``layout``)
        belongs to: ``idx`` (iters, batch) holds global slots, alike on every
        rank, and the result holds rows ``rank * batch / n ..`` of each
        iteration, in the ring's dtypes, on ``device`` (default: the ring's).
        Each rank fills the rows it holds and zeros elsewhere, and one
        ``reduce_scatter`` sum of every plane's bytes hands out the shards:
        one rank's bytes and the others' zeros add up bit for bit. Shapes do
        not depend on the draw, so a CUDA graph captures it."""
        iters, batch = idx.shape
        n, b = self.n_data, batch // self.n_data
        src = next(iter(ring.values())).device
        dev = torch.device(device) if device is not None else src
        idx = idx.to(src)
        mine = (layout.owner(idx) == self.rank).to(torch.uint8)
        loc = layout.local(idx)
        parts, sizes = [], []
        for buf in ring.values():
            rows = _as_bytes(buf)[loc]  # (iters, batch, ..., bytes)
            rows = rows * mine.reshape(mine.shape + (1,) * (rows.dim() - 2))
            # (n, iters, b, ...): rank q's rows of every iteration together,
            # padded to 8 bytes so that each plane's piece views as its dtype
            rows = rows.to(dev).reshape((iters, n, b) + tuple(rows.shape[2:])).transpose(0, 1)
            rows = rows.reshape(n, -1)
            sizes.append(rows.shape[1])
            parts += [rows, rows.new_zeros((n, -rows.shape[1] % 8))]
        flat = torch.cat(parts, dim=1)
        out = torch.empty(flat.shape[1], dtype=torch.uint8, device=dev)
        self._count("reduce_scatter", flat)
        _reduce_scatter_single(out, flat.reshape(-1))
        shard, off = {}, 0
        for (k, buf), m in zip(ring.items(), sizes):
            shard[k] = out[off:off + m].view(buf.dtype).reshape((iters, b) + tuple(buf.shape[1:]))
            off += m + (-m % 8)
        return shard

    def gather_ring(self, ring: Dict[str, torch.Tensor], layout: RingLayout
                    ) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """The global ring on rank 0's host, each plane in global slot order
        (what a one-process ring holds), None on the other ranks; every rank
        must call it. The planes go in chunks of local episodes, each one
        ``all_gather`` of at most ``RING_CHUNK_BYTES`` a rank; returns the
        ring and the device bytes of the largest chunk's gather buffer."""
        host = None if self.rank else {}
        peak = 0
        slots = [layout.held_slots(q) for q in range(self.n_data)]
        for k, buf in ring.items():
            if host is not None:
                host[k] = torch.empty((layout.size,) + tuple(buf.shape[1:]), dtype=buf.dtype)
            per = max(1, buf[0].numel() * buf.element_size())
            step = max(1, min(layout.local_size, RING_CHUNK_BYTES // per))
            for a in range(0, layout.local_size, step):
                e = min(a + step, layout.local_size)
                part = _as_bytes(buf[a:e]).reshape(-1)
                out = torch.empty(self.n_data * part.numel(), dtype=torch.uint8,
                                  device=buf.device)
                peak = max(peak, out.numel())
                self._count("all_gather", part)
                _all_gather_single(out, part)
                if host is not None:
                    out = out.cpu().view(buf.dtype).reshape((self.n_data, e - a)
                                                            + tuple(buf.shape[1:]))
                    for q in range(self.n_data):
                        host[k][slots[q][a:e]] = out[q]
        return host, peak

    def all_reduce_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sums ``flat`` over the ranks, in place."""
        self._count("all_reduce", flat)
        dist.all_reduce(flat)
        return flat

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (one all_reduce MAX): every rank
        takes the same branch at a host boundary."""
        t = torch.tensor([int(bool(flag))], device=self.device)
        self._count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier()


def maybe_make_mesh(args, device: torch.device, logger=None) -> Optional[MeshContext]:
    """The data mesh of a run (``run.py``): a ``MeshContext`` over the
    process group when there is one (``distributed=True``), else None.

    ``mesh_shape`` (e.g. ``{data: 2}``) must equal the world size, else
    ValueError; without a process group the world is this one process. The
    JAX package's one process sees several devices and may fall back to one
    of them when the sizes do not divide; here a world of processes cannot,
    so ``batch_size_run``, ``batch_size`` and ``buffer_size`` must divide
    over the ranks, else ValueError."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = getattr(args, "mesh_shape", None)
    if shape:
        n = int(np.prod([int(v) for v in dict(shape).values()]))
        if n != world:
            raise ValueError(f"mesh_shape {dict(shape)} needs {n} processes, this run has "
                             f"{world} (distributed=True with num_processes={n}, or "
                             f"torchrun --nproc_per_node={n})")
    if not dist.is_initialized():
        return None
    mesh = MeshContext(device)
    for key in ("batch_size_run", "batch_size", "buffer_size"):
        mesh.check_divisible(int(getattr(args, key)), key)
    if logger is not None:
        logger.info("data mesh: rank %d of %d processes (%s)", mesh.rank, mesh.n_data,
                    dist.get_backend())
    return mesh
