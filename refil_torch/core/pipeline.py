"""Fused block pipeline, port of ``refil_tpu/core/pipeline.py``.

A block is one episode block of training, with no host sync in it:

  rollout (``VectorRunner.rollout``; epsilon from the device ``t_env``)
  -> ring insert at ``buffer_index`` (the ring is a multiple of
     ``batch_size_run``, so the insert is contiguous and never wraps)
  -> counters
  -> on a train block: ``training_iters`` samples, each uniform without
     replacement over the filled prefix (Gumbel top-k on the device), the
     gather cast back to the rollout dtypes, ``training_iters`` learner
     updates, the gt diagnostics on the last sample when the config asks
     for them, and the hard target sync on the reference cadence
     (pre-increment episode counter) as an in-place device select.

Everything a block changes lives in device tensors that it updates in place
(``PipelineState``): the ring, the counters, and the learner's parameters,
targets and optimiser state. The JAX package makes a block one donated
``jit`` dispatch and N blocks one ``lax.scan``. On CUDA each kind of block,
the warm-up block (rollout and insert) and the train block (all of it), is
captured once as a ``torch.cuda.CUDAGraph`` over those tensors and then
replayed: a dispatch of n blocks is n replays. The first block of each kind
runs eagerly on the capture's stream, as a real block of the run and the
capture's warm-up, timed between two device syncs (``eager_seconds``;
capture and instantiate are ``setup_seconds``). A capture that fails raises; nothing runs a block eagerly
in place of its graph. A block packs its stats into one float64 device
vector, which is copied after each replay into a row of a pinned host
buffer; a dispatch ends in one synchronisation (``jax.device_get(stats)``
in the JAX loop). On the CPU the same block runs eagerly.

Explicit generators take the place of the JAX key: the runner's (rollout),
the pipeline's (sample) and the learner's (imagine groups, diagnostics).
Each is registered with the graphs, so every replay draws new numbers.

With a data mesh (``parallel/mesh.py``, one process per device), the ring
is sharded as the JAX package's is: each rank holds ``buffer_size / n``
episodes, the global slots whose envs it steps (``RingLayout`` with period
``batch_size_run``), so a block rolls out this rank's shard of the envs from
the global draws, writes its episodes into its own ring and gathers only
the block's stats (one ``all_gather``). The sample slots are drawn at the
global shape on every rank alike; one ``reduce_scatter`` (``gather_sample``)
hands each rank its shard of the sample, each rank trains on it with the
global mask count (one ``all_reduce`` of the block's counts), and each
update sums the gradients and the metrics over the ranks (one
``all_reduce``). ``buffer_index`` and ``episodes_in_buffer`` stay global.
On CUDA the collectives are captured into the graphs with the rest of the
block (NCCL); the mesh counts them beside the kernels' launches.

The kernel wrappers count launches in Python, which a replay does not run:
``graphs[kind].launches`` holds what the capture recorded (the wrappers'
counts rose by that much while it recorded and launched nothing), so a
run's launches are the counts plus ``launches x (replays - 1)`` per graph.

Each block leaves a record in the pipeline's ``timer`` (``utils/profiling.py``).
With ``trace_blocks`` (the default) one-thread kernels (``ops/stamp.py``)
write the device's clock at the block's stage boundaries (start, rollout,
insert and counters, sample, each update's agents' forward, its mixers and
loss, and its end after RMSprop, the gt diagnostics, the target sync, the
stats packed) into an int64 buffer of their own, outside the stats and the
state; a replay rewrites them, and ``run_blocks`` copies them out after each
block as it does the stats. The host's side is spans: each replay's
``launch``, the closing ``sync``, the eager first blocks, each capture and
instantiate.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import stamp as stamp_op
from ..parallel.mesh import RingLayout
from ..utils.profiling import CLOCK_NS, BlockRecord, PhaseTimer
from .buffer import storage_dtype


@dataclasses.dataclass
class PipelineState:
    """The pipeline's state: ``train`` is the learner, whose parameters,
    targets and optimiser state the blocks update in place; the counters
    are int32 0-d tensors on the device. Under a data mesh ``ring`` holds
    this rank's ``buffer_size / n`` episodes, laid out by ``layout``."""

    train: Any
    ring: Dict[str, torch.Tensor]  # {key: (buffer_size / n, T+1, ...)}
    buffer_index: torch.Tensor
    episodes_in_buffer: torch.Tensor
    t_env: torch.Tensor
    episode: torch.Tensor
    last_target_episode: torch.Tensor
    generators: Dict[str, torch.Generator]  # rollout, sample, learner
    layout: Optional[RingLayout] = None  # the ring's sharding (None: one process)


@dataclasses.dataclass
class CapturedBlock:
    """One kind of block captured as a CUDA graph."""

    graph: Any  # torch.cuda.CUDAGraph
    out: torch.Tensor  # the packed stats, rewritten by every replay
    state: PipelineState  # the state whose tensors the graph reads and writes
    launches: Dict[str, int]  # kernel launches the capture recorded
    capture_seconds: float
    instantiate_seconds: float
    pool_bytes: int  # device memory the capture reserved (the graph's pool)
    replays: int = 0
    # a mesh's: the bytes this rank hands to each kind of collective a replay
    collective_bytes: Optional[Dict[str, int]] = None

    def summary(self) -> Dict[str, Any]:
        out = {"replays": self.replays, "launches": dict(self.launches),
               "capture_seconds": self.capture_seconds,
               "instantiate_seconds": self.instantiate_seconds, "pool_bytes": self.pool_bytes}
        if self.collective_bytes is not None:
            out["collective_bytes"] = dict(self.collective_bytes)
        return out


def launch_counts(mesh=None) -> Dict[str, int]:
    """The kernel wrappers' launch counts, and the mesh's collectives'."""
    from ..ops import combat_env, entity_attn, gru_kernel

    return {**entity_attn.launches, **gru_kernel.launches, **combat_env.launches,
            **({} if mesh is None else mesh.launches)}


def _flatten(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


class FusedPipeline:
    """Owns the block. ``runner`` and ``learner`` supply its stages
    (``VectorRunner.rollout``, ``QLearner.updates``)."""

    def __init__(self, runner, learner, buffer_size: int, args, mesh=None,
                 timer: Optional[PhaseTimer] = None):
        self.mesh = mesh  # Optional[parallel.mesh.MeshContext]
        # the spans and block records (utils/profiling.py): the run's, or one
        # of the pipeline's own
        self.timer = timer if timer is not None else PhaseTimer()
        self.runner = runner
        self.learner = learner
        self.device = learner.device
        self.batch_size_run = int(args.batch_size_run)
        # the ring rounds up to a multiple of batch_size_run, so a block's
        # insert is one contiguous run of slots at buffer_index
        self.buffer_size = -(-int(buffer_size) // self.batch_size_run) * self.batch_size_run
        if self.buffer_size != int(buffer_size):
            logging.getLogger("refil_torch").info(
                "replay ring rounded %d -> %d episodes (a multiple of batch_size_run=%d keeps "
                "the insert contiguous)", int(buffer_size), self.buffer_size, self.batch_size_run)
        self.batch_size = int(args.batch_size)
        self.buffer_dtype = str(getattr(args, "buffer_dtype", "float32"))
        if self.buffer_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"buffer_dtype must be float32 or bfloat16, not {self.buffer_dtype!r}")
        self.layout = None
        if mesh is not None:
            mesh.check_divisible(self.batch_size_run, "batch_size_run")
            mesh.check_divisible(self.batch_size, "batch_size")
            mesh.check_divisible(self.buffer_size, "buffer_size")
            self.layout = mesh.ring_layout(self.buffer_size, self.batch_size_run)
        self.n_data = 1 if mesh is None else mesh.n_data
        self.training_iters = int(args.training_iters)
        self.target_update_interval = int(args.target_update_interval)
        self.gt_diag = bool(getattr(args, "test_gt_factors", False)) and learner.has_gt_diagnostics
        self.use_graphs = self.device.type == "cuda"
        # device stamps at the block's stage boundaries (ops/stamp.py), one
        # slot each: start, rollout, insert, sample, each update's three
        # (agents, mix, update), the gt diagnostics, the target sync, the
        # stats packed; outside the stats and the state
        self.trace_blocks = bool(getattr(args, "trace_blocks", True))
        self._stamps = (torch.zeros(6 + 3 * self.training_iters + int(self.gt_diag),
                                    dtype=torch.int64, device=self.device)
                        if self.trace_blocks else None)
        self._stamp_names: Dict[str, Tuple[str, ...]] = {}  # by kind of block
        self._cursor: Optional[List[str]] = None  # the boundaries stamped so far in a block
        self._launch = None  # the last replay's launch span
        self.dispatches = 0  # run_blocks calls so far
        self.graphs: Dict[str, CapturedBlock] = {}
        self.setup_seconds = 0.0  # capture + instantiate, once per kind of block
        self.eager_seconds = 0.0  # the eager first blocks, each timed between syncs
        self._eager_done: set = set()
        self._stream = None  # the eager first blocks' and the captures' stream
        self._layout: Dict[str, list] = {}
        self._dtypes: Dict[str, torch.dtype] = {}
        self._slots = torch.arange(self.buffer_size, device=self.device)
        # this rank's slots of a block's insert, from buffer_index / n
        self._block_slots = torch.arange(self.batch_size_run // self.n_data, device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, sample_generator: torch.Generator, t_env: int = 0,
                   episode: int = 0) -> PipelineState:
        """Allocates the ring once, from the shapes of one rollout
        (``VectorRunner.batch_spec``), each plane in its storage dtype: under
        a mesh this rank's ``buffer_size / n`` episodes."""
        spec = self.runner.batch_spec()
        self._dtypes = {k: dt for k, (_, dt) in spec.items()}
        with self.timer.span("setup.ring"):
            ring = {k: torch.zeros((self.buffer_size // self.n_data,) + shape,
                                   dtype=storage_dtype(k, dt, self.buffer_dtype),
                                   device=self.device)
                    for k, (shape, dt) in spec.items()}
        if self.trace_blocks:
            with self.timer.span("setup.clock"):
                self.anchor_clock(8)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return PipelineState(
            train=self.learner, ring=ring, buffer_index=i32(0), episodes_in_buffer=i32(0),
            t_env=i32(t_env), episode=i32(episode), last_target_episode=i32(episode),
            generators={"rollout": self.runner.generator, "sample": sample_generator,
                        "learner": self.learner.generator}, layout=self.layout)

    def anchor_clock(self, rounds: int = 1) -> None:
        """Anchors the stamps' clock on the host clock (``PhaseTimer.anchor``):
        each round reads the host clock, stamps, synchronises and reads it
        again; the stamp lies between the two reads, taken at their midpoint
        (on the CPU a stamp is itself a host read). Set-up takes 8 rounds,
        the fused loop one after each dispatch, outside its blocks."""
        for _ in range(rounds):
            self._sync()
            before = CLOCK_NS()
            stamp_op.stamp(self._stamps, 0)
            self._sync()
            after = CLOCK_NS()
            t = int(self._stamps[0])
            if self.use_graphs:
                self.timer.anchor(t, (before + after) // 2, (after - before) // 2)
            else:
                self.timer.anchor(t, t, 0)

    def _sync(self) -> None:
        if self.use_graphs:
            torch.cuda.synchronize(self.device)

    def _stamp(self, name: str) -> None:
        """The stage boundary ``name`` of the block being run, into its slot."""
        if self._cursor is not None:
            stamp_op.stamp(self._stamps, len(self._cursor))
            self._cursor.append(name)

    def sample_idx(self, episodes_in_buffer: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """(training_iters, batch_size) int64 slots, each row uniform without
        replacement over the filled prefix: the top ``batch_size`` of Gumbel
        draws (-log of Exp(1)), -inf past ``episodes_in_buffer``."""
        e = torch.empty((self.training_iters, self.buffer_size), device=self.device)
        g = -torch.log(e.exponential_(generator=generator))
        g = g.masked_fill(self._slots >= episodes_in_buffer, float("-inf"))
        return torch.topk(g, self.batch_size, dim=1).indices

    # ------------------------------------------------------------------
    def _block_impl(self, ps: PipelineState, train: bool) -> Dict[str, Any]:
        B = self.batch_size_run
        self._stamp("start")
        epsilon = self.runner.schedule.eval(ps.t_env.float())
        batch, roll = self.runner.rollout(epsilon, B, shard=self.mesh, gather_episodes=False)
        self._stamp("rollout")
        # buffer_index is a multiple of B: this rank's B / n slots of the
        # block sit at buffer_index / n in its ring (RingLayout)
        slots = ps.buffer_index.long() // self.n_data + self._block_slots
        for k, buf in ps.ring.items():
            buf.index_copy_(0, slots, batch[k].to(buf.dtype))
        ps.buffer_index.copy_((ps.buffer_index + B) % self.buffer_size)
        ps.episodes_in_buffer.copy_(torch.clamp_max(ps.episodes_in_buffer + B, self.buffer_size))
        ps.t_env.add_(roll["ep_lengths"].sum().to(torch.int32))
        stats = {**roll, "epsilon": epsilon, "t_env": ps.t_env}
        if train:
            self._stamp("insert")
            stats["metrics"] = self.train_half(ps)
        ps.episode.add_(B)
        self._stamp("sync" if train else "insert")
        return stats

    def train_half(self, ps: PipelineState, draws: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, torch.Tensor]:
        """A train block after its insert: sample, gather, updates, gt
        diagnostics, target sync; returns the metrics. ``draws`` (tests)
        injects {"idx": slots, "imagine": per-update draws, "diag": draws}.
        Under a mesh the sample is this rank's shard of the global one."""
        draws = draws or {}
        idx = draws.get("idx")
        if idx is None:
            idx = self.sample_idx(ps.episodes_in_buffer, ps.generators["sample"])
        if self.mesh is None:
            samples = {k: buf[idx] for k, buf in ps.ring.items()}
        else:
            samples = self.mesh.gather_sample(ps.ring, idx, ps.layout)
        samples = {k: v.to(self._dtypes[k]) for k, v in samples.items()}
        self._stamp("sample")
        metrics = self.learner.updates(samples, draws.get("imagine"), mesh=self.mesh,
                                       stamp=self._stamp)
        if self.gt_diag:
            last = {k: v[-1] for k, v in samples.items()}
            metrics.update(self.learner.gt_diagnostics(last, draws.get("diag"), mesh=self.mesh))
            self._stamp("diag")
        # hard target sync on the pre-increment episode counter
        do_sync = (ps.episode - ps.last_target_episode) >= self.target_update_interval
        self.learner.sync_targets_where(do_sync)
        ps.last_target_episode.copy_(torch.where(do_sync, ps.episode, ps.last_target_episode))
        return metrics

    def block_device(self, ps: PipelineState, train: bool = True) -> torch.Tensor:
        """One block, run eagerly on the current stream; returns its stats
        packed into a float64 vector on the device (nothing waits for it).
        With ``trace_blocks`` its stage boundaries are stamped as well, the
        last (``pack``) once its stats are packed: the block's end."""
        kind = "train" if train else "warm"
        self._cursor = [] if self.trace_blocks else None
        try:
            leaves = _flatten(self._block_impl(ps, train))
            layout = [(path, tuple(t.shape)) for path, t in leaves]
            if self._layout.setdefault(kind, layout) != layout:
                raise RuntimeError(f"the {kind} block's stats changed layout")
            out = torch.cat([t.reshape(-1).to(torch.float64) for _, t in leaves])
            self._stamp("pack")
        finally:
            names, self._cursor = self._cursor, None
        if names is not None and self._stamp_names.setdefault(kind, tuple(names)) != tuple(names):
            raise RuntimeError(f"the {kind} block's stamps changed: {names}")
        return out

    def _unpack(self, rows: np.ndarray, kind: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        i = 0
        for path, shape in self._layout[kind]:
            n = int(np.prod(shape))
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = rows[:, i:i + n].reshape((rows.shape[0],) + shape)
            i += n
        return out

    # ------------------------------------------------------------------
    def _eager_first(self, ps: PipelineState, train: bool) -> torch.Tensor:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        with self.timer.span("eager." + ("train" if train else "warm")) as span:
            main = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                out = self.block_device(ps, train)
            main.wait_stream(self._stream)
            out.record_stream(main)
            torch.cuda.synchronize(self.device)
        self.eager_seconds += span.seconds
        return out

    def _capture(self, ps: PipelineState, kind: str) -> CapturedBlock:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts(self.mesh)
        moved = None if self.mesh is None else dict(self.mesh.payload_bytes)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in ps.generators.values():
            graph.register_generator_state(gen)
        # NCCL's watchdog thread queries events while a capture runs: a
        # global-mode capture would forbid that, so a mesh's capture is
        # thread-local
        mode = "global" if self.mesh is None else "thread_local"
        with self.timer.span("capture." + kind) as captured:
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode=mode):
                out = self.block_device(ps, kind == "train")
        with self.timer.span("instantiate." + kind) as instantiated:
            graph.instantiate()
        after = launch_counts(self.mesh)
        rec = CapturedBlock(graph=graph, out=out, state=ps,
                            launches={k: after[k] - before[k] for k in after},
                            capture_seconds=captured.seconds,
                            instantiate_seconds=instantiated.seconds,
                            pool_bytes=torch.cuda.memory_reserved(self.device) - reserved,
                            collective_bytes=None if moved is None else {
                                k: v - moved[k] for k, v in self.mesh.payload_bytes.items()})
        self.setup_seconds += captured.seconds + instantiated.seconds
        self.graphs[kind] = rec
        return rec

    def _next_block(self, ps: PipelineState, train: bool) -> torch.Tensor:
        if not self.use_graphs:
            return self.block_device(ps, train)
        kind = "train" if train else "warm"
        rec = self.graphs.get(kind)
        if rec is None:
            if kind not in self._eager_done:
                self._eager_done.add(kind)
                return self._eager_first(ps, train)
            rec = self._capture(ps, kind)
        if rec.state is not ps:
            raise ValueError("a captured block replays only on the PipelineState it was "
                             "captured over")
        with self.timer.span("launch") as self._launch:
            rec.graph.replay()
        rec.replays += 1
        return rec.out

    def replays(self) -> int:
        """Blocks run so far as graph replays."""
        return sum(g.replays for g in self.graphs.values())

    def run_blocks(self, ps: PipelineState, n_blocks: int, train: bool = True
                   ) -> Dict[str, Any]:
        """``n_blocks`` blocks in one dispatch; ``ps`` is updated in place.
        Returns their stats on the host (numpy), each leaf stacked on a
        leading block axis, fetched with one synchronisation. Each block
        leaves a record in ``timer`` (``utils/profiling.BlockRecord``): with
        ``trace_blocks`` its stamps, copied after it as its stats are."""
        kind = "train" if train else "warm"
        dispatch, self.dispatches = self.dispatches, self.dispatches + 1
        pin = self.use_graphs
        stamps = (torch.empty((n_blocks, self._stamps.numel()), dtype=torch.int64, pin_memory=pin)
                  if self.trace_blocks else None)
        host, launches = None, []
        for bi in range(n_blocks):
            self._launch = None
            out = self._next_block(ps, train)
            launches.append(self._launch)
            if host is None:
                host = torch.empty((n_blocks, out.numel()), dtype=torch.float64, pin_memory=pin)
            host[bi].copy_(out, non_blocking=True)
            if stamps is not None:
                stamps[bi].copy_(self._stamps, non_blocking=True)
        if self.use_graphs:
            with self.timer.span("sync"):
                torch.cuda.current_stream(self.device).synchronize()
        rows = None if stamps is None else stamps.tolist()
        names = self._stamp_names.get(kind, ())
        for bi, span in enumerate(launches):
            self.timer.record_block(BlockRecord(
                dispatch=dispatch, kind=kind, replay=span is not None,
                launch_ns=None if span is None else span.end_ns - span.start_ns,
                stamps=None if rows is None else rows[bi][:len(names)], names=names))
        return self._unpack(host.numpy(), kind)

    def block(self, ps: PipelineState, train: bool = True) -> Dict[str, Any]:
        """One block; its stats on the host, unstacked."""
        stats = self.run_blocks(ps, 1, train)

        def first(tree):
            return {k: first(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]

        return first(stats)

    def warmup_blocks(self) -> int:
        """Rollout-only blocks before the ring can serve a full sample."""
        return max(1, -(-self.batch_size // self.batch_size_run))
