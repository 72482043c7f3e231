"""Runs one cell of the benchmark through refil_torch's own training loop.

``run_cell`` builds the cell's command line from its configuration and
traffic files and runs ``refil_torch.main.main`` on it: the fused loop,
``run_sequential`` -> ``_run_fused_loop`` -> ``FusedPipeline.run_blocks``.
It changes nothing in the program; it wraps a few of its functions from
outside, for the length of the run:

* ``run.build_training``: hands the learner the weights the benchmark made
  from the seed (live and target networks alike);
* ``FusedPipeline._capture``: the end of the train block's capture ends
  set-up and starts the window (on the CPU, where nothing is captured, the
  end of the first train dispatch does);
* ``FusedPipeline.run_blocks``: the window ends at the first dispatch
  boundary after ``seconds``, through the loop's own preemption check
  (``run._preempt_due``), with ``preempt_save_buffer=False``;
* ``FusedPipeline.block_device``, ``VectorRunner.rollout``, the controllers'
  ``forward_step``, ``FusedPipeline.sample_idx``, ``QLearner.train_step``
  and ``ops.masks.draw_imagine_groups``: the first train block (set-up's
  eager block) is recorded for ``check``: its rollout's episodes and
  Q-values, the ring's rows its insert wrote, the slots its sample drew
  and those slots' episodes read from the ring, and its first three
  updates' losses and state (and the imagined bipartitions, where the
  learner draws them);
* ``VectorRunner.run`` in test mode (the loop's periodic greedy test): each
  test's t_env and its episodes' lengths and terminations (``Tests``), and
  the window's first test whole on the checked envs' rows: its episodes,
  its agents' Q at each step and the parameters it ran with.

Once the window has closed, ``replay_readings`` holds the timed path itself
to the eager one: from a snapshot of what a train block may change (the
state outside the ring whole, the ring's rows at the block's insert slots,
a digest of every other row), one train block is replayed from the
captured graph and the same block is run eagerly
(``FusedPipeline.block_device``, the code the graph captured), and the two
results are compared (``replay_gap``); set-up's eager block is the one held
to the reference. The window's numbers come from the loop's summary
(``dispatches``) and the host clock. The window holds whatever the loop
runs between its train dispatches, the test rollouts among it, and counts
the train blocks' env steps alone. With ``trace``,
``TRACE_BLOCKS`` more train blocks are replayed under the profiler once the
window has closed (``benchmark/trace.py``), and the per-layer metrics are
read from both by ``benchmark/metrics/<name>.py``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import check, trace as tracing

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
RUN_DIR = os.path.join(BENCH_DIR, "_run")
FORBIDDEN = ("jax", "jaxlib", "flax", "refil_tpu")
TRACE_BLOCKS = 2
CHECK_UPDATES = 3
# the replay check's scratch: each step of a digest or of a comparison
# holds at most this many bytes (or one ring row as int64 words)
CHUNK_BYTES = 1 << 27
DIGEST_SEED = 20240611


# ------------------------------------------------------------------ the cell
def load_cell(workload: str):
    """The cell's entry, its configuration and traffic files, its check's
    limits and the per-layer metrics it reports."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "workloads", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(BENCH_DIR, "checks", workload + ".json")) as f:
        limits = json.load(f)["limits"]
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": bench["end_to_end"], "per_layer": per_layer}


def cell_sizes(config, traffic) -> Dict[str, Any]:
    """The sizes the run uses: the configuration's, with the traffic's run
    keys (batch_size_run, buffer_size) over them."""
    return {**config["sizes"], **{k: v for k, v in traffic["run"].items()
                                  if k in ("batch_size_run", "buffer_size")}}


def command_line(config, traffic, seed: int, device: str) -> List[str]:
    keys = {**config["overrides"], **traffic["run"], "seed": int(seed),
            "use_cuda": device == "cuda", "local_results_path": os.path.join(RUN_DIR, "results"),
            "handle_preemption": True, "preempt_save_buffer": False, "save_model": False,
            "use_tensorboard": False}
    return ([f"--config={config['alg']}", f"--env-config={config['env']}", "with"]
            + [f"{k}={v}" for k, v in keys.items()])


def _seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


# ------------------------------------------------------------------ recording
class Recorder:
    """The first train block: its rollout (the checked envs' episodes and
    their Q-values at each step), its insert (the ring's rows at the checked
    envs' slots), its sample (the slots drawn, the filled prefix, and the
    first three updates' episodes gathered from the ring at those slots)
    and its first three updates (the bipartitions drawn, the losses, the
    first gradient's norm by leaf from RMSprop's state after one step, the
    change by leaf after three)."""

    def __init__(self, env_rows: torch.Tensor, params0: Dict[str, torch.Tensor],
                 alpha: float, names: List[str]):
        self.env_rows = env_rows
        self.params0 = params0
        self.alpha = alpha
        self.names = names
        self.active = False
        self.done = False
        self.calls = 0
        self.batches, self.draws, self.loss_t = [], [], []
        self.q_steps: List[torch.Tensor] = []
        self.rollout_batch: Optional[Dict[str, torch.Tensor]] = None
        self.inserted: Optional[Dict[str, torch.Tensor]] = None
        self.idx: Optional[torch.Tensor] = None  # (training_iters, batch_size) slots
        self.filled: Optional[torch.Tensor] = None  # episodes_in_buffer at the sample
        self.grad_t: Optional[torch.Tensor] = None
        self.change_t: Optional[torch.Tensor] = None

    def on_sample(self, ps, idx, episodes_in_buffer, batch_size_run):
        """The sample's slots, and the ring's rows at them and at the checked
        envs' slots of the insert that came before it."""
        self.idx, self.filled = idx.clone(), episodes_in_buffer.clone()
        size = next(iter(ps.ring.values())).shape[0]
        rows = (ps.buffer_index.long() - batch_size_run) % size + self.env_rows
        self.inserted = {k: v[rows].clone() for k, v in ps.ring.items()}
        self.batches = [{k: v[idx[i]].clone() for k, v in ps.ring.items()}
                        for i in range(CHECK_UPDATES)]

    def on_train_step(self, learner):
        """Before update ``calls``: the state the earlier ones left."""
        i = self.calls
        if i == 1:  # an optimizer that kept no state got no gradient: norm 0
            sq = [learner.optimiser.state[p].get("square_avg", torch.zeros_like(p))
                  for p in learner.params]
            self.grad_t = torch.stack([torch.sqrt(s.sum() / (1.0 - self.alpha)) for s in sq])
        if i == CHECK_UPDATES:
            self.change_t = torch.stack([torch.linalg.vector_norm(p.detach() - self.params0[n])
                                         for n, p in zip(self.names, learner.params)])
        self.calls += 1
        return i < CHECK_UPDATES

    # --- what check reads, on the host
    @property
    def losses(self) -> List[float]:
        return [float(v) for v in self.loss_t]

    def sampled(self) -> check.Sample:
        return check.Sample(self.idx.cpu(), int(self.filled), self.draws,
                            self.rollout_batch, self.inserted)

    def outputs(self) -> check.Outputs:
        return check.Outputs(self.losses, dict(zip(self.names, self.grad_t.tolist())),
                             dict(zip(self.names, self.change_t.tolist())), self.rollout_q)

    @property
    def rollout_q(self) -> torch.Tensor:
        return torch.stack(self.q_steps, dim=1)  # (envs, T, Na, A)

    def complete(self) -> bool:
        return (len(self.batches) == CHECK_UPDATES and len(self.draws) in (0, CHECK_UPDATES)
                and self.grad_t is not None and self.change_t is not None
                and self.rollout_batch is not None and bool(self.q_steps)
                and self.inserted is not None)


class Tests:
    """The run's test rollouts, as the loop's test entry returned them:
    (t_env, filled, terminated) of each, and the window's first test on the
    checked envs' rows (``check.TestRollout``): its episodes, its agents' Q
    at each step, and the parameters it ran with, copied as it starts. All
    is kept on the host, so that the device's peak within the window is
    the program's."""

    def __init__(self, env_rows: torch.Tensor, learner, names: List[str]):
        self.env_rows = env_rows
        self.learner = learner
        self.names = names
        self.seen: List = []
        self.recording = False
        self.q_steps: Any = []  # the first test's Q a step; then all of it, on the host
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.batch: Optional[Dict[str, torch.Tensor]] = None

    def rows(self, episodes: int) -> torch.Tensor:
        """The checked envs' rows that a test of ``episodes`` holds."""
        return self.env_rows[self.env_rows < episodes]

    def rollout(self) -> Optional[check.TestRollout]:
        if self.batch is None:
            return None
        dev = self.env_rows.device
        return check.TestRollout({k: v.to(dev) for k, v in self.batch.items()},
                                 self.q_steps.to(dev),
                                 {k: v.to(dev) for k, v in self.params.items()})


class Window:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        # the same two instants on the program's span clock (time.time_ns)
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.stop = False
        self.closed = False
        self.first_dispatch = True
        self.blocks = 0
        self.failed = 0
        self.pipeline = None
        self.state = None
        self.first_gens: Optional[Dict[str, torch.Tensor]] = None
        self.marks: Dict[str, float] = {}  # host times of set-up's steps


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def instrument(ref_mod, sizes, seed: int, window: Window, holder: Dict[str, Any],
               check_envs: int):
    """Wraps the program's functions for one run (see the module's docstring)."""
    from refil_torch import run as prun
    from refil_torch.controllers.mac import BasicMAC, EntityMAC
    from refil_torch.core.pipeline import FusedPipeline
    from refil_torch.learners.q_learner import QLearner
    from refil_torch.ops import masks
    from refil_torch.runners.vector_runner import VectorRunner

    orig: Dict[str, Any] = {}

    def build_training(args, logger, device):
        window.marks["build"] = time.perf_counter()
        runner, learner, gens = orig["build_training"](args, logger, device)
        _check_sizes(args, runner, sizes)
        gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
        params0 = ref_mod.init_params(sizes, gen, device)
        names = learner.param_names()
        if sorted(names) != sorted(params0) or any(
                tuple(p.shape) != tuple(params0[n].shape) for n, p in zip(names, learner.params)):
            raise RuntimeError("the program's parameters are not the reference's: "
                               f"{[(n, tuple(p.shape)) for n, p in zip(names, learner.params)]}")
        with torch.no_grad():
            for n, p, t in zip(names, learner.params, learner.target_params):
                p.copy_(params0[n])
                t.copy_(params0[n])
        B = int(args.batch_size_run)
        rows = torch.randperm(B, generator=torch.Generator().manual_seed(_seed(seed, 2)))
        rows = rows[:min(check_envs, B)].sort().values.to(device)
        holder["recorder"] = Recorder(rows, params0, float(sizes["optim_alpha"]), names)
        holder["tests"] = Tests(rows, learner, names)
        holder["cadence"] = (float(args.test_interval),
                             max(1, int(args.test_nepisode) // B) * B)
        window.marks["built"] = time.perf_counter()
        return runner, learner, gens

    def block_device(self, ps, train=True):
        rec = holder.get("recorder")
        window.pipeline, window.state = self, ps
        if not train or rec is None or rec.done:
            return orig["block_device"](self, ps, train)
        rec.active = True
        try:
            return orig["block_device"](self, ps, train)
        finally:
            rec.active, rec.done = False, True

    def rollout(self, *args, **kwargs):
        batch, stats = orig["rollout"](self, *args, **kwargs)
        rec = holder.get("recorder")
        if rec is not None and rec.active and rec.rollout_batch is None:
            rec.rollout_batch = {k: v[rec.env_rows].clone() for k, v in batch.items()}
        return batch, stats

    def recording_step(step):
        def forward_step(self, obs, last_actions_onehot, hidden):
            q, h = step(self, obs, last_actions_onehot, hidden)
            rec = holder.get("recorder")
            if rec is not None and rec.active and rec.rollout_batch is None:
                rec.q_steps.append(q[rec.env_rows].detach().clone())
            tests = holder.get("tests")
            if tests is not None and tests.recording:
                tests.q_steps.append(q[tests.rows(q.shape[0])].detach().clone())
            return q, h
        return forward_step

    def run(self, *args, **kwargs):
        tests = holder.get("tests")
        if not kwargs.get("test_mode", args[0] if args else False) or tests is None:
            return orig["run"](self, *args, **kwargs)
        first = window.start is not None and tests.batch is None
        if first:
            tests.params = {n: p.detach().cpu().clone()
                            for n, p in zip(tests.names, tests.learner.params)}
            tests.recording = True
        try:
            batch = orig["run"](self, *args, **kwargs)
        finally:
            tests.recording = False
        tests.seen.append((int(self.t_env), batch["filled"].cpu(), batch["terminated"].cpu()))
        if first:
            rows = tests.rows(batch["filled"].shape[0])
            tests.batch = {k: v[rows].cpu() for k, v in batch.items()}
            tests.q_steps = torch.stack(tests.q_steps, dim=1).cpu()
        return batch

    def sample_idx(self, episodes_in_buffer, generator):
        idx = orig["sample_idx"](self, episodes_in_buffer, generator)
        rec = holder.get("recorder")
        if rec is not None and rec.active and rec.idx is None:
            if self.n_data != 1:
                raise RuntimeError("the benchmark reads one process's ring")
            rec.on_sample(window.state, idx, episodes_in_buffer, self.batch_size_run)
        return idx

    def train_step(self, batch, *args, **kwargs):
        rec = holder.get("recorder")
        keep = rec is not None and rec.active and rec.on_train_step(self)
        metrics = orig["train_step"](self, batch, *args, **kwargs)
        if keep:
            rec.loss_t.append(metrics["loss"].detach().clone())
        return metrics

    def draw_imagine_groups(*args, **kwargs):
        probs, group_a = orig["draw_imagine_groups"](*args, **kwargs)
        rec = holder.get("recorder")
        if rec is not None and rec.active and len(rec.draws) < CHECK_UPDATES:
            rec.draws.append((probs.clone(), group_a.clone()))
        return probs, group_a

    def capture(self, ps, kind):
        out = orig["_capture"](self, ps, kind)
        if kind == "train" and window.start is None:
            window.start, window.start_ns = time.perf_counter(), time.time_ns()
        return out

    def run_blocks(self, ps, n_blocks, train=True):
        replays = self.replays()
        if train and window.first_gens is None:  # what the first train block draws
            window.first_gens = {k: g.get_state() for k, g in ps.generators.items()}
            window.marks["train"] = time.perf_counter()
        stats = orig["run_blocks"](self, ps, n_blocks, train)
        now, now_ns = time.perf_counter(), time.time_ns()
        if window.closed or not train:
            return stats
        if window.start is None:
            # on the card a dispatch of the eager first block alone, before
            # the capture, is set-up's; on the CPU, with no capture, the
            # window starts after the first train dispatch
            if not self.use_graphs:
                window.start, window.start_ns, window.first_dispatch = now, now_ns, False
            return stats
        in_window = self.replays() - replays if window.first_dispatch else n_blocks
        window.first_dispatch = False
        loss = np.asarray(stats["metrics"]["loss"])[n_blocks - in_window:]
        window.blocks += in_window
        window.failed += int((~np.isfinite(loss)).sum())
        window.end, window.end_ns = now, now_ns
        if now - window.start >= window.seconds:
            window.stop = True
        return stats

    def preempt_due(guard, mesh):
        return window.stop or orig["_preempt_due"](guard, mesh)

    targets = [(prun, "build_training", build_training), (prun, "_preempt_due", preempt_due),
               (FusedPipeline, "block_device", block_device), (FusedPipeline, "_capture", capture),
               (FusedPipeline, "run_blocks", run_blocks), (VectorRunner, "rollout", rollout),
               (VectorRunner, "run", run),
               (FusedPipeline, "sample_idx", sample_idx),
               (EntityMAC, "forward_step", recording_step(EntityMAC.forward_step)),
               (BasicMAC, "forward_step", recording_step(BasicMAC.forward_step)),
               (QLearner, "train_step", train_step),
               (masks, "draw_imagine_groups", draw_imagine_groups)]
    with contextlib.ExitStack() as stack:
        for obj, name, new in targets:
            orig[name] = stack.enter_context(_patched(obj, name, new))
        yield


def _check_sizes(args, runner, sizes) -> None:
    """The run's configuration is the file's: every size the file states."""
    info = runner.env.env_info()
    seen = {**{k: getattr(args, k, None) for k in sizes}, **info,
            "episode_limit": runner.episode_limit}
    wrong = {k: (v, seen.get(k)) for k, v in sizes.items() if seen.get(k) != v}
    if wrong:
        raise RuntimeError(f"the run is not the configuration's: (file, run) {wrong}")


# ------------------------------------------------------------------ metrics
def load_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------------ the replay
def state_tensors(ps) -> Dict[str, torch.Tensor]:
    """Every tensor a block changes: the ring and ``outside_ring``."""
    return {**{f"ring.{k}": v for k, v in ps.ring.items()}, **outside_ring(ps)}


def outside_ring(ps) -> Dict[str, torch.Tensor]:
    """Every tensor a block changes but the ring: the counters, the
    parameters, the targets and the optimiser state."""
    out = {n: getattr(ps, n)
           for n in ("buffer_index", "episodes_in_buffer", "t_env", "episode", "last_target_episode")}
    learner = ps.train
    for i, (p, t) in enumerate(zip(learner.params, learner.target_params)):
        out[f"param.{i}"], out[f"target.{i}"] = p.data, t.data
        for k, v in learner.optimiser.state[p].items():
            if torch.is_tensor(v):
                out[f"opt.{i}.{k}"] = v
    return out


def _chunks(n: int, item_bytes: int):
    """(start, length) steps over ``n`` items of ``item_bytes`` each, every
    step at most CHUNK_BYTES (or one item)."""
    step = max(1, CHUNK_BYTES // max(1, item_bytes))
    return ((i, min(step, n - i)) for i in range(0, n, step))


def scaled_gap(a: torch.Tensor, b: torch.Tensor, floor: float = 1.0) -> float:
    """max |a - b| / max(floor, max |b|), ``floor`` at least 1: 0 where the
    two are equal. Worked in float64 a chunk at a time."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    steps = list(_chunks(fa.numel(), 24))  # three float64 temporaries an element
    unequal = [(i, n) for i, n in steps if not torch.equal(fa[i:i + n], fb[i:i + n])]
    if not unequal:
        return 0.0
    diff = torch.stack([(fa[i:i + n].double() - fb[i:i + n].double()).abs().max()
                        for i, n in unequal]).max()
    top = max(float(fb[i:i + n].double().abs().max()) for i, n in steps)
    return float(diff / max(1.0, floor, top))


class RingDigest:
    """An exact digest of each ring row, plane by plane: the row's bytes as
    signed words (32-bit where the row's length allows, else 16- or 8-bit),
    each times a fixed odd 64-bit weight, summed modulo 2**64. A change of
    one word always changes it (an odd weight is a unit modulo 2**64); any
    other change leaves it equal with odds of about 2**-64. Worked a chunk
    of rows at a time, so its scratch is at most CHUNK_BYTES or one row."""

    def __init__(self, ring: Dict[str, torch.Tensor]):
        self.words, n = {}, 1
        for k, plane in ring.items():
            row_bytes = plane[0].numel() * plane.element_size()
            dt, size = next((dt, size) for dt, size in
                            ((torch.int32, 4), (torch.int16, 2), (torch.uint8, 1))
                            if row_bytes % size == 0)
            self.words[k], n = dt, max(n, row_bytes // size)
        gen = torch.Generator().manual_seed(DIGEST_SEED)
        weights = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen, dtype=torch.int64) | 1
        self.weights = weights.to(next(iter(ring.values())).device)

    def __call__(self, ring: Dict[str, torch.Tensor], row_max: bool = False):
        """{plane: (rows,) int64 digests}, and with ``row_max`` {plane:
        (rows,) float64 largest |value| of each row}."""
        digests, maxima = {}, {}
        for k, plane in ring.items():
            rows = plane.shape[0]
            flat = plane.reshape(rows, -1)
            words = flat.view(torch.uint8).view(self.words[k])
            w = self.weights[:words.shape[1]]
            digests[k] = torch.empty(rows, dtype=torch.int64, device=plane.device)
            if row_max:
                maxima[k] = torch.empty(rows, dtype=torch.float64, device=plane.device)
            for i, n in _chunks(rows, words.shape[1] * 8):
                x = words[i:i + n].to(torch.int64)
                digests[k][i:i + n] = x.mul_(w).sum(1)
                del x  # one chunk's words alive at a time
                if row_max:
                    part = flat[i:i + n]
                    if part.dtype == torch.bool:
                        part = part.view(torch.uint8)
                    maxima[k][i:i + n] = torch.maximum(part.amax(1).double().abs(),
                                                       part.amin(1).double().abs())
        return (digests, maxima) if row_max else digests


def stray_write(ps) -> None:
    """A fault: one bit of the largest ring plane flipped, at the row where
    ``buffer_index`` points (after a block, the first row past its insert)."""
    plane = max(ps.ring.values(), key=lambda v: v[0].numel() * v.element_size())
    plane[int(ps.buffer_index)].reshape(-1).view(torch.uint8)[:1].bitwise_xor_(1)


def replay_readings(pipe, ps, first_gens) -> Dict[str, float]:
    """The timed path against the eager one, once the window has closed.
    From one snapshot of what a train block may change and of the
    generators, one train block runs eagerly (``block_device``, the code the
    graph captured) and then as the window runs it (``_next_block``: on the
    card a replay of the captured graph). A block changes the state outside
    the ring, which is snapshotted whole, and the ring's ``batch_size_run``
    rows from ``buffer_index`` (contiguous: the ring is a multiple of
    ``batch_size_run``), which are snapshotted; every other row is held by
    its digest (``RingDigest``). ``program`` is the largest ``scaled_gap``
    between the two runs over the block's packed stats, the state outside
    the ring and the written rows (each ring plane scaled by its largest
    |value| over the whole plane, as a comparison of whole planes would
    be), and ``inf`` where a row outside the insert's slots changed in
    either run. ``frozen_draw`` reads a fault the same way: the replay made
    with the generators as the first train block found them, so that it
    redraws that block's numbers, as a graph whose generators were left
    unregistered would; ``stray_write`` a replay followed by one bit flipped
    outside the insert's slots (``inf`` where the digests see it). Both
    faults are read in every run, for ``calibrate.py``."""
    B = pipe.batch_size_run
    start, size = int(ps.buffer_index), next(iter(ps.ring.values())).shape[0]
    if pipe.n_data != 1 or start % B or size % B or size < 2 * B:
        raise RuntimeError(f"the replay check reads one process's ring of whole blocks: "
                           f"n_data {pipe.n_data}, buffer_index {start}, B {B}, ring {size}")
    small = outside_ring(ps)
    written = {k: v.narrow(0, start, B) for k, v in ps.ring.items()}
    digest = RingDigest(ps.ring)
    snap = {k: v.clone() for k, v in small.items()}
    snap_rows = {k: v.clone() for k, v in written.items()}
    snap_digest, row_max = digest(ps.ring, row_max=True)
    kept = torch.ones(size, dtype=torch.bool, device=snap_digest[next(iter(ps.ring))].device)
    kept[start:start + B] = False
    # the largest |value| of each plane's rows that a block leaves alone
    floor = {k: float(m[kept].max()) for k, m in row_max.items()}
    del row_max
    now = {k: g.get_state() for k, g in ps.generators.items()}

    def strayed() -> bool:
        return any(not torch.equal(d[kept], snap_digest[k][kept])
                   for k, d in digest(ps.ring).items())

    def block(run, gens):
        for k, v in small.items():
            v.copy_(snap[k])
        for k, v in written.items():
            v.copy_(snap_rows[k])
        for k, g in ps.generators.items():
            g.set_state(gens[k])
        out = run(ps, True).clone()
        return out, strayed()

    eager_out, eager_strayed = block(pipe.block_device, now)
    eager = {k: v.clone() for k, v in small.items()}
    eager_rows = {k: v.clone() for k, v in written.items()}

    def gap(result) -> float:
        out, moved = result
        if moved or eager_strayed:
            return math.inf
        return max([scaled_gap(out, eager_out)]
                   + [scaled_gap(small[k], eager[k]) for k in small]
                   + [scaled_gap(written[k], eager_rows[k], floor[k]) for k in written])

    def replay_then_stray(ps_, train):
        out = pipe._next_block(ps_, train)
        stray_write(ps_)
        return out

    return {"program": gap(block(pipe._next_block, now)),
            "frozen_draw": gap(block(pipe._next_block, first_gens)),
            "stray_write": gap(block(replay_then_stray, now))}


# ------------------------------------------------------------------ a run
def drive(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
          device: str = "cuda", spec=None):
    """One run of ``workload`` with its window timed, then traced (with
    ``trace``) and held to the eager path (``replay_readings``): (the
    Recorder of set-up's first train block, the context that the metric
    readers and the result read, with the tests' ``test_faults`` and the
    window's first test, ``test``).
    ``device`` "cpu" skips nothing but the card: the tests run the cell
    there at a small size."""
    spec = spec or load_cell(workload)
    config, traffic = spec["config"], spec["traffic"]
    sizes = cell_sizes(config, traffic)
    ref_mod = check.reference(config["reference"])
    from refil_torch import main as pmain

    shutil.rmtree(os.path.join(RUN_DIR, "results"), ignore_errors=True)
    window, holder = Window(seconds), {}
    argv = command_line(config, traffic, seed, device)
    with instrument(ref_mod, sizes, seed, window, holder, traffic["check_envs"]):
        summary = pmain.main(argv)
        window.closed = True
    if window.start is None or window.end is None or window.blocks == 0:
        raise RuntimeError(f"no window: {summary.get('dispatches')}")
    on_card = device == "cuda"
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")
    ctx = {"summary": summary, "sizes": sizes, "dtype": sizes["compute_dtype"],
           "on_card": on_card, "ref_mod": ref_mod, "peak": peak,
           "setup_s": window.start - t_start,
           "setup": _setup_steps(window, summary, t_start),
           "window_seconds": window.end - window.start, "window_blocks": window.blocks,
           "window_ns": (window.start_ns, window.end_ns), "window_failed": window.failed,
           "window_env_steps": _window_env_steps(summary, on_card),
           "window_tests": sum(window.start_ns <= s["start_ns"] and s["end_ns"] <= window.end_ns
                               for s in (summary.get("spans") or {}).get("spans", ())
                               if s["name"] == "test"),
           "trace": None}
    if trace and on_card:
        ctx["trace"] = tracing.trace_blocks(window.pipeline, window.state, TRACE_BLOCKS)
    if on_card:  # the check's device bytes above what the run holds (its blocks' in)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t_check = time.perf_counter()
    ctx["replay"] = replay_readings(window.pipeline, window.state, window.first_gens)
    ctx["replay_seconds"] = time.perf_counter() - t_check
    ctx["check_bytes"] = torch.cuda.max_memory_allocated() - held if on_card else None
    tests = holder["tests"]
    interval, width = holder["cadence"]
    ctx["test_faults"] = check.test_faults(
        tests.seen, check.expected_tests([d["env_steps"] for d in summary["dispatches"]],
                                         interval), width, int(sizes["episode_limit"]))
    ctx["test"] = tests.rollout()
    window.pipeline = window.state = None
    tests.seen = tests.learner = None
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(RUN_DIR, "results"), ignore_errors=True)
    return holder["recorder"], ctx


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", spec=None):
    """One run of ``workload``: (the result line's dict, the context the
    metric readers read)."""
    spec = spec or load_cell(workload)
    rec, ctx = drive(workload, seed, seconds, trace, t_start, device, spec)
    t_check = time.perf_counter()
    limits = spec["limits"]
    try:
        if not rec.complete():
            raise ValueError("the first train block was not recorded whole")
        numbers = check.readings(ctx["ref_mod"], rec, ctx["sizes"], ctx["replay"]["program"],
                                 ctx["test_faults"], ctx["test"])
    except (ValueError, RuntimeError, IndexError, KeyError) as err:
        # what the program produced cannot be held to the reference at all
        print(f"check: {type(err).__name__}: {err}", file=sys.stderr)
        numbers = dict.fromkeys(limits, math.nan)
    ctx["check_seconds"] = time.perf_counter() - t_check + ctx["replay_seconds"]
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"env_steps_per_s": ctx["window_env_steps"] / ctx["window_seconds"],
               "peak_mem_gib": ctx["peak"] / 2 ** 30, "setup_s": ctx["setup_s"]}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    result = {"correct": check.verdict(numbers, limits), "attempted": ctx["window_blocks"],
              "failed": ctx["window_failed"], "metrics": metrics,
              "device": _device(ctx["peak"], ctx["trace"]) if ctx["on_card"]
              else {"platform": "cpu"}}
    if ctx["trace"] is not None:
        result["breakdown"] = tracing.breakdown(ctx["trace"])
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers.get(k, math.nan))
                            else None, "limit": limits[k]} for k in limits}
    return result, ctx


def _setup_steps(window: Window, summary, t_start: float) -> Dict[str, float]:
    """Set-up's steps in host seconds: up to the program's build (imports,
    the card, the configuration), the build (env, learner, kernel
    libraries), the warm-up dispatch with the loop's test rollout, and the
    first train dispatch up to the window (its eager block and the
    capture); and, within those, the captures, set-up's test rollouts and
    the eager first blocks."""
    m, graphs = window.marks, summary.get("graphs", {})
    tests = [s for s in (summary.get("spans") or {}).get("spans", ())
             if s["name"] == "test" and s["end_ns"] <= window.start_ns]
    return {"to_build": m["build"] - t_start, "build": m["built"] - m["build"],
            "warm_and_test": m["train"] - m["built"], "first_train": window.start - m["train"],
            "captures": sum(g["capture_seconds"] + g["instantiate_seconds"]
                            for g in graphs.values()),
            "test": sum(s["end_ns"] - s["start_ns"] for s in tests) / 1e9,
            "eager_blocks": window.pipeline.eager_seconds}


def _window_env_steps(summary, on_card: bool) -> int:
    """Env steps of the window's train blocks (a test rollout advances no
    env step): on the card every train dispatch's replayed blocks, from
    the train graph's capture on; on the CPU, with no graphs, the train
    dispatches after the first."""
    train = [d for d in summary["dispatches"] if d["train"]]
    if summary["loop"] != "fused" or not train:
        raise RuntimeError("the run made no train dispatch of the fused loop")
    if not on_card:
        return sum(d["env_steps"] for d in train[1:])
    return sum(d["replay_env_steps"] for d in train)


def _device(peak: int, tr) -> Dict[str, Any]:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": int(peak)}
    if tr is not None:
        out["busy_s"] = tracing.busy_seconds(tr)
        out["window_s"] = tr.window_s
    return out
