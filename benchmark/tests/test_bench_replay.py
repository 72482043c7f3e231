"""The replay check (``harness.replay_readings``) and a window that holds test
rollouts, on the CPU at a small size.

The check holds a block's writes, not copies of the training state: its
live bytes, counted op by op, stay within two copies of the state outside
the ring, three of the rows one insert writes and the digests and chunk
scratch, less than one ring plane. A replay that writes one bit of the ring
outside the insert's slots reads ``inf``, and fails ``correct`` by
``replay_gap`` alone. At the test cadence (``refil_sz_bf16.b512_test``, cut
down) the window counts the train blocks' env steps alone, its test
rollouts are read from the program's ``test`` spans (``test_share``), and
the run is ``correct``."""
import math
import time
import weakref

import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness
from benchmark.tests.tiny import tiny_spec


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops make while the mode is on and not
    ``paused``, alive at once: ``now`` and the most, ``peak``. A storage is
    alive while a tensor on it that an op returned is."""

    def __init__(self):
        super().__init__()
        self.refs = {}  # storage address: [bytes, tensors alive on it]
        self.now = self.peak = 0
        self.paused = False

    def _drop(self, key):
        entry = self.refs[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        inputs = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage().data_ptr()
            if key in self.refs:
                self.refs[key][1] += 1
            elif key in inputs or key == 0:
                continue  # a view of, or the result in place of, what existed before
            else:
                self.refs[key] = [t.untyped_storage().nbytes(), 1]
                self.now += self.refs[key][0]
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._drop, key)
        return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def test_the_check_holds_a_blocks_writes(monkeypatch):
    """On the tiny cell with a ring of 64 blocks, the check's live bytes
    (the blocks it runs left out: their working memory is the program's)
    within 2 x the state outside the ring + 3 x one insert's rows + the
    digests and the chunk scratch; that bound is under one ring plane."""
    from refil_torch.core.pipeline import FusedPipeline

    spec = tiny_spec("refil_sz.b8")
    B = spec["traffic"]["run"]["batch_size_run"]
    spec["traffic"]["run"]["buffer_size"] = 64 * B
    monkeypatch.setattr(harness, "CHUNK_BYTES", 4096)
    mode, seen = LiveBytes(), {}

    def paused(run):
        def inner(self, *args, **kwargs):
            was, mode.paused = mode.paused, True
            try:
                return run(self, *args, **kwargs)
            finally:
                mode.paused = was
        return inner

    replay_readings = harness.replay_readings

    def counted(pipe, ps, first_gens):
        ring = list(ps.ring.values())
        size, planes = ring[0].shape[0], len(ring)
        row_bytes = [v[0].numel() * v.element_size() for v in ring]
        seen.update(size=size, outside=_nbytes(harness.outside_ring(ps).values()),
                    rows=B * sum(row_bytes), plane=max(row_bytes) * size, planes=planes,
                    words=max(row_bytes))
        with mode:
            out = replay_readings(pipe, ps, first_gens)
        seen["readings"] = out
        return out

    monkeypatch.setattr(FusedPipeline, "block_device", paused(FusedPipeline.block_device))
    monkeypatch.setattr(FusedPipeline, "_next_block", paused(FusedPipeline._next_block))
    monkeypatch.setattr(harness, "replay_readings", counted)
    harness.drive("refil_sz.b8", 5, 0.0, False, time.perf_counter(), device="cpu", spec=spec)

    assert seen["size"] == 64 * B
    assert seen["readings"]["program"] == 0.0, seen["readings"]
    # digests (int64), row maxima (float64), the digest of the moment, the
    # mask of rows left alone; one chunk (or one row as int64 words) and the
    # weights (a row's words at most, as int64)
    digests = 3 * 8 * seen["size"] * seen["planes"] + seen["size"]
    scratch = 2 * max(harness.CHUNK_BYTES, 8 * seen["words"]) + 8 * seen["words"]
    bound = 2 * seen["outside"] + 3 * seen["rows"] + digests + scratch
    assert bound < seen["plane"], (bound, seen)
    assert 0 < mode.peak <= bound, (mode.peak, bound, seen)


def test_a_stray_write_fails_replay_gap_alone(monkeypatch):
    """The timed path writes one bit outside the insert's slots after each
    block: replay_gap reads inf and fails; every other number passes."""
    from refil_torch.core.pipeline import FusedPipeline

    next_block = FusedPipeline._next_block

    def stray(self, ps, train):
        out = next_block(self, ps, train)
        if train:
            harness.stray_write(ps)
        return out

    monkeypatch.setattr(FusedPipeline, "_next_block", stray)
    spec = tiny_spec("refil_sz.b8")
    result, ctx = harness.run_cell("refil_sz.b8", 11, 0.0, False, time.perf_counter(),
                                   device="cpu", spec=spec)
    assert ctx["replay"]["program"] == math.inf
    assert not result["correct"]
    failing = [k for k, c in result["checks"].items()
               if c["value"] is None or c["value"] > c["limit"]]
    assert failing == ["replay_gap"], result["checks"]


@pytest.fixture(scope="module")
def cadence_run():
    """The test-cadence cell cut down: a test rollout of 4 episodes after
    every dispatch of one block, the window after the first train dispatch."""
    spec = tiny_spec("refil_sz_bf16.b512_test")
    assert spec["traffic"]["run"]["test_interval"] == 1
    assert spec["traffic"]["run"]["test_nepisode"] == 4
    return harness.run_cell("refil_sz_bf16.b512_test", 13, 0.0, True, time.perf_counter(),
                            device="cpu", spec=spec)


def test_the_window_counts_train_steps_and_holds_tests(cadence_run):
    result, ctx = cadence_run
    assert result["correct"], result["checks"]
    summary = ctx["summary"]
    train = [d for d in summary["dispatches"] if d["train"]]
    assert ctx["window_env_steps"] == sum(d["env_steps"] for d in train[1:]) > 0
    start, end = ctx["window_ns"]
    tests = [s for s in summary["spans"]["spans"] if s["name"] == "test"]
    inside = [s for s in tests if start <= s["start_ns"] and s["end_ns"] <= end]
    assert inside and len(tests) > len(inside)  # set-up's tests fall before the window
    assert all(t["episodes"] == 4 for t in summary["tests"])


def test_test_share_reads_the_test_spans(cadence_run):
    result, ctx = cadence_run
    start, end = ctx["window_ns"]
    inside = sum(max(0, min(s["end_ns"], end) - max(s["start_ns"], start))
                 for s in ctx["summary"]["spans"]["spans"] if s["name"] == "test")
    value = harness.load_reader("test_share")(ctx)
    assert value == result["metrics"]["test_share"]["value"]
    assert 0 < value < 100
    assert value == pytest.approx(100.0 * inside / (end - start))
    without = dict(ctx, summary={k: v for k, v in ctx["summary"].items() if k != "spans"})
    assert harness.load_reader("test_share")(without) is None
