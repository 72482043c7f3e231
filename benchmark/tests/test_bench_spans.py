"""The span metrics (``benchmark/metrics/``: stage_ms.rollout, stage_ms.learn,
block_ms.train_p90, idle_between_blocks, launch_ms, build_s) on the tiny
cell on the CPU, where the blocks run eagerly and nothing is replayed: each
reads a finite number, or None where its docstring says so (launch_ms, with
no replay); the two stages of a block fit within the window's mean block
interval, and the tail is at least the median interval. A program that
records no spans (the summary of a parent without them) reads None in
every one of them."""
import math
import statistics
import time

import pytest

from benchmark import harness, spans
from benchmark.tests.tiny import tiny_spec

METRICS = ["stage_ms.rollout", "stage_ms.learn", "block_ms.train_p90", "idle_between_blocks",
           "launch_ms", "build_s"]
NONE_ON_THE_CPU = {"launch_ms"}


@pytest.fixture(scope="module")
def tiny_run():
    """The tiny b8 cell through the harness on the CPU, in dispatches of 4
    blocks, so that its window holds 4 train blocks."""
    spec = tiny_spec("refil_sz.b8")
    spec["traffic"]["run"]["max_blocks_per_dispatch"] = 4
    result, ctx = harness.run_cell("refil_sz.b8", 3, 0.0, True, time.perf_counter(),
                                   device="cpu", spec=spec)
    return result, ctx


@pytest.mark.parametrize("name", METRICS)
def test_reader_reads_a_number_or_none(tiny_run, name):
    result, ctx = tiny_run
    value = harness.load_reader(name)(ctx)
    if name in NONE_ON_THE_CPU:
        assert value is None and name not in result["metrics"]
    else:
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, value
        assert result["metrics"][name]["value"] == value
    without = dict(ctx, summary={k: v for k, v in ctx["summary"].items() if k != "spans"})
    assert harness.load_reader(name)(without) is None


def test_stages_fit_in_the_block_interval(tiny_run):
    result, ctx = tiny_run
    blocks = spans.stamped_blocks(ctx)
    assert len(blocks) == ctx["window_blocks"] == 4
    value = {m: harness.load_reader(m)(ctx) for m in METRICS}
    mean_interval_ms = (blocks[-1]["end_ns"] - blocks[0]["start_ns"]) / len(blocks) / 1e6
    assert 0 < value["stage_ms.rollout"] + value["stage_ms.learn"] <= mean_interval_ms
    intervals = spans.end_intervals_ns(blocks)
    assert value["block_ms.train_p90"] >= statistics.median(intervals) / 1e6
    assert 0 <= value["idle_between_blocks"] < 100
    assert 0 < value["build_s"] < ctx["setup_s"]


def _ctx(blocks, tests):
    """A summary with ``blocks`` ((start, end) ns of train replays) and
    ``tests`` ((start, end) ns of test spans)."""
    return {"summary": {"spans": {
        "blocks": [{"kind": "train", "replay": True, "dispatch": i, "start_ns": s, "end_ns": e}
                   for i, (s, e) in enumerate(blocks)],
        "spans": [{"name": "test", "start_ns": s, "end_ns": e} for s, e in tests]}}}


def test_gaps_that_hold_a_test_are_the_tests():
    """idle_between_blocks and block_ms.train_p90 leave out the gaps between
    blocks in which a test rollout ran; with no test they read as before."""
    ms = 1_000_000
    blocks = [(0, 100 * ms), (101 * ms, 200 * ms), (700 * ms, 800 * ms), (802 * ms, 900 * ms)]
    idle, p90 = (harness.load_reader(m) for m in ("idle_between_blocks", "block_ms.train_p90"))
    plain = _ctx(blocks, [])
    assert idle(plain) == pytest.approx(100.0 * (1 + 500 + 2) / 900)
    assert p90(plain) == pytest.approx(
        statistics.quantiles([100.0, 600.0, 100.0], n=10)[-1])
    tested = _ctx(blocks, [(250 * ms, 650 * ms)])
    assert idle(tested) == pytest.approx(100.0 * (1 + 2) / (900 - 500))
    assert p90(tested) == pytest.approx(100.0)
    assert idle(_ctx(blocks[1:3], [(250 * ms, 650 * ms)])) is None
