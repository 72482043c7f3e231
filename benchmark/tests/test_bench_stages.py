"""The learner's two stage metrics (``stage_ms.agents``, ``stage_ms.mixer``)
on the tiny cell on the CPU: each reads the updates' ``agents.<i>`` or
``mix.<i>`` stamps from the run's summary, the two together within
``stage_ms.learn``; each reads None where the program stamps no such stage
(a parent without them) or records no spans."""
import math
import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_spec

PREFIXES = {"stage_ms.agents": "agents.", "stage_ms.mixer": "mix."}


@pytest.fixture(scope="module")
def tiny_run():
    return harness.run_cell("refil_sz.b8", 5, 0.0, True, time.perf_counter(), device="cpu",
                            spec=tiny_spec("refil_sz.b8"))


@pytest.mark.parametrize("name", sorted(PREFIXES))
def test_stage_readers_read_the_update_stamps(tiny_run, name):
    result, ctx = tiny_run
    value = harness.load_reader(name)(ctx)
    assert isinstance(value, float) and math.isfinite(value) and value > 0, value
    assert result["metrics"][name]["value"] == value
    learn = harness.load_reader("stage_ms.learn")(ctx)
    assert sum(harness.load_reader(m)(ctx) for m in PREFIXES) < learn
    prefix = PREFIXES[name]
    blocks = [dict(b, stages={k: v for k, v in b["stages"].items() if not k.startswith(prefix)})
              for b in ctx["summary"]["spans"]["blocks"]]
    parent = dict(ctx, summary=dict(ctx["summary"], spans=dict(ctx["summary"]["spans"],
                                                              blocks=blocks)))
    assert harness.load_reader(name)(parent) is None
    without = dict(ctx, summary={k: v for k, v in ctx["summary"].items() if k != "spans"})
    assert harness.load_reader(name)(without) is None
