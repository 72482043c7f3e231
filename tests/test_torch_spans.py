"""refil_torch's spans and block stamps (``utils/profiling.py``,
``core/pipeline.py``, ``ops/stamp.py``) on the CPU, where a block runs
eagerly and each stamp is the host clock:

* a fused run's summary holds one record per block, each block's stamps in
  order and its stages summing to its span, and set-up's and the loop's
  spans nested as the loop runs them; its ``spans`` is a snapshot, which
  blocks run after the loop returned leave alone;
* the stamps change no number: with ``trace_blocks`` on and off a seeded
  run's packed stats and every state tensor are bit-equal, a fused
  checkpoint holds the same keys, and off calls the stamp op nowhere;
* each learner update stamps its agents' forward, its mixers and loss, and
  its end, in that order, on the entity and the flat paths;
* the per-block store stays at its cap; the idle between blocks goes to the
  innermost span open at its midpoint; the clock offset's bounds.
"""
import numpy as np
import pytest
import torch

from benchmark.harness import state_tensors
from refil_torch import config as tconfig
from refil_torch import main as tmain
from refil_torch import run as trun
from refil_torch.core.pipeline import FusedPipeline
from refil_torch.ops import stamp as stamp_op
from refil_torch.utils import profiling

GM = ["--config=refil_group_matching", "--env-config=group_matching", "with", "t_max=600",
      "seed=5", "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size_run=4",
      "batch_size=8", "buffer_size=16", "test_nepisode=8", "test_interval=400",
      "attn_embed_dim=16", "hypernet_embed=16", "mixing_embed_dim=8", "training_iters=2",
      "max_blocks_per_dispatch=4", "use_cuda=False"]
TRAIN_STAMPS = ("start", "rollout", "insert", "sample", "agents.0", "mix.0", "update.0",
                "agents.1", "mix.1", "update.1", "diag", "sync", "pack")
# the benchmark's combat model, cut to the CPU: the block without gt diagnostics
COMBAT = dict(alg="refil", env="sc2custom", overrides=[
    "scenario=3-8sz_symmetric", "env_args.episode_limit=12", "attn_embed_dim=16",
    "hypernet_embed=16", "mixing_embed_dim=8", "rnn_hidden_dim=16", "batch_size_run=4",
    "batch_size=4", "buffer_size=8", "training_iters=2"])
GROUP_MATCHING = dict(alg="refil_group_matching", env="group_matching", overrides=[
    "env_args.n_agents=3", "env_args.n_states=4", "env_args.episode_limit=5",
    "attn_embed_dim=8", "attn_n_heads=2", "hypernet_embed=8", "mixing_embed_dim=8",
    "batch_size_run=4", "batch_size=4", "buffer_size=16", "training_iters=2"])
# the flat path (qmix on sc2: BasicMAC, RNNAgent, QMixer), cut to the CPU
FLAT = dict(alg="qmix", env="sc2", overrides=[
    "env_args.map_name=3m", "env_args.episode_limit=12", "rnn_hidden_dim=16",
    "hypernet_embed=16", "mixing_embed_dim=8", "batch_size_run=4", "batch_size=4",
    "buffer_size=8", "training_iters=3"])


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    """A fused GM run on the CPU (2 warm-up blocks, then train dispatches of
    up to 4 blocks, tests and logging between them), with its pipeline and
    state kept."""
    kept = {}

    class Keep(FusedPipeline):
        def init_state(self, *args, **kwargs):
            kept["pipeline"], kept["state"] = self, super().init_state(*args, **kwargs)
            return kept["state"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trun, "FusedPipeline", Keep)
        summary = tmain.main(GM + [f"local_results_path={tmp_path_factory.mktemp('spans')}"])
    return summary, kept["pipeline"], kept["state"]


def _pipeline(spec, trace_blocks=True, timer=None, seed=0):
    cfg = tconfig.load_config(alg=spec["alg"], env=spec["env"], overrides=spec["overrides"] + [
        f"seed={seed}", "use_cuda=False", f"trace_blocks={trace_blocks}"])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, learner, gens = trun.build_training(args, None, torch.device("cpu"))
    pipe = FusedPipeline(runner, learner, args.buffer_size, args, timer=timer)
    return pipe, pipe.init_state(gens["sample"])


def _run(pipe, ps, train_blocks=3):
    """The warm-up blocks, then train blocks in dispatches of 2 and 1."""
    stats = [pipe.run_blocks(ps, pipe.warmup_blocks(), train=False)]
    for n in (2, train_blocks - 2):
        stats.append(pipe.run_blocks(ps, n, train=True))
    return stats


def test_one_record_per_block(fused_run):
    summary, _, _ = fused_run
    blocks = summary["spans"]["blocks"]
    assert len(blocks) == summary["blocks"] > 4
    assert [b["dispatch"] for b in blocks] == [
        i for i, d in enumerate(summary["dispatches"]) for _ in range(d["blocks"])]
    assert [b["kind"] for b in blocks] == [
        "train" if d["train"] else "warm"
        for d in summary["dispatches"] for _ in range(d["blocks"])]
    assert not any(b["replay"] or b["launch_ns"] for b in blocks)  # the CPU replays nothing
    totals = summary["spans"]["block_totals"]
    assert totals["train"]["blocks"] == summary["updates"]
    assert totals["warm"]["blocks"] == summary["blocks"] - summary["updates"]


def test_stamps_are_ordered_and_stages_sum_to_the_block(fused_run):
    summary, _, _ = fused_run
    spans = summary["spans"]
    for b in spans["blocks"]:
        stages = list(b["stages"].values())
        assert all(ns >= 0 for ns in stages), b
        assert sum(stages) == b["end_ns"] - b["start_ns"] > 0
        want = TRAIN_STAMPS[1:] if b["kind"] == "train" else ("rollout", "insert", "pack")
        assert tuple(b["stages"]) == want
    ends = [b["end_ns"] for b in spans["blocks"]]
    starts = [b["start_ns"] for b in spans["blocks"]]
    assert all(s >= e for e, s in zip(ends, starts[1:]))  # one block after another
    # the stamps and the spans share a clock: each block inside its dispatch's span
    dispatches = [s for s in spans["spans"] if s["name"] == "dispatch"]
    assert len(dispatches) == len(summary["dispatches"])
    unc = spans["clock"]["uncertainty_ns"]
    assert 0 <= unc < 10 ** 8
    for b in spans["blocks"]:
        d = dispatches[b["dispatch"]]
        assert d["start_ns"] - unc <= b["start_ns"] and b["end_ns"] <= d["end_ns"] + unc
    # set-up's steps, then the loop's, children inside their parents
    names = [s["name"] for s in spans["spans"]]
    assert names[:6] == ["build.env", "build.controller", "build.runner", "build.learner",
                         "setup.ring", "setup.clock"]
    assert spans["totals"]["clock"]["count"] == len(summary["dispatches"])
    assert spans["clock"]["anchors"] == 8 + len(summary["dispatches"])
    by_id = {s["id"]: s for s in spans["spans"]}
    for s in spans["spans"]:
        if s["name"] in ("blocks", "clock", "account"):
            assert by_id[s["parent"]]["name"] == "dispatch"
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    assert {"test", "log"} <= set(names) and sum(spans["idle_by_span"].values()) > 0
    assert len(summary["tests"]) == spans["totals"]["test"]["count"]


def test_snapshot_leaves_out_blocks_run_after_the_loop(fused_run):
    summary, pipe, ps = fused_run
    before = len(summary["spans"]["blocks"])
    pipe.run_blocks(ps, 2, train=True)
    assert len(pipe.timer.blocks) == before + 2
    assert len(summary["spans"]["blocks"]) == before
    assert pipe.timer.snapshot()["blocks"][-1]["dispatch"] == len(summary["dispatches"])


@pytest.mark.parametrize("spec", [GROUP_MATCHING, COMBAT, FLAT],
                         ids=["group_matching", "combat", "flat"])
def test_stamps_change_no_number(spec):
    on, ps_on = _pipeline(spec, trace_blocks=True)
    off, ps_off = _pipeline(spec, trace_blocks=False)
    for a, b in zip(_run(on, ps_on), _run(off, ps_off)):
        flat_a, flat_b = _flatten(a), _flatten(b)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    state_on, state_off = state_tensors(ps_on), state_tensors(ps_off)
    assert state_on.keys() == state_off.keys()
    for k in state_on:
        assert torch.equal(state_on[k], state_off[k]), k
    assert all(b.stamps is not None for b in on.timer.blocks)
    assert all(b.stamps is None for b in off.timer.blocks)


@pytest.mark.parametrize("spec", [GROUP_MATCHING, COMBAT, FLAT],
                         ids=["group_matching", "combat", "flat"])
def test_each_update_stamps_its_agents_then_its_mixers(spec):
    """A train block's updates each stamp ``agents.<i>``, ``mix.<i>`` and
    ``update.<i>`` in that order, one update after the other, between the
    sample and the target sync; each of those stages takes time."""
    pipe, ps = _pipeline(spec)
    _run(pipe, ps)
    iters = pipe.training_iters
    updates = tuple(f"{stage}.{i}" for i in range(iters) for stage in ("agents", "mix", "update"))
    train = [b for b in pipe.timer.snapshot()["blocks"] if b["kind"] == "train"]
    assert len(train) == 3
    for b in train:
        names = tuple(b["stages"])
        at = names.index("sample") + 1
        assert names[at:at + 3 * iters] == updates, names
        assert all(b["stages"][k] > 0 for k in updates), b["stages"]


@pytest.mark.parametrize("include_buffer", [False, True])
def test_checkpoint_keys_do_not_depend_on_stamps(tmp_path, include_buffer):
    keys = []
    for trace_blocks in (True, False):
        pipe, ps = _pipeline(GROUP_MATCHING, trace_blocks=trace_blocks)
        _run(pipe, ps)
        path = str(tmp_path / str(trace_blocks))
        trun._save_checkpoint(path, pipe.learner, pstate=ps, include_buffer=include_buffer)
        blob = torch.load(f"{path}/{trun.STATE_FILE}", map_location="cpu", weights_only=True)
        keys.append(sorted(_flatten(blob)))
    assert keys[0] == keys[1]


def test_stamps_off_calls_the_stamp_op_nowhere(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("stamp called with trace_blocks off")

    monkeypatch.setattr(stamp_op, "stamp", refuse)
    pipe, ps = _pipeline(GROUP_MATCHING, trace_blocks=False)
    _run(pipe, ps)
    assert pipe._stamps is None and len(pipe.timer.blocks) == pipe.warmup_blocks() + 3
    snap = pipe.timer.snapshot()
    assert snap["clock"]["offset_ns"] is None and snap["idle_by_span"] == {}


def test_block_store_stays_at_its_cap():
    timer = profiling.PhaseTimer(block_cap=3, span_cap=5)
    pipe, ps = _pipeline(GROUP_MATCHING, timer=timer)
    _run(pipe, ps, train_blocks=4)
    for _ in range(8):
        with timer.span("account"):
            pass
    ran = pipe.warmup_blocks() + 4
    snap = timer.snapshot()
    assert len(timer.blocks) == len(snap["blocks"]) == 3
    assert [s["name"] for s in snap["spans"]] == ["account"] * 5
    assert snap["totals"]["account"]["count"] == 8
    assert sum(t["blocks"] for t in snap["block_totals"].values()) == ran
    assert [b["dispatch"] for b in snap["blocks"]] == [1, 2, 2]  # the last three kept
    assert snap["block_totals"]["train"]["blocks"] == 4


def test_idle_goes_to_the_innermost_open_span():
    timer = profiling.PhaseTimer()
    names = ("start", "rollout", "sync")
    for dispatch, stamps in enumerate(((100, 150, 200), (260, 300, 400), (400, 450, 500),
                                       (530, 560, 600))):
        timer.record_block(profiling.BlockRecord(dispatch, "train", True, 5, stamps, names))
    timer.anchor(0, 0, 3)
    for sid, (name, parent, start, end) in enumerate((
            ("dispatch", None, 190, 420), ("launch", 0, 220, 240), ("sync", 0, 300, 410),
            ("account", None, 505, 700))):
        timer.spans.append(profiling.Span(sid, name, parent, start, end))
    snap = timer.snapshot()
    # gaps 200-260 (mid 230: launch), none at 400, 500-530 (mid 515: account)
    assert snap["idle_by_span"] == {"launch": 60e-9, "account": 30e-9}
    assert snap["clock"] == {"offset_ns": 0, "uncertainty_ns": 3, "drift_ppm": None,
                             "anchors": 1}
    assert [b["stages"] for b in snap["blocks"]][0] == {"rollout": 50, "sync": 50}


def test_the_clock_follows_its_anchors_and_phases_feed_the_emas():
    timer = profiling.PhaseTimer()
    assert timer.offset()["offset_ns"] is None and timer.to_host(5) is None
    # offsets 100 at device 1000 and 110 at 2000 (10 ppm... of 1000 ns)
    for device, host, unc in ((1000, 1100, 40), (1000, 1100, 20), (2000, 2110, 5)):
        timer.anchor(device, host, unc)
    assert [timer.to_host(t) for t in (0, 1000, 1500, 2000, 9000)] == [100, 1100, 1605, 2110, 9110]
    assert timer.offset() == {"offset_ns": 110, "uncertainty_ns": 20, "drift_ppm": 1e4,
                              "anchors": 3}
    with profiling.recording(timer):
        with timer.phase("rollout"):
            with profiling.span("inner"):
                pass
    with profiling.span("nowhere"):  # no recorder installed: nothing recorded
        pass
    inner, outer = list(timer.spans)
    assert (inner.name, inner.parent, outer.name) == ("inner", outer.id, "rollout")
    assert timer.stats()["time_rollout_ms"] == pytest.approx(outer.seconds * 1e3)
    assert set(timer.totals) == {"inner", "rollout"}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}
