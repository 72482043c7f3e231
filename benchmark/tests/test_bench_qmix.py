"""The QMIX cell (``qmix_27m.b8``: the flat path on 27m_vs_30m) on the CPU,
cut to narrow widths, short episodes and small batches through the
harness's own path (``harness.run_cell``, the card's look skipped):

* a sound run is ``correct``; the control (the reference in the port's
  place, its products in TF32) and the planted faults fail its limits;
* ``stage_ms.agents`` and ``stage_ms.mixer`` read the flat path's update
  stamps from the run's summary, within ``stage_ms.learn``;
* ``costs_flat``'s GRU calls and model operations against counts by hand."""
import copy
import math
import time

import pytest

from benchmark import check, costs, costs_flat, harness

WORKLOAD = "qmix_27m.b8"
TINY = {"rnn_hidden_dim": 16, "hypernet_embed": 16, "mixing_embed_dim": 8, "batch_size": 4,
        "training_iters": 4, "buffer_size": 32}
EPISODE_LIMIT = 20


def tiny_spec():
    """The cell's spec with its widths, episodes and batches cut down (what
    the command line and the size check both see); the map's sizes stay."""
    spec = copy.deepcopy(harness.load_cell(WORKLOAD))
    cfg, traffic = spec["config"], spec["traffic"]
    cfg["sizes"].update(TINY, episode_limit=EPISODE_LIMIT)
    cfg["overrides"].update(TINY, **{"env_args.episode_limit": EPISODE_LIMIT})
    # 8 envs: the first sample draws 4 of 16 episodes, so that an update
    # that draws the first one's slots again (a sample fault) is a 1-in-600
    # chance, not 1 in 23 as with 4 of 8
    traffic["run"].update(batch_size_run=8, buffer_size=32, max_blocks_per_dispatch=4)
    traffic["check_envs"] = 3
    return spec


@pytest.fixture(scope="module")
def tiny_run():
    return harness.run_cell(WORKLOAD, 5, 0.0, True, time.perf_counter(), device="cpu",
                            spec=tiny_spec())


def test_a_sound_run_is_correct(tiny_run):
    result, _ = tiny_run
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(harness.load_cell(WORKLOAD)["limits"])


def test_the_control_and_the_faults_fail():
    """Every reading that calibration plants fails the cell's limits, but
    ``draw_fault``: QMIX draws no bipartition, so its draw_gap reads 0 as
    the program's does."""
    seed, spec = 11, tiny_spec()
    rec, ctx = harness.drive(WORKLOAD, seed, 0.0, False, time.perf_counter(), device="cpu",
                             spec=spec)
    readings = check.calibration(ctx["ref_mod"], rec, ctx["sizes"], ctx["dtype"],
                                 ctx["replay"], seed, ctx["test_faults"], ctx["test"])
    limits = spec["limits"]
    assert check.verdict(readings["program"], limits), readings["program"]
    assert readings["program"]["draw_gap"] == readings["draw_fault"]["draw_gap"] == 0
    for kind, numbers in readings.items():
        if kind not in ("program", "draw_fault"):
            assert not check.verdict({**readings["program"], **numbers}, limits), (kind, numbers)


@pytest.mark.parametrize("name", ["stage_ms.agents", "stage_ms.mixer"])
def test_stage_readers_read_the_flat_path(tiny_run, name):
    """The flat path's updates carry the stamps too; the two stages lie
    within ``stage_ms.learn`` (the readers' edge cases are
    ``test_bench_stages``'s, on the entity path)."""
    result, ctx = tiny_run
    value = harness.load_reader(name)(ctx)
    assert isinstance(value, float) and math.isfinite(value) and value > 0, value
    assert result["metrics"][name]["value"] == value
    learn = harness.load_reader("stage_ms.learn")(ctx)
    assert sum(harness.load_reader(m)(ctx) for m in ("stage_ms.agents", "stage_ms.mixer")) < learn


HAND = {"batch_size_run": 1, "batch_size": 1, "n_agents": 1, "episode_limit": 1,
        "training_iters": 1, "obs_shape": 1, "n_actions": 1, "rnn_hidden_dim": 1,
        "state_shape": 2, "hypernet_embed": 2, "mixing_embed_dim": 1,
        "compute_dtype": "float32"}


def test_flat_gru_calls_by_hand():
    assert costs_flat.block_calls(HAND) == [
        costs.GruCall("rollout", 1, 1, False, 1), costs.GruCall("agent", 2, 1, False, 1),
        costs.GruCall("agent", 2, 1, True, 1), costs.GruCall("target_agent", 2, 1, False, 1)]
    # the cell: 180 rollout steps at R 8 x 27, then 8 updates at T 181, R 32 x 27
    spec = harness.load_cell(WORKLOAD)
    sizes = harness.cell_sizes(spec["config"], spec["traffic"])
    assert [(c.T, c.R, c.bwd, c.count) for c in costs_flat.block_calls(sizes)] == [
        (1, 216, False, 180), (181, 864, False, 8), (181, 864, True, 8), (181, 864, False, 8)]
    assert costs_flat.launches_per_block(sizes) == {"gru_fwd": 196, "gru_bwd": 8}


def test_flat_model_flops_by_hand():
    # agent over r rows (input 1 + 1 + 1 = 3): fc1 2r*3 = 6r, GRU 2r*2*3 = 12r,
    # fc2 2r -> 20r, first layer 6r; the rollout one step of one row: 20;
    # the live agent over 2 rows forward and backward 3*40 - 12 = 108,
    # the target 40
    # mixer over n rows: first layers 2n*2*(2*2 + 2*1) = 24n, second
    # 2n*(2*1*1 + 2*1 + 1) = 10n, mixing 2n*(1 + 1) = 4n -> 38n; the live
    # mixer on one step 3*38 - 24 = 90, the target on two 76
    assert costs_flat.block_model_flops(HAND) == 20 + 108 + 40 + 90 + 76
