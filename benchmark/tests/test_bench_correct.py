"""``correct`` on the CPU at a small size: a sound run of the port passes its
cell's limits; the control (the reference in the port's place, its products
one precision below the configuration's) and runs with the timed path broken
underneath fail them: a step that leaves the state unchanged, half of each
batch left out, an answer altered where it is produced, blocks that redraw
the first block's numbers (as unregistered graph generators would), a
sample that repeats a slot, an insert that never reaches the ring,
bipartitions not drawn from their probabilities; and, at the test cadence,
a test over half the episodes, a test stopped before its episodes end and
a test that acts off its greedy choice. The harness's look for a
card is skipped (the CPU path of ``harness.run_cell``); the rest of a run
is driven as on the card."""
import time

import pytest
import torch

from benchmark import check, harness
from benchmark.tests.tiny import tiny_spec

WORKLOADS = ["refil_sz.b8", "refil_sz_bf16.b4096", "refil_sz_bf16.b512_test"]


def _run(workload, seed=11):
    return harness.run_cell(workload, seed, 0.0, False, time.perf_counter(), device="cpu",
                            spec=tiny_spec(workload))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_port_passes_and_the_control_fails(workload):
    """The reference against the port's learner update and rollout at a
    small size; the control and the faults that calibration reads held to
    the same limits."""
    seed, spec = 11, tiny_spec(workload)
    rec, ctx = harness.drive(workload, seed, 0.0, False, time.perf_counter(), device="cpu",
                             spec=spec)
    readings = check.calibration(ctx["ref_mod"], rec, ctx["sizes"], ctx["dtype"],
                                 ctx["replay"], seed, ctx["test_faults"], ctx["test"])
    limits = spec["limits"]
    assert check.verdict(readings["program"], limits), readings["program"]
    for kind, numbers in readings.items():
        if kind != "program":
            assert not check.verdict({**readings["program"], **numbers}, limits), (kind, numbers)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    result, _ = _run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    limits = harness.load_cell(workload)["limits"]
    assert set(result["checks"]) == set(limits) <= set(check.NUMBERS)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.RMSprop, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from refil_torch.learners.q_learner import QLearner

    td_mask = QLearner.td_mask

    def half(filled, terminated):
        mask = td_mask(filled, terminated)
        mask[mask.shape[0] // 2:] = 0.0  # the second half left out of the mean
        return mask

    monkeypatch.setattr(QLearner, "td_mask", staticmethod(half))


def _answer_altered(monkeypatch):
    from refil_torch.controllers.mac import EntityMAC

    forward_step = EntityMAC.forward_step

    def altered(self, *args):
        q, h = forward_step(self, *args)
        bump = torch.zeros_like(q)
        bump[:, 0, 0] = 1.0  # each env's first agent's first action
        return q + bump, h

    monkeypatch.setattr(EntityMAC, "forward_step", altered)


def _frozen_draw(monkeypatch):
    """The timed path's blocks redraw the first one's numbers, as graph
    replays do whose generators were left unregistered."""
    from refil_torch.core.pipeline import FusedPipeline

    next_block, frozen = FusedPipeline._next_block, {}

    def replay(self, ps, train):
        if train and not frozen:
            frozen.update({k: g.get_state() for k, g in ps.generators.items()})
        elif train:
            for k, g in ps.generators.items():
                g.set_state(frozen[k])
        return next_block(self, ps, train)

    monkeypatch.setattr(FusedPipeline, "_next_block", replay)


def _slots_repeated(monkeypatch):
    from refil_torch.core.pipeline import FusedPipeline

    sample_idx = FusedPipeline.sample_idx

    def repeated(self, *args):
        idx = sample_idx(self, *args)
        idx[:, 1] = idx[:, 0]
        return idx

    monkeypatch.setattr(FusedPipeline, "sample_idx", repeated)


def _insert_lost(monkeypatch):
    """The block's episodes never reach the ring: its slots read zeros."""
    from refil_torch.core.pipeline import FusedPipeline

    train_half = FusedPipeline.train_half

    def lost(self, ps, draws=None):
        slots = (ps.buffer_index.long() - self.batch_size_run) % self.buffer_size
        for buf in ps.ring.values():
            buf[slots + self._block_slots] = 0
        return train_half(self, ps, draws)

    monkeypatch.setattr(FusedPipeline, "train_half", lost)


def _groups_unrelated(monkeypatch):
    """groupA drawn at p 0.5, not from the group_probs drawn beside it."""
    from refil_torch.ops import masks

    draw = masks.draw_imagine_groups

    def unrelated(batch_size, n_entities, generator, device):
        probs, _ = draw(batch_size, n_entities, generator, device)
        u = torch.rand((batch_size, 1, n_entities), generator=generator, device=device)
        return probs, u < 0.5

    monkeypatch.setattr(masks, "draw_imagine_groups", unrelated)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered, _frozen_draw,
                                   _slots_repeated, _insert_lost, _groups_unrelated],
                         ids=["state_unchanged", "half_batch", "answer_altered", "frozen_draw",
                              "slots_repeated", "insert_lost", "groups_unrelated"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, _ = _run("refil_sz.b8")
    assert not result["correct"], result["checks"]


def _test_half_episodes(monkeypatch):
    """Each test rolls out half the episodes it should."""
    from refil_torch.runners.vector_runner import VectorRunner

    run = VectorRunner.run

    def half(self, *args, **kwargs):
        if kwargs.get("test_mode") and kwargs.get("batch_size"):
            kwargs["batch_size"] //= 2
        return run(self, *args, **kwargs)

    monkeypatch.setattr(VectorRunner, "run", half)


def _test_stopped_early(monkeypatch):
    """Each test stops at half the episode limit."""
    from refil_torch.runners.vector_runner import VectorRunner

    run = VectorRunner.run

    def early(self, *args, **kwargs):
        if not kwargs.get("test_mode"):
            return run(self, *args, **kwargs)
        limit, self.episode_limit = self.episode_limit, self.episode_limit // 2
        try:
            return run(self, *args, **kwargs)
        finally:
            self.episode_limit = limit

    monkeypatch.setattr(VectorRunner, "run", early)


def _test_not_greedy(monkeypatch):
    """The test picks the available action its Q puts last."""
    from refil_torch.runners.vector_runner import VectorRunner

    select = VectorRunner.select

    def worst(self, q, avail, epsilon, test, generator, shard=None):
        if not test:
            return select(self, q, avail, epsilon, test, generator, shard)
        return q.masked_fill(~avail, float("inf")).argmin(dim=-1)

    monkeypatch.setattr(VectorRunner, "select", worst)


@pytest.mark.parametrize("fault, fails", [(_test_half_episodes, {"test_faults"}),
                                          (_test_stopped_early, {"test_faults"}),
                                          (_test_not_greedy, {"test_action_gap"})],
                         ids=["half_episodes", "stopped_early", "not_greedy"])
def test_a_broken_test_rollout_is_not_correct(monkeypatch, fault, fails):
    """At the test cadence, a fault in the tests alone fails the numbers
    that hold the tests."""
    fault(monkeypatch)
    result, _ = _run("refil_sz_bf16.b512_test")
    assert not result["correct"], result["checks"]
    failing = {k for k, c in result["checks"].items()
               if c["value"] is None or c["value"] > c["limit"]}
    assert fails <= failing <= {"test_faults", "test_q_gap", "test_action_gap"}, \
        result["checks"]

