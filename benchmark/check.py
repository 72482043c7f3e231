"""How ``correct`` is decided: the program's first updates and its rollout's
agent forward, against the plain reference on the same inputs.

The benchmark hands both sides the same initial weights (made from the seed
by ``references.<name>.init_params``). Set-up drives the program through its
first train block, whose first three updates and whose rollout are recorded
(``harness.Recorder``); that same training state then runs the window. After
the window the reference works out, from the recorded inputs (the sampled
episodes, the imagined bipartitions drawn, the rollout's episodes) and the
weights it was handed, what the program should have produced:

* ``loss_gap``: the largest |program - reference| / |reference| of the
  three updates' losses;
* ``grad_gap``: the first gradient as the optimizer got it, read from the
  program's RMSprop state after one step (``square_avg = (1 - alpha) g^2``):
  over the leaves, the largest |norm(program) - norm(reference)| over the
  larger of the reference leaf's norm and the median leaf's;
* ``change_gap``: the same for each leaf's change over the three updates
  (the parameters as the fourth update finds them), over the leaves whose
  reference gradient is at least ``STILL_LEAF`` of the median leaf's;
* ``rollout_q_gap``: the rollout's Q-values, step by step as the program's
  agent produced them, against the reference's whole-episode forward on
  the same episodes: the largest |difference| over the largest |Q|, on the
  steps where the env was running.

The reference's batches are the ring's episodes at the slots the program's
sample drew, read from the ring by the benchmark; what the program's
sampler, insert and draws did is held by three more numbers:

* ``sample_faults`` (exact, limit 0): slots drawn twice in one update's
  sample, slots outside the filled prefix, and updates whose slots are the
  first update's all over again;
* ``insert_faults`` (exact, limit 0): the checked envs' episodes that the
  ring does not hold, plane by plane, as the rollout produced them, after
  the insert;
* ``draw_gap``: whether each imagined bipartition's ``groupA`` was drawn
  from its ``group_probs`` (Bernoulli(p) per entity): over the three
  updates' episodes, the mean of (share of the episode's entities in A -
  p)^2 over the binomial variance p(1 - p) / n_entities, p held within
  [1 / (4 n), 1 - 1 / (4 n)] in the variance. About 1 for sound draws.

And one number holds the timed path, the window's graph replays, to the
eager path that the reference judges (``harness.replay_readings``):

* ``replay_gap``: one train block from the state the window left, replayed
  and run eagerly from one snapshot: the largest |difference| over
  max(1, largest |value|) over the block's stats, the state outside the
  ring and the ring's rows the block's insert writes; ``inf`` where either
  run changed another ring row (held by an exact digest of each row, not
  by a copy of the ring).

And three hold the window's test rollouts (the loop's periodic greedy
tests, ``harness.Tests``), which add no env step to the window's rate:

* ``test_faults`` (exact, limit 0): over every test the run made, as the
  loop's test entry returned it: the tests missing or extra against the
  cadence (a test at each dispatch boundary where ``test_interval`` env
  steps have passed since the last), the episodes a test lacks or has
  beyond all of ``test_nepisode`` in whole blocks of ``batch_size_run``,
  and the episodes that neither terminated nor reached the episode limit;
* ``test_q_gap``: the window's first test, on the checked envs' rows: its
  agents' Q step by step against the reference's whole-episode forward on
  its episodes, with the parameters it ran with (the program's, as the
  window's training left them: the reference cannot follow that training
  through the window; the first three updates and ``replay_gap`` hold it),
  as ``rollout_q_gap`` is read;
* ``test_action_gap``: the same test's actions against the reference's
  greedy choice: the largest amount by which the chosen action's reference
  Q lies below the best available one's, over the largest |Q|, on the
  steps where the env was running (``inf`` for an unavailable action).
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import math
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import precision

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "rollout_q_gap", "replay_gap", "draw_gap",
           "sample_faults", "insert_faults", "test_faults", "test_q_gap", "test_action_gap")
EXACT = ("sample_faults", "insert_faults", "test_faults")
# leaves whose reference gradient is below this share of the median leaf's
# move by round-off alone and are left out of change_gap
STILL_LEAF = 1e-3


def reference(name: str):
    return importlib.import_module(f"benchmark.references.{name}")


@dataclasses.dataclass
class Outputs:
    """What one side produced: the three losses, the first gradient's and
    the three updates' change's norm by leaf, the rollout's Q (B, T, Na, A)."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    rollout_q: torch.Tensor


@dataclasses.dataclass
class Sample:
    """What the program's sampler, insert and draws produced: the slots
    drawn (training_iters, batch_size), the filled prefix then, the three
    updates' bipartitions, the checked envs' episodes as the rollout made
    them and the ring's rows at their slots after the insert."""

    idx: torch.Tensor
    filled: int
    draws: List
    rollout: Dict[str, torch.Tensor]
    inserted: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TestRollout:
    """One test rollout on the checked envs' rows: its episodes as the
    loop's test entry returned them (B, T+1, ...), its agents' Q step by
    step (B, T, Na, A) and the parameters it ran with."""

    batch: Dict[str, torch.Tensor]
    q: torch.Tensor
    params: Dict[str, torch.Tensor]


def test_faults(seen: Sequence, expected: Sequence[int], width: int, limit: int) -> int:
    """``seen``: (t_env, filled (B, T+1, 1), terminated (B, T+1, 1)) of each
    test the run made; ``expected``: the t_envs the cadence calls for;
    ``width``: the episodes a test covers; ``limit``: the episode limit."""
    want, got = collections.Counter(expected), collections.Counter(t for t, _, _ in seen)
    faults = sum(((want - got) + (got - want)).values())
    for _, filled, terminated in seen:
        lengths = filled[:, 1:, 0].long().sum(1)
        last = terminated[:, :, 0].gather(1, (lengths - 1).clamp_min(0)[:, None])[:, 0]
        ended = (lengths >= limit) | last.bool()
        faults += abs(filled.shape[0] - width) + int((~ended).sum())
    return faults


def expected_tests(dispatch_env_steps: Sequence[int], interval: float) -> List[int]:
    """The t_envs at which the loop's cadence tests: after each dispatch,
    where ``interval`` env steps have passed since the last test (the first
    dispatch always tests)."""
    t, last, out = 0, -interval - 1, []
    for n in dispatch_env_steps:
        t += int(n)
        if (t - last) / interval >= 1.0:
            out.append(t)
            last = t
    return out


def _test_valid(batch) -> torch.Tensor:
    return batch["filled"][:, 1:, 0].bool()


def action_gap(q_ref: torch.Tensor, actions: torch.Tensor, avail: torch.Tensor,
               valid: torch.Tensor) -> float:
    """The largest (best available reference Q - the chosen action's) over
    the largest |reference Q|, on the ``valid`` (B, T) steps; q_ref, avail
    (B, T, Na, A), actions (B, T, Na)."""
    best = q_ref.masked_fill(~avail, -math.inf).amax(-1)
    pick = actions[..., None]
    gap = torch.where(avail.gather(-1, pick)[..., 0], best - q_ref.gather(-1, pick)[..., 0],
                      math.inf)
    scale = q_ref.abs()[valid].max().clamp_min(1e-30)
    return float(gap[valid].max() / scale)


def test_numbers(q: torch.Tensor, actions: torch.Tensor, q_ref: torch.Tensor,
                 batch) -> Dict[str, float]:
    """``test_q_gap`` of ``q`` and ``test_action_gap`` of ``actions``
    against the reference's Q ``q_ref`` (B, T, Na, A) on ``batch``."""
    valid, T = _test_valid(batch), q_ref.shape[1]
    avail = batch["avail_actions"][:, :T].bool()
    q, q_ref = q.float(), q_ref.float()
    scale = q_ref.abs()[valid].max().clamp_min(1e-30)
    return {"test_q_gap": float((q - q_ref).abs()[valid].max() / scale),
            "test_action_gap": action_gap(q_ref, actions, avail, valid)}


def test_reference_q(ref_mod, test: TestRollout, sizes, mm: Callable = precision.exact):
    with torch.no_grad():
        params = {k: v.float() for k, v in test.params.items()}
        return ref_mod.rollout_q(params, test.batch, sizes, mm)[:, :-1]


def greedy(q: torch.Tensor, batch) -> torch.Tensor:
    """The greedy actions of ``q`` (B, T, Na, A) over the available ones."""
    avail = batch["avail_actions"][:, :q.shape[1]].bool()
    return q.float().masked_fill(~avail, -math.inf).argmax(-1)


def sample_faults(s: Sample) -> int:
    rows = [sorted(r) for r in s.idx.tolist()]
    twice = sum(len(r) - len(set(r)) for r in rows)
    outside = int(((s.idx < 0) | (s.idx >= s.filled)).sum())
    again = sum(r == rows[0] for r in rows[1:])
    return twice + outside + again


def insert_faults(s: Sample) -> int:
    return sum(int((~(s.inserted[k] == s.rollout[k].to(s.inserted[k].dtype))
                    .reshape(s.inserted[k].shape[0], -1).all(1)).sum()) for k in s.inserted)


def draw_gap(draws) -> float:
    """0 where the learner draws no bipartition (no imagined pass)."""
    if not draws:
        return 0.0
    p = torch.cat([d[0].reshape(-1) for d in draws]).double().cpu()
    a = torch.cat([d[1].reshape(d[1].shape[0], -1) for d in draws]).double().cpu()
    n = a.shape[1]
    held = p.clamp(1 / (4 * n), 1 - 1 / (4 * n))
    return float(((a.mean(1) - p) ** 2 / (held * (1 - held) / n)).mean())


def sample_numbers(s: Sample) -> Dict[str, float]:
    return {"draw_gap": draw_gap(s.draws), "sample_faults": float(sample_faults(s)),
            "insert_faults": float(insert_faults(s))}


def reference_outputs(ref_mod, record, sizes, mm: Callable = precision.exact,
                      half_batch: bool = False) -> Outputs:
    """The reference's outputs from the recorded inputs, its products
    ``mm``; ``half_batch`` (a fault) trains on the first half of each batch."""
    batches, draws = record.batches, record.draws or [None] * len(record.batches)
    if half_batch:
        n = next(iter(batches[0].values())).shape[0] // 2
        batches = [{k: v[:n] for k, v in b.items()} for b in batches]
        draws = [draw and tuple(d[:n] for d in draw) for draw in draws]
    losses, grads, p3 = ref_mod.train(record.params0, batches, draws, sizes, mm)
    with torch.no_grad():
        q = ref_mod.rollout_q(record.params0, record.rollout_batch, sizes, mm)[:, :-1]
    return Outputs([float(v) for v in losses], ref_mod.leaf_norms(grads),
                   ref_mod.leaf_norms({k: p3[k] - record.params0[k] for k in p3}), q)


def compare(out: Outputs, ref: Outputs, valid: torch.Tensor) -> Dict[str, float]:
    """The four numbers of ``out`` against ``ref``; ``valid`` (B, T) the
    rollout steps where the env was running."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(out.losses, ref.losses))
    median_g = statistics.median(ref.grad_norms.values())
    moving = [k for k, v in ref.grad_norms.items() if v >= STILL_LEAF * median_g]

    def leaf_gap(prog, truth, leaves):
        floor = statistics.median(truth.values())
        return max(abs(prog[k] - truth[k]) / max(truth[k], floor, 1e-30) for k in leaves)

    q, q_ref = out.rollout_q.float(), ref.rollout_q.float()
    diff = (q - q_ref).abs()[valid].max()
    scale = q_ref.abs()[valid].max().clamp_min(1e-30)
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(out.grad_norms, ref.grad_norms, ref.grad_norms),
            "change_gap": leaf_gap(out.change_norms, ref.change_norms, moving),
            "rollout_q_gap": float(diff / scale)}


def valid_steps(record) -> torch.Tensor:
    return record.rollout_batch["filled"][:, 1:, 0].bool()


def _test_actions(test: TestRollout) -> torch.Tensor:
    return test.batch["actions"][:, :test.q.shape[1]]


def readings(ref_mod, record, sizes, replay_gap: float, faults_in_tests: int,
             test: Optional[TestRollout]) -> Dict[str, float]:
    """The program's numbers: its outputs against the float32 reference,
    its sample, its replays against its eager block, its tests; the two
    numbers of the window's first test only where the window held one."""
    out = {**compare(record.outputs(), reference_outputs(ref_mod, record, sizes),
                     valid_steps(record)),
           **sample_numbers(record.sampled()), "replay_gap": replay_gap,
           "test_faults": float(faults_in_tests)}
    if test is not None:
        out.update(test_numbers(test.q, _test_actions(test),
                                test_reference_q(ref_mod, test, sizes), test.batch))
    return out


def _test_calibration(ref_mod, test: TestRollout, sizes, low: Callable):
    """The window's first test: the program's two numbers, the control's
    (its Q, and the actions its Q puts first, at each step of the same
    episodes), and one Q-value and one action altered where produced (the
    action to the available one the reference puts last)."""
    truth = test_reference_q(ref_mod, test, sizes)
    control = test_reference_q(ref_mod, test, sizes, low)
    actions = _test_actions(test)
    valid = _test_valid(test.batch)
    b, t = (int(i) for i in valid.nonzero()[0])
    altered_q = test.q.float().clone()
    altered_q[b, t, 0, 0] += 1.0
    avail = test.batch["avail_actions"][:, :truth.shape[1]].bool()
    worst = truth.masked_fill(~avail, math.inf).argmin(-1)
    altered_actions = actions.clone()
    altered_actions[b, t] = worst[b, t]
    altered = test_numbers(altered_q, altered_actions, truth, test.batch)
    return {"program": test_numbers(test.q, actions, truth, test.batch),
            "control": test_numbers(control, greedy(control, test.batch), truth, test.batch),
            "answer_altered": altered}


def calibration(ref_mod, record, sizes, dtype: str, replay: Dict[str, float],
                seed: int, faults_in_tests: int = 0,
                test: Optional[TestRollout] = None) -> Dict[str, Dict[str, float]]:
    """Every reading of one seed: the program's; the control's (the
    reference in the program's place, its products one precision below
    ``dtype``); faults planted in the reference put in the program's
    place: half of each batch left out (the mean over the rest), and one
    rollout Q-value altered where it is produced; a graph replay that
    redraws the first train block's numbers (``frozen_draw``) and one that
    writes a bit of the ring outside the insert's slots (``stray_write``),
    both read by ``harness.replay_readings``; and bipartitions whose groupA
    is drawn at p 0.5, not from their group_probs (``draw_fault``). A step
    that leaves the state unchanged reads change_gap 1 with no run. Where
    the window held a test (``test``), its numbers beside them
    (``_test_calibration``)."""
    valid = valid_steps(record)
    sample = record.sampled()
    gen = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    unrelated = [(p, torch.rand(a.shape, generator=gen) < 0.5)
                 for p, a in ((p.cpu(), a.cpu()) for p, a in sample.draws)]
    truth = reference_outputs(ref_mod, record, sizes)
    low = precision.PRODUCTS[precision.CONTROL[dtype]]
    control = reference_outputs(ref_mod, record, sizes, low)
    half = reference_outputs(ref_mod, record, sizes, half_batch=True)
    altered_q = truth.rollout_q.clone()
    altered_q[tuple(valid.nonzero()[0].tolist()) + (0, 0)] += 1.0
    altered = dataclasses.replace(truth, rollout_q=altered_q)
    tests = _test_calibration(ref_mod, test, sizes, low) if test is not None else {}
    return {"program": {**compare(record.outputs(), truth, valid), **sample_numbers(sample),
                        "replay_gap": replay["program"], "test_faults": float(faults_in_tests),
                        **tests.get("program", {})},
            "control": {**compare(control, truth, valid), **tests.get("control", {})},
            "half_batch": compare(half, truth, valid),
            "answer_altered": {**compare(altered, truth, valid),
                               **tests.get("answer_altered", {})},
            "frozen_draw": {"replay_gap": replay["frozen_draw"]},
            "stray_write": {"replay_gap": replay["stray_write"]},
            "draw_fault": {"draw_gap": draw_gap(unrelated)}}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN, or a number not read,
    fails)."""
    return bool(all(numbers.get(k, math.nan) <= limits[k] for k in limits))
