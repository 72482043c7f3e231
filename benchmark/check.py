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
  max(1, largest |value|) over the block's stats and every tensor of the
  training state.
"""
from __future__ import annotations

import dataclasses
import importlib
import statistics
from typing import Callable, Dict, List

import torch

from . import precision

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "rollout_q_gap", "replay_gap", "draw_gap",
           "sample_faults", "insert_faults")
EXACT = ("sample_faults", "insert_faults")
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


def readings(ref_mod, record, sizes, replay_gap: float) -> Dict[str, float]:
    """The program's numbers: its outputs against the float32 reference,
    its sample, and its replays against its eager block."""
    return {**compare(record.outputs(), reference_outputs(ref_mod, record, sizes),
                      valid_steps(record)),
            **sample_numbers(record.sampled()), "replay_gap": replay_gap}


def calibration(ref_mod, record, sizes, dtype: str, replay: Dict[str, float],
                seed: int) -> Dict[str, Dict[str, float]]:
    """Every reading of one seed: the program's; the control's (the
    reference in the program's place, its products one precision below
    ``dtype``); faults planted in the reference put in the program's
    place: half of each batch left out (the mean over the rest), and one
    rollout Q-value altered where it is produced; a graph replay that
    redraws the first train block's numbers (``frozen_draw``, read by
    ``harness.replay_readings``); and bipartitions whose groupA is drawn at
    p 0.5, not from their group_probs (``draw_fault``). A step that leaves
    the state unchanged reads change_gap 1 with no run."""
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
    return {"program": {**compare(record.outputs(), truth, valid), **sample_numbers(sample),
                        "replay_gap": replay["program"]},
            "control": compare(control, truth, valid),
            "half_batch": compare(half, truth, valid),
            "answer_altered": compare(altered, truth, valid),
            "frozen_draw": {"replay_gap": replay["frozen_draw"]},
            "draw_fault": {"draw_gap": draw_gap(unrelated)}}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return bool(all(numbers[k] <= limits[k] for k in limits))
