"""The port's flat path (``qmix`` on ``sc2``: ``BasicMAC``, ``RNNAgent``,
``QMixer`` with two-layer hypernets, ``QLearner``) against the benchmark's
plain QMIX (``benchmark/references/qmix.py``) on the CPU at a small size,
both sides handed the same seeded weights:

* the rollout's Q, step by step as ``BasicMAC.forward_step`` produced it,
  against the reference's whole-episode forward on the same episodes;
* the losses of three updates on three blocks of episodes;
* the first gradient (clipped, as RMSprop got it), leaf by leaf;
* each leaf's change over the three RMSprop updates.

Two faults, planted in the reference put in the port's place, fail the same
tolerances: half of each batch left out, and every product's operands
rounded to bfloat16."""
import statistics

import pytest
import torch

from benchmark import precision
from benchmark.references import qmix as ref
from refil_torch import config as tconfig
from refil_torch import run as trun
from refil_torch.controllers.mac import BasicMAC

OVERRIDES = ["env_args.map_name=5m_vs_6m", "env_args.episode_limit=20", "rnn_hidden_dim=16",
             "hypernet_embed=16", "mixing_embed_dim=8", "batch_size_run=4", "batch_size=4",
             "use_cuda=False", "seed=7"]
UPDATES = 3
# The port and the reference do the same float32 arithmetic, grouped
# differently (a step at a time against a whole episode; F.linear's fused
# bias against a product and an add), so they agree to a few float32
# roundings (epsilon 1.2e-7) carried through a 20-step recurrence and sums
# of at most a few hundred terms: 1e-5 of the scale leaves a hundredfold
# room. RMSprop's early steps are about lr * sign(g), so an element whose
# gradient is near 0 turns a rounding into a larger step: 1e-4 for the change.
TOLERANCE = {"rollout_q": 1e-5, "loss": 1e-5, "grad": 1e-5, "change": 1e-4}
# what each fault must fail: leaving out half of each batch leaves the
# rollout alone
FAULTS = {"half_batch": ("loss", "grad", "change"),
          "bfloat16": ("rollout_q", "loss", "grad", "change")}


def _bfloat16(a, b):
    return torch.matmul(a.bfloat16().float(), b.bfloat16().float())


def _leaf_gap(prog, truth):
    """The largest |prog - truth| over the larger of the leaf's norm and the
    median leaf's."""
    floor = statistics.median(float(v.norm()) for v in truth.values())
    return max(float((prog[k] - truth[k]).norm()) / max(float(truth[k].norm()), floor, 1e-30)
               for k in truth)


@pytest.fixture(scope="module")
def port():
    """The port's outputs from seeded weights: its rollout's Q a step, three
    blocks of episodes (epsilon 1: random play, so the TD targets see
    rewards), the losses of three updates on them, its first gradient and
    its change over the three."""
    cfg = tconfig.args_sanity_check(tconfig.load_config(alg="qmix", env="sc2",
                                                        overrides=OVERRIDES))
    args = tconfig.config_to_args(cfg)
    runner, learner, _ = trun.build_training(args, None, torch.device("cpu"))
    sizes = {**{k: getattr(args, k) for k in (
        "rnn_hidden_dim", "hypernet_layers", "hypernet_embed", "mixing_embed_dim", "gamma", "lr",
        "optim_alpha", "optim_eps", "grad_norm_clip")}, **runner.env.env_info()}
    params0 = ref.init_params(sizes, torch.Generator().manual_seed(3), "cpu")
    names = learner.param_names()
    assert sorted(names) == sorted(params0)
    with torch.no_grad():
        for n, p, t in zip(names, learner.params, learner.target_params):
            p.copy_(params0[n])
            t.copy_(params0[n])
    q_steps, forward_step = [], BasicMAC.forward_step

    def recording(self, *args):
        q, h = forward_step(self, *args)
        q_steps.append(q.detach().clone())
        return q, h

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BasicMAC, "forward_step", recording)
        batches = [runner.rollout(1.0, args.batch_size_run)[0] for _ in range(UPDATES)]
    assert sum(float(b["reward"].abs().sum()) for b in batches) > 0
    rollout_q = torch.stack(q_steps[:runner.episode_limit], dim=1)
    losses, grads = [], None
    for b in batches:
        losses.append(float(learner.train_step(b)["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in zip(names, learner.params)}
    change = {n: p.detach() - params0[n] for n, p in zip(names, learner.params)}
    return {"sizes": sizes, "params0": params0, "batches": batches, "rollout_q": rollout_q,
            "loss": losses, "grad": grads, "change": change}


def _gaps(port, mm=precision.exact, half_batch=False):
    """Each quantity of ``port`` against the reference with products ``mm``,
    trained on the first half of each batch with ``half_batch``."""
    p0, batches, sizes = port["params0"], port["batches"], port["sizes"]
    trained = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches] \
        if half_batch else batches
    losses, grads, p3 = ref.train(p0, trained, [None] * UPDATES, sizes, mm)
    with torch.no_grad():
        q = ref.rollout_q(p0, batches[0], sizes, mm)[:, :-1]
    valid = batches[0]["filled"][:, 1:, 0].bool()
    return {"rollout_q": float((port["rollout_q"] - q).abs()[valid].max() / q.abs()[valid].max()),
            "loss": max(abs(p - float(r)) / abs(float(r)) for p, r in zip(port["loss"], losses)),
            "grad": _leaf_gap(port["grad"], grads),
            "change": _leaf_gap(port["change"], {k: p3[k] - p0[k] for k in p3})}


@pytest.mark.parametrize("quantity", list(TOLERANCE))
def test_port_matches_the_reference(port, quantity):
    gap = _gaps(port)[quantity]
    assert gap <= TOLERANCE[quantity], gap


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_fails_the_tolerances(port, fault):
    gaps = (_gaps(port, half_batch=True) if fault == "half_batch"
            else _gaps(port, mm=_bfloat16))
    for quantity in FAULTS[fault]:
        assert gaps[quantity] > TOLERANCE[quantity], (quantity, gaps)
