"""The two divergences from the reference that ``tests/test_divergences.py``
pins on ``refil_tpu``, pinned on ``refil_torch``'s ``QLearner._loss`` with
the FF and the RNN entity agent (the same small VDN learner as that file's):

1. The reference selects an action at the terminal pre-transition slot and
   at the post-termination slots of shorter episodes, but its learner never
   consumes them. The port skips selecting them too, which is equivalent
   only if the loss is invariant to those slots: corrupting them (and their
   one-hots, which with ``entity_last_action`` feed only masked steps)
   leaves the loss and every metric bit for bit the same, while corrupting
   a consumed slot changes the loss.

2. The reference truncates sampled batches to ``max_t_filled`` before
   training (``run.py:268-271``); the port keeps the full static T and
   relies on the filled/terminated masks. The loss on the padded batch
   equals the loss on the truncated batch bit for bit (the JAX test allows
   atol 1e-6), and every metric within the JAX test's rtol = atol = 1e-6:
   the means of q_taken and the targets sum tensors of another length, so
   their f32 order may differ (by ~1e-8 here).

The batch comes from a seeded numpy generator, on the CPU.
"""
import numpy as np
import pytest
import torch

from refil_torch.config import Args
from refil_torch.controllers.mac import EntityMAC
from refil_torch.learners.q_learner import QLearner

B, L, NA, NE, A, D = 3, 5, 2, 3, 3, 5


def _args(**over):
    """``tests/test_learner.py:_args``'s learner."""
    base = dict(
        agent="entity_attend_ff", mixer="vdn", entity_scheme=True, entity_last_action=False,
        attn_embed_dim=16, attn_n_heads=2, rnn_hidden_dim=8, pooling_type=None,
        gt_obs_mask=False, double_q=True, gamma=0.99, lr=0.5, optim_alpha=0.99,
        optim_eps=1e-5, grad_norm_clip=10, weight_decay=0, mixing_embed_dim=8,
        hypernet_embed=16, softmax_mixing_weights=False, lmbda=0.5,
        target_update_interval=200, learner_log_interval=2000, train_gt_factors=False,
        train_rand_gt_factors=False)
    base.update(over)
    return Args(**base)


ENV_INFO = {"n_agents": NA, "n_actions": A, "n_entities": NE, "entity_shape": D,
            "episode_limit": L - 1, "gt_mask_avail": False}


def _setup(**over):
    torch.manual_seed(0)
    args = _args(**over)
    mac = EntityMAC(args, ENV_INFO, "cpu")
    learner = QLearner(mac, args, ENV_INFO, "cpu")
    rng = np.random.default_rng(1)
    batch = {
        "entities": torch.as_tensor(rng.standard_normal((B, L, NE, D)), dtype=torch.float32),
        "obs_mask": torch.zeros((B, L, NE, NE), dtype=torch.bool),
        "entity_mask": torch.zeros((B, L, NE), dtype=torch.bool),
        "avail_actions": torch.ones((B, L, NA, A), dtype=torch.bool),
        "actions": torch.as_tensor(rng.integers(0, A, (B, L, NA))),
        "actions_onehot": torch.zeros((B, L, NA, A)),
        "reward": torch.as_tensor(rng.standard_normal((B, L, 1)), dtype=torch.float32),
        # every episode ends at t = 2: slots 0..3 filled, the terminal slot 3 included
        "terminated": torch.zeros((B, L, 1), dtype=torch.bool),
        "filled": torch.ones((B, L, 1), dtype=torch.bool),
    }
    batch["terminated"][:, 2] = True
    batch["filled"][:, 4:] = False
    return learner, batch


def _loss(learner, batch):
    with torch.no_grad():
        loss, metrics = learner._loss(batch)
    return loss, metrics


@pytest.mark.parametrize("agent", ["entity_attend_ff", "entity_attend_rnn"])
def test_terminal_and_post_termination_actions_never_consumed(agent):
    learner, base = _setup(agent=agent, entity_last_action=True)
    loss0, m0 = _loss(learner, base)

    # corrupt the actions the reference selects but never trains on: the
    # terminal slot (3) and every one after, with their one-hots, which with
    # entity_last_action feed only inputs at slot t + 1 >= 4, all masked
    actions = base["actions"].clone()
    actions[:, 3:] = (actions[:, 3:] + 1) % A
    onehot = base["actions_onehot"].clone()
    onehot[:, 3:] += 7.0
    loss1, m1 = _loss(learner, dict(base, actions=actions, actions_onehot=onehot))
    assert torch.equal(loss0, loss1)
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k

    # a consumed slot (t = 1) is not invariant
    actions = base["actions"].clone()
    actions[:, 1] = (actions[:, 1] + 1) % A
    loss2, _ = _loss(learner, dict(base, actions=actions))
    assert float(loss2) != float(loss0)


@pytest.mark.parametrize("agent", ["entity_attend_ff", "entity_attend_rnn"])
def test_full_T_masking_equals_max_t_filled_truncation(agent):
    learner, padded = _setup(agent=agent)
    max_t_filled = int(padded["filled"][0, :, 0].sum())
    assert max_t_filled == 4 < L
    truncated = {k: v[:, :max_t_filled] for k, v in padded.items()}

    loss_pad, m_pad = _loss(learner, padded)
    loss_tr, m_tr = _loss(learner, truncated)
    assert torch.equal(loss_pad, loss_tr)
    assert m_pad.keys() == m_tr.keys()
    for k in m_pad:
        np.testing.assert_allclose(m_pad[k].numpy(), m_tr[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
