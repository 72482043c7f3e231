"""refil_torch.ops.masks against refil_tpu.ops.masks: exact boolean equality
on the same inputs, with the JAX package's imagine draws injected."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refil_tpu.ops import masks as jm
from refil_torch.ops import masks as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed=0, B=3, T=4, Ne=6, Na=4):
    rng = np.random.default_rng(seed)
    obs = rng.random((B, T, Ne, Ne)) < 0.3
    em = rng.random((B, T, Ne)) < 0.2
    gt = rng.random((B, T, Na, Ne)) < 0.5
    return obs, em, gt


def _jax_draws(key, B, Ne):
    key_p, key_b = jax.random.split(key)
    gp = jax.random.uniform(key_p, (B, 1, 1))
    ga = jax.random.bernoulli(key_b, gp, (B, 1, Ne))
    return np.array(gp), np.array(ga)


@pytest.mark.parametrize("seed", [0, 1])
def test_entity_and_agent_masks(seed):
    _, em, _ = _inputs(seed)
    np.testing.assert_array_equal(tm.entitymask2attnmask(torch.as_tensor(em)).numpy(),
                                  np.asarray(jm.entitymask2attnmask(jnp.asarray(em))))
    for na in (1, 4, 6):
        np.testing.assert_array_equal(
            tm.agentmask2attnmask(torch.as_tensor(em), na).numpy(),
            np.asarray(jm.agentmask2attnmask(jnp.asarray(em), na)))
        np.testing.assert_array_equal(
            tm.hypernet_attn_mask(torch.as_tensor(em), na).numpy(),
            np.asarray(jm.hypernet_attn_mask(jnp.asarray(em), na)))


@pytest.mark.parametrize("agent_rows", [False, True])
@pytest.mark.parametrize("mode", ["random", "gt", "rand_gt"])
def test_build_imagine_masks(agent_rows, mode):
    obs, em, gt = _inputs(3)
    B, T, Ne = em.shape
    Na = gt.shape[2]
    if not agent_rows:  # square masks: the gt mask covers every row
        gt = np.random.default_rng(4).random((B, T, Ne, Ne)) < 0.5
    key = jax.random.PRNGKey(7)
    kw = dict(use_gt_factors=mode == "gt", use_rand_gt_factors=mode == "rand_gt")
    ref = jm.build_imagine_masks(key, jnp.asarray(obs), jnp.asarray(em), Na,
                                 agent_rows=agent_rows, gt_mask=jnp.asarray(gt), **kw)
    gp, ga = _jax_draws(key, B, Ne)
    out = tm.build_imagine_masks(torch.as_tensor(obs), torch.as_tensor(em), Na,
                                 agent_rows=agent_rows, gt_mask=torch.as_tensor(gt),
                                 group_probs=torch.as_tensor(gp), groupA=torch.as_tensor(ga),
                                 **kw)
    for name in ("within", "interact", "w_noobs", "i_noobs"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_imagine_masks_draws_from_generator():
    obs, em, _ = _inputs(5)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    m1 = tm.build_imagine_masks(torch.as_tensor(obs), torch.as_tensor(em), 4, agent_rows=True,
                                generator=g1)
    gp, ga = tm.draw_imagine_groups(em.shape[0], em.shape[2], g2, "cpu")
    m2 = tm.build_imagine_masks(torch.as_tensor(obs), torch.as_tensor(em), 4, agent_rows=True,
                                group_probs=gp, groupA=ga)
    for a, b in zip(m1, m2):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tm.build_imagine_masks(torch.as_tensor(obs), torch.as_tensor(em), 4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scenario", ["3-8MMM_symmetric", "3-8csz_symmetric"])
def test_build_imagine_masks_on_combat_rollouts(scenario):
    """The square imagined masks REFIL's RNN agent and hypernets take, on the
    masks of combat rollouts in which units die (``chip_smoke.py``'s
    ``combat_rollout_masks``, which the card's kernel check feeds the
    attention with; here on the CPU, 4 episodes of the full 150 steps),
    equal the JAX package's bit for bit with its draws injected."""
    from refil_torch.config import load_config

    cfg = load_config(alg="refil", env="sc2custom", overrides=[f"scenario={scenario}"])
    om, em, dead, na = _chip_smoke().combat_rollout_masks(cfg, scenario, 4, seed=3,
                                                          device="cpu")
    assert om.shape == (4, cfg["env_args"]["episode_limit"] + 1, 16, 16) and na == 8
    assert 0 < dead < 1, dead
    key = jax.random.PRNGKey(11)
    ref = jm.build_imagine_masks(key, jnp.asarray(om.numpy()), jnp.asarray(em.numpy()), na)
    gp, ga = _jax_draws(key, 4, em.shape[-1])
    out = tm.build_imagine_masks(om, em, na, group_probs=torch.as_tensor(gp),
                                 groupA=torch.as_tensor(ga))
    for name in ("within", "interact", "w_noobs", "i_noobs"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
