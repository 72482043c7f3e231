"""refil_torch's replay ring sharded over the ranks of a data mesh
(``parallel/mesh.py:RingLayout``, ``gather_sample``, ``gather_ring``), as the
JAX package shards its ring over the data axis; on the CPU over gloo, each
rank a subprocess with a timeout of its own.

* ``RingLayout`` gives every global slot to exactly one rank, the fused
  ring's slots to the rank whose envs fill them, and sizes that do not
  divide raise.
* The exchange hands each rank its slice of the global sample bit for bit:
  float32 with -0.0 and NaN payloads, bfloat16, bool and int64 planes, in
  one ``reduce_scatter``, in the fused and the classic layouts.
* The gate at 4 ranks (Group Matching, whose gt diagnostics it compares)
  and with a bfloat16 ring at 2: each rank's ring is its slots of the
  one-process ring bit for bit, in 1/n of its bytes.
* A checkpoint with the ring saved by 2 ranks holds the one-process ring in
  global slot order and resumes in 1 process; one saved by 1 process
  resumes in 2 ranks; both continue as the unbroken run.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from refil_torch.parallel import gate
from refil_torch.parallel.mesh import RingLayout

GM = ["--config=refil_group_matching", "--env-config=group_matching", "with", "seed=3",
      "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size=8", "buffer_size=16",
      "test_nepisode=8", "test_interval=100000", "learner_log_interval=1", "use_cuda=False"]


@pytest.mark.parametrize("size,period,n", [(16, 8, 2), (24, 8, 4), (20, 20, 2), (5000, 5000, 4)])
def test_ring_layout_partitions_the_slots(size, period, n):
    layouts = [RingLayout(size, period, n, r) for r in range(n)]
    held = [lay.held_slots() for lay in layouts]
    assert all(len(h) == size // n for h in held)
    assert torch.equal(torch.sort(torch.cat(held)).values, torch.arange(size))
    for r, (lay, h) in enumerate(zip(layouts, held)):
        assert torch.equal(lay.owner(h), torch.full_like(h, r))
        assert torch.equal(lay.local(h), torch.arange(size // n))
    if period < size:  # the fused ring: a block of period envs, rank r's run of them
        block = torch.arange(period) + period
        assert torch.equal(layouts[0].owner(block), torch.arange(period) // (period // n))


def test_ring_layout_sizes_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="cannot be sharded"):
        RingLayout(20, 8, 2, 0)
    with pytest.raises(ValueError, match="cannot be sharded"):
        RingLayout(18, 6, 4, 0)


@pytest.mark.parametrize("world,size,period", [(2, 24, 8), (4, 32, 8), (2, 20, 20)])
def test_exchange_is_the_sample_slice_bit_for_bit(world, size, period):
    ring = gate.exchange_ring(size)
    assert (ring["f32"].view(torch.int32) == torch.tensor(-0.0).view(torch.int32)).any()
    assert torch.isnan(ring["f32"]).any()
    out = gate.assert_exchange_exact(world, size, period, timeout=60)
    assert out["launches"] == [{"all_gather": 0, "all_reduce": 0, "reduce_scatter": 1}] * world


def test_gate_four_ranks_group_matching():
    out = gate.assert_sharded_equals_unsharded(4, n_blocks=3, timeout=120)
    assert [r["t_env"] for r in out["sharded"]] == [r["t_env"] for r in out["single"]]
    # the gt diagnostics are among the compared metrics
    assert {"ingroup_prop", "gt_ingroup_prop"} <= set(out["sharded"][0])
    assert out["ring_bytes"] == [out["single_ring_bytes"] // 4] * 4


def test_gate_two_ranks_bfloat16_ring():
    out = gate.assert_sharded_equals_unsharded(2, n_blocks=2, timeout=120,
                                               overrides=["buffer_dtype=bfloat16"])
    assert out["ring_bytes"] == [out["single_ring_bytes"] // 2] * 2


def _losses(results_dir):
    rows = []
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            rows += [json.loads(line) for line in f if line.endswith("\n")]
    return sorted((r["t"], r["value"]) for r in rows if r["key"] == "loss")


CK = GM + ["t_max=600", "save_model=True", "save_model_interval=200", "checkpoint_buffer=True"]


def _checkpoints(results_dir):
    (token,) = glob.glob(os.path.join(results_dir, "models", "*"))
    return token, sorted(int(s) for s in os.listdir(token))


def _ring(token, step):
    blob = torch.load(os.path.join(token, str(step), "state.pt"), map_location="cpu",
                      weights_only=True)
    return blob["pipeline"]


@pytest.mark.parametrize("saved_by,resumed_by", [(2, 1), (1, 2)])
def test_ring_checkpoint_resumes_at_another_world_size(tmp_path, saved_by, resumed_by):
    one = str(tmp_path / "one")
    cmds = [[*gate.cli_command(), *CK, f"local_results_path={one}"]]
    saved = one
    if saved_by == 2:
        saved = str(tmp_path / "saved")
        cmds += gate.cli_rank_commands(2, CK + [f"local_results_path={saved}"])
    gate.run_ranks(cmds, timeout=120)
    token, steps = _checkpoints(saved)
    step = steps[1]
    if saved_by == 2:  # the ranks' ring, gathered in global slot order
        _, one_steps = _checkpoints(one)
        assert one_steps == steps
        a, b = _ring(token, step), _ring(_checkpoints(one)[0], step)
        assert {k: a[k] for k in ("buffer_index", "episodes_in_buffer", "t_env")} == {
            k: b[k] for k in ("buffer_index", "episodes_in_buffer", "t_env")}
        gate.assert_ring_shard(a["ring"], torch.arange(16), b["ring"], 1, "saved ring")
    resumed = str(tmp_path / "resumed")
    argv = CK + [f"checkpoint_path={token}", f"load_step={step}",
                 f"local_results_path={resumed}"]
    gate.run_ranks([[*gate.cli_command(), *argv]] if resumed_by == 1
                   else gate.cli_rank_commands(2, argv), timeout=120)
    tail_one = [r for r in _losses(one) if r[0] > step]
    tail_resumed = _losses(resumed)
    assert tail_one and [t for t, _ in tail_resumed] == [t for t, _ in tail_one]
    np.testing.assert_allclose([v for _, v in tail_resumed], [v for _, v in tail_one],
                               rtol=2e-4, atol=1e-6)

