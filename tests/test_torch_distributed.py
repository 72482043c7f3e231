"""refil_torch's multi-process data parallelism (``refil_torch/parallel``) on
the CPU, over gloo, each rank a subprocess with a timeout of its own.

* The gate (``parallel/gate.py``, the counterpart of
  ``__graft_entry__.py:assert_sharded_equals_unsharded``): 2 ranks against
  one process over 3 fused train blocks after the warm-up, on Group
  Matching's REFIL and on a tiny combat REFIL (whose imagined groups each
  rank slices from the global draws): every metric within rtol 2e-4,
  atol 1e-6, ``t_env`` exact, parameters equal bit for bit on both ranks,
  each rank's ring its slots of the one-process ring bit for bit.
* The same through the CLI (``distributed=True``), in the fused and the
  classic loop: rank 0's logged losses against one process's, as
  ``tests/test_cli_mesh.py`` checks the JAX mesh, and each rank's replay
  ring half of the one process's.
* A SIGTERM to one rank stops both at the same boundary, with a checkpoint,
  and a resume from it logs the unbroken two-process run's losses.
* ``mesh_shape`` other than the world size raises, sizes that do not divide
  over the ranks raise, and ``distributed`` off builds no process group.
"""
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from refil_torch import main as tmain
from refil_torch.config import Args
from refil_torch.parallel import gate
from refil_torch.parallel.mesh import maybe_init_distributed, maybe_make_mesh

@pytest.fixture(autouse=True)
def one_thread():
    """The in-process runs on one thread, as the ranks' subprocesses run:
    tiny models gain nothing from more, and a loaded machine loses much."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GM = ["--config=refil_group_matching", "--env-config=group_matching", "with", "t_max=400",
      "seed=3", "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size=8",
      "buffer_size=16", "test_nepisode=8", "test_interval=100000", "learner_log_interval=1",
      "use_cuda=False"]


@pytest.mark.parametrize("config", ["group_matching", "combat"])
def test_sharded_equals_unsharded(config):
    out = gate.assert_sharded_equals_unsharded(2, n_blocks=3, config=config, timeout=120)
    assert [r["t_env"] for r in out["sharded"]] == [r["t_env"] for r in out["single"]]
    assert len(out["sharded"]) == 3 and all(np.isfinite(r["loss"]) for r in out["sharded"])
    assert out["ring_bytes"] == [out["single_ring_bytes"] // 2] * 2
    if config == "group_matching":  # the gt diagnostics are among the compared metrics
        assert {"ingroup_prop", "gt_ingroup_prop"} <= set(out["sharded"][0])


def _losses(results_dir, key="loss"):
    rows = []
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            rows += [json.loads(line) for line in f if line.endswith("\n")]
    return [(r["t"], r["value"]) for r in rows if r["key"] == key]


@pytest.mark.parametrize("loop", ["fused", "classic"])
def test_cli_two_ranks_equal_one_process(tmp_path, loop):
    extra = [] if loop == "fused" else ["use_fused_pipeline=False"]
    gate.run_ranks(gate.cli_rank_commands(2, GM + extra + [
        f"local_results_path={tmp_path / 'two'}"], summary_dir=str(tmp_path)) + [[
            *gate.cli_command(str(tmp_path / "one.json")), *GM, *extra,
            f"local_results_path={tmp_path / 'one'}"]], timeout=120)
    # rank 0 alone writes the metrics
    assert len(os.listdir(tmp_path / "two" / "metrics")) == 1
    # the losses, and the gt diagnostics over each rank's shard of the sample
    for key in ("loss", "ingroup_prop", "gt_ingroup_prop"):
        two, one = (_losses(str(tmp_path / d), key) for d in ("two", "one"))
        assert two and [t for t, _ in two] == [t for t, _ in one], key
        np.testing.assert_allclose([v for _, v in two], [v for _, v in one], rtol=2e-4,
                                   atol=1e-6, err_msg=key)
    # each rank holds half of the one-process ring (buffer_size / 2 episodes)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    single = json.load(open(tmp_path / "one.json"))
    assert single["loop"] == loop and single["ring_bytes"] > 0 and single["ring_episodes"] == 16
    for s in ranks:
        assert s["loop"] == loop and s["world_size"] == 2 and s["ring_episodes"] == 8
        assert 2 * s["ring_bytes"] == s["ring_bytes_world"] == single["ring_bytes"]


def _spawn_pair(tmp_path, tag, extra):
    port = gate.free_port()
    procs = []
    for r in range(2):
        cmd = [sys.executable, "-m", "refil_torch.main", *GM, "t_max=3000",
               "max_blocks_per_dispatch=1", *extra, "distributed=True", "num_processes=2",
               f"process_id={r}", f"coordinator_address=127.0.0.1:{port}",
               f"local_results_path={tmp_path / tag}"]
        log = open(tmp_path / f"{tag}_rank{r}.log", "w")
        procs.append(subprocess.Popen(cmd, cwd=gate.ROOT, env=gate.rank_env(), stdout=log,
                                      stderr=subprocess.STDOUT))
        log.close()
    return procs


def _wait(procs, tmp_path, tag, timeout=120):
    try:
        for p in procs:
            rc = p.wait(timeout=timeout)
            assert rc == 0, open(tmp_path / f"{tag}_rank0.log").read()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_sigterm_to_one_rank_and_resume(tmp_path):
    """SIGTERM to rank 1 alone: the ranks agree at the next dispatch, rank 0
    writes the exact-resume checkpoint, both exit 0; a two-rank resume from
    it logs the unbroken two-rank run's losses past it."""
    a = _spawn_pair(tmp_path, "a", [])  # the unbroken run, beside run B
    b = _spawn_pair(tmp_path, "b", [])
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not any(
                t >= 400 for t, _ in _losses(str(tmp_path / "b"))):
            assert all(p.poll() is None for p in b), open(tmp_path / "b_rank0.log").read()[-3000:]
            time.sleep(0.05)
        b[1].send_signal(signal.SIGTERM)
    finally:
        try:
            _wait(b, tmp_path, "b")
        finally:
            _wait(a, tmp_path, "a")
    losses_a = _losses(str(tmp_path / "a"))
    log0 = open(tmp_path / "b_rank0.log").read()
    assert "Preempted at t_env=" in log0, log0[-3000:]
    (ckpt,) = glob.glob(str(tmp_path / "b" / "models" / "*"))
    (step,) = [int(s) for s in os.listdir(ckpt)]
    assert 400 <= step < 3000
    c = _spawn_pair(tmp_path, "c", [f"checkpoint_path={ckpt}"])
    _wait(c, tmp_path, "c")
    tail_a = [r for r in losses_a if r[0] > step]
    tail_c = [r for r in _losses(str(tmp_path / "c")) if r[0] > step]
    assert tail_a and tail_a == tail_c


def test_mesh_shape_must_equal_the_world_size():
    args = Args(mesh_shape={"data": 2}, batch_size_run=8, batch_size=8, buffer_size=16)
    with pytest.raises(ValueError, match="needs 2 processes"):
        maybe_make_mesh(args, "cpu")
    # one process and no mesh_shape (or a world of one): no mesh
    assert maybe_make_mesh(Args(mesh_shape=None), "cpu") is None
    assert maybe_make_mesh(Args(mesh_shape={"data": 1}), "cpu") is None


def test_sizes_that_do_not_divide_raise(tmp_path):
    with pytest.raises(RuntimeError, match="batch_size_run 3 must divide over 2"):
        gate.run_cli_ranks(2, GM + ["batch_size_run=3", f"local_results_path={tmp_path}"],
                           timeout=120)


def test_distributed_off_builds_no_process_group(tmp_path):
    assert maybe_init_distributed({}) is False
    assert maybe_init_distributed({"distributed": False}) is False
    summary = tmain.main(GM[:3] + ["t_max=40", "batch_size_run=4", "batch_size=4",
                                   "use_cuda=False", f"local_results_path={tmp_path}"])
    assert summary["world_size"] == 1 and not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        maybe_init_distributed({"distributed": True, "num_processes": 1, "process_id": 0,
                                "use_cuda": False})
