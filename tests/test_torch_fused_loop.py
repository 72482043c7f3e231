"""refil_torch's fused loop (``run.py:_run_fused_loop``) on the CPU.

* Multi-block dispatch logs the same series as single-block dispatch: the
  same keys at the same t_env with the same values (a mirror of
  ``tests/test_fused_loop.py``; the ``time_*`` phase timers are wall-clock
  and skipped). On the CPU the blocks run eagerly, so the values are equal.
* ``use_fused_pipeline=False`` and ``buffer_cpu_only`` run the classic loop.
* The options once refused in the fused loop (the mesh, multi-process runs,
  replays) do what the JAX package does, and the pipeline builds over a
  mesh of one gloo process.
"""
import functools
import json
import os
import types

import numpy as np
import pytest
import torch

from refil_torch import main as tmain
from refil_torch import run as trun
from refil_torch.core.pipeline import FusedPipeline

ARGS = ["--config=refil_group_matching", "--env-config=group_matching", "with", "t_max=2000",
        "seed=5", "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size_run=4",
        "batch_size=8", "buffer_size=16", "test_nepisode=8", "test_interval=1000",
        "attn_embed_dim=16", "hypernet_embed=16", "mixing_embed_dim=8", "training_iters=2",
        "use_cuda=False"]


def _run(tmp_path, sub, monkeypatch, *extra):
    calls = []

    class Capture(FusedPipeline):
        def run_blocks(self, ps, n_blocks, train=True):
            calls.append(n_blocks)
            return super().run_blocks(ps, n_blocks, train=train)

    monkeypatch.setattr(trun, "FusedPipeline", Capture)
    summary = tmain.main(ARGS + [f"local_results_path={tmp_path / sub}", *extra])
    mdir = os.path.join(str(tmp_path / sub), "metrics")
    with open(os.path.join(mdir, os.listdir(mdir)[0])) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return rows, calls, summary


def test_multi_block_dispatch_matches_single_block(tmp_path, monkeypatch):
    rows_multi, calls_multi, s_multi = _run(tmp_path, "multi", monkeypatch,
                                            "max_blocks_per_dispatch=32")
    rows_single, calls_single, s_single = _run(tmp_path, "single", monkeypatch,
                                               "max_blocks_per_dispatch=1")
    # the multi-block run fused blocks; the control did not
    assert max(calls_multi) > 1, calls_multi
    assert max(calls_single) == 1 and len(calls_multi) < len(calls_single)
    assert s_multi["loop"] == s_single["loop"] == "fused"
    assert sum(calls_multi) == sum(calls_single) == s_multi["blocks"]
    assert [d["blocks"] for d in s_multi["dispatches"]] == calls_multi
    # warm-up (ceil(8 / 4) = 2 blocks) and train blocks never share a dispatch
    assert [d["train"] for d in s_multi["dispatches"][:2]] == [False, False]
    assert s_multi["updates"] == s_multi["blocks"] - 2
    assert s_multi["iterations"] == 2 * s_multi["updates"]
    assert s_multi["diag_calls"] == s_multi["updates"]  # test_gt_factors: every train block
    assert s_multi["graphs"] == {}  # the CPU runs the blocks eagerly

    def series(rows):
        return [(r["key"], r["t"], r["value"]) for r in rows if not r["key"].startswith("time_")]

    sm, ss = series(rows_multi), series(rows_single)
    assert len(sm) == len(ss) and any(r["key"] == "time_block_ms" for r in rows_multi)
    for (k_m, t_m, v_m), (k_s, t_s, v_s) in zip(sm, ss):
        assert k_m == k_s and t_m == t_s, ((k_m, t_m), (k_s, t_s))
        np.testing.assert_allclose(v_m, v_s, rtol=1e-5, atol=1e-7, err_msg=k_m)


@pytest.mark.parametrize("extra,loop", [((), "fused"), (("use_fused_pipeline=False",), "classic"),
                                        (("buffer_cpu_only=True",), "classic")])
def test_loop_choice(tmp_path, extra, loop):
    summary = tmain.main(ARGS[:3] + ["t_max=100", "env_args.episode_limit=10",
                                     "batch_size_run=4", "batch_size=4", "training_iters=2",
                                     "test_nepisode=4", "use_cuda=False",
                                     f"local_results_path={tmp_path}", *extra])
    assert summary["loop"] == loop
    assert summary["updates"] >= 1 and summary["iterations"] == 2 * summary["updates"]
    assert np.isfinite(summary["last_metrics"]["loss"]) and summary["params_max_abs_change"] > 0
    assert ("dispatches" in summary) == (loop == "fused")


@pytest.mark.parametrize("extra", ["mesh_shape={'data':2}", "distributed=True",
                                   "save_replay=True"])
def test_mesh_distributed_and_replay_options(tmp_path, monkeypatch, extra):
    """``mesh_shape={'data':2}`` in one process raises ValueError; a
    distributed fused run of one gloo process logs the same series as the
    undistributed run (its collectives are identities); ``save_replay``
    without a checkpoint trains and writes no replay."""
    if extra == "mesh_shape={'data':2}":
        with pytest.raises(ValueError, match="needs 2 processes"):
            tmain.main(ARGS + [f"local_results_path={tmp_path}", extra])
        return
    short = "t_max=400"
    if extra == "distributed=True":
        from refil_torch.parallel.gate import free_port

        extra = (extra, "num_processes=1", "process_id=0",
                 f"coordinator_address=127.0.0.1:{free_port()}")
        rows_one, _, s_one = _run(tmp_path, "one", monkeypatch, short)
    rows, calls, summary = _run(tmp_path, "run", monkeypatch, short,
                                *(extra if isinstance(extra, tuple) else (extra,)))
    assert summary["loop"] == "fused" and summary["updates"] >= 1 and len(calls) > 1
    assert not torch.distributed.is_initialized()
    if isinstance(extra, tuple):
        assert summary["world_size"] == 1 and summary["t_env"] == s_one["t_env"]

        def series(rows):
            return [(r["key"], r["t"], r["value"]) for r in rows
                    if not r["key"].startswith("time_")]

        assert series(rows) == series(rows_one)
    else:
        assert not os.path.exists(tmp_path / "run" / "replays")


def test_pipeline_refuses_a_mesh():
    """The pipeline over a mesh checks that its sizes divide over the ranks
    (JAX ``core/pipeline.py:108-114``); over a mesh of one gloo process it
    builds."""
    from refil_torch.parallel.gate import free_port
    from refil_torch.parallel.mesh import MeshContext

    args = types.SimpleNamespace(batch_size_run=4, batch_size=8, buffer_dtype="float32",
                                 training_iters=2, target_update_interval=200)
    learner = types.SimpleNamespace(device=torch.device("cpu"), has_gt_diagnostics=False)
    three = types.SimpleNamespace(n_data=3)
    three.check_divisible = functools.partial(MeshContext.check_divisible, three)
    with pytest.raises(ValueError, match="batch_size_run 4 must divide over 3"):
        FusedPipeline(None, learner, 16, args, mesh=three)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                                         world_size=1, rank=0)
    try:
        mesh = MeshContext(torch.device("cpu"))
        pipe = FusedPipeline(None, learner, 16, args, mesh=mesh)
        assert pipe.mesh is mesh and mesh.n_data == 1 and pipe.buffer_size == 16
    finally:
        torch.distributed.destroy_process_group()
