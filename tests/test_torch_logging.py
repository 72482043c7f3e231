"""refil_torch's logging on the CPU: the classic loop logs the same set of
keys as the JAX package's classic loop for the same small Group Matching
config (its rollout and train phase times among them), and
``use_tensorboard`` writes event files where ``torch.utils.tensorboard``
imports and warns and skips where it does not, as the JAX logger does."""
import glob
import json
import logging
import os
import sys

import pytest

from refil_torch import main as tmain
from refil_torch.utils.logging import Logger

ARGS = ["--config=refil_group_matching", "--env-config=group_matching", "with", "seed=1",
        "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size_run=4", "batch_size=4",
        "buffer_size=16", "test_nepisode=4", "test_interval=40", "log_interval=40",
        "runner_log_interval=40", "learner_log_interval=40", "attn_embed_dim=16",
        "hypernet_embed=16", "mixing_embed_dim=8", "training_iters=2", "t_max=120",
        "use_fused_pipeline=False"]


def _keys(results_dir):
    (path,) = glob.glob(os.path.join(results_dir, "metrics", "*.jsonl"))
    with open(path) as f:
        return {json.loads(line)["key"] for line in f if line.strip()}


def test_classic_loop_logs_the_jax_keys(tmp_path):
    from refil_tpu.main import main as jmain

    jmain(ARGS + [f"local_results_path={tmp_path / 'jax'}"])
    tmain.main(ARGS + ["use_cuda=False", f"local_results_path={tmp_path / 'torch'}"])
    want = _keys(str(tmp_path / "jax"))
    assert {"time_rollout_ms", "time_train_ms", "loss", "test_return_mean"} <= want
    assert _keys(str(tmp_path / "torch")) == want


def test_tensorboard_writes_events(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    summary = tmain.main(ARGS + ["use_cuda=False", "use_tensorboard=True",
                                 f"local_results_path={tmp_path}"])
    (run_dir,) = glob.glob(os.path.join(str(tmp_path), "tb_logs", "*"))
    assert os.path.basename(run_dir).startswith("refil__")
    events = glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0 and summary["updates"] >= 1


def test_tensorboard_missing_warns_and_skips(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    logger = Logger(logging.getLogger("tensorboard_check"))
    with caplog.at_level(logging.WARNING, logger="tensorboard_check"):
        logger.setup_tb(str(tmp_path / "tb"))
    assert "tensorboard unavailable" in caplog.text
    assert not os.path.exists(tmp_path / "tb")
    logger.log_stat("loss", 1.0, 5)  # logging goes on without it
    assert logger.stats["loss"] == [(5, 1.0)]
    summary = tmain.main(ARGS + ["use_cuda=False", "use_tensorboard=True",
                                 f"local_results_path={tmp_path / 'run'}"])
    assert summary["updates"] >= 1 and not os.path.exists(tmp_path / "run" / "tb_logs")
