"""refil_torch's kill-and-resume and preemption through the CLI on the CPU,
counterparts of ``tests/test_resume.py`` and ``tests/test_preemption.py``
(Group Matching, 4 agents, episodes of 10).

* A fused run saved mid-way with the ring and resumed from that checkpoint
  logs the unbroken run's losses after it, bit for bit (the CPU runs the
  blocks eagerly, as both runs do).
* With ``save_model`` the fused loop ends a dispatch at each save point, so
  its checkpoints land where the one-block-a-dispatch loop puts them.
* SIGTERM, sent in-process from a hook once training is underway: the loop
  finishes its block or dispatch, writes a checkpoint (the fused one with
  the ring) and returns; a resume from it trains on past that point.
"""
import json
import os
import signal

import pytest
import torch

from refil_torch import main as tmain
from refil_torch import run as trun
from refil_torch.core.pipeline import FusedPipeline
from refil_torch.learners.q_learner import QLearner

BASE = ["--config=refil_group_matching", "--env-config=group_matching", "with", "seed=3",
        "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size=8", "buffer_size=16",
        "test_nepisode=8", "test_interval=100000", "learner_log_interval=1",
        "attn_embed_dim=16", "hypernet_embed=16", "mixing_embed_dim=8", "use_cuda=False"]


def _logged(results_dir, key="loss"):
    mdir = os.path.join(results_dir, "metrics")
    rows = []
    for fn in os.listdir(mdir):
        with open(os.path.join(mdir, fn)) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    return sorted((r["t"], r["value"]) for r in rows if r["key"] == key)


def _checkpoints(results_dir):
    root = os.path.join(results_dir, "models")
    (token,) = os.listdir(root)
    ckpt = os.path.join(root, token)
    return ckpt, sorted(int(s) for s in os.listdir(ckpt))


def test_cli_kill_and_resume_bit_exact(tmp_path):
    save = ["save_model=True", "save_model_interval=200", "checkpoint_buffer=True", "t_max=500"]
    a_dir = str(tmp_path / "runA")
    tmain.main(BASE + save + [f"local_results_path={a_dir}"])
    losses_a = _logged(a_dir)
    ckpt, steps = _checkpoints(a_dir)
    assert len(steps) >= 3, steps
    resume_step = steps[len(steps) // 2]

    c_dir = str(tmp_path / "runC")
    summary = tmain.main(BASE + save + [f"checkpoint_path={ckpt}", f"load_step={resume_step}",
                                        f"local_results_path={c_dir}"])
    assert summary["restored"]["t_env"] == resume_step
    assert summary["dispatches"][0]["train"]  # the ring came back: no warm-up
    tail_a = [r for r in losses_a if r[0] > resume_step]
    tail_c = [r for r in _logged(c_dir) if r[0] > resume_step]
    assert tail_a and tail_a == tail_c


def test_fused_dispatches_end_at_save_points(tmp_path):
    """Multi-block dispatches save at the t_env of one-block dispatches."""
    saved = {}
    for n in (32, 1):
        d = str(tmp_path / f"d{n}")
        summary = tmain.main(BASE + ["save_model=True", "save_model_interval=150", "t_max=700",
                                     "batch_size_run=2", f"max_blocks_per_dispatch={n}",
                                     f"local_results_path={d}"])
        saved[n] = [int(os.path.basename(s["path"])) for s in summary["saves"]]
        if n == 32:
            assert max(d["blocks"] for d in summary["dispatches"]) > 1
    assert len(saved[32]) >= 4 and saved[32] == saved[1]


def _sigterm_after_first_update(monkeypatch, fused):
    """SIGTERM to this process once the first learner update has run."""
    sent = []

    def send():
        if not sent:
            sent.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    if fused:
        run_blocks = FusedPipeline.run_blocks

        def hook(self, ps, n_blocks, train=True):
            out = run_blocks(self, ps, n_blocks, train=train)
            if train:
                send()
            return out

        monkeypatch.setattr(FusedPipeline, "run_blocks", hook)
    else:
        train_iters = QLearner.train_iters

        def hook(self, *a, **k):
            out = train_iters(self, *a, **k)
            send()
            return out

        monkeypatch.setattr(QLearner, "train_iters", hook)
    return sent


@pytest.mark.parametrize("loop", ["fused", "classic"])
def test_sigterm_checkpoints_and_resumes(tmp_path, monkeypatch, loop):
    extra = [] if loop == "fused" else ["use_fused_pipeline=False"]
    handler = signal.getsignal(signal.SIGTERM)
    sent = _sigterm_after_first_update(monkeypatch, loop == "fused")
    a_dir = str(tmp_path / "runA")
    summary = tmain.main(BASE + extra + ["t_max=1000000", f"local_results_path={a_dir}"])
    assert sent and summary["preempted"] and summary["loop"] == loop
    assert summary["t_env"] < 1000000
    assert signal.getsignal(signal.SIGTERM) is handler  # the guard put it back
    ckpt, steps = _checkpoints(a_dir)
    preempt_t = steps[-1]
    assert preempt_t == summary["t_env"] == int(os.path.basename(summary["saves"][-1]["path"]))
    blob = torch.load(os.path.join(ckpt, str(preempt_t), trun.STATE_FILE), weights_only=True)
    assert ("pipeline" in blob) == (loop == "fused")
    if loop == "fused":
        assert "ring" in blob["pipeline"]  # preempt_save_buffer defaults to True

    monkeypatch.undo()
    b_dir = str(tmp_path / "runB")
    resumed = tmain.main(BASE + extra + [f"t_max={preempt_t + 100}", f"checkpoint_path={ckpt}",
                                         f"local_results_path={b_dir}"])
    assert not resumed["preempted"]
    assert [t for t, _ in _logged(b_dir) if t > preempt_t], "no progress past the preemption"
    if loop == "fused":
        assert resumed["dispatches"][0]["train"]


def test_handle_preemption_off_installs_no_handler(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(trun.PreemptionGuard, "install", lambda self: seen.append(self) or self)
    summary = tmain.main(BASE + ["t_max=50", "handle_preemption=False",
                                 f"local_results_path={tmp_path}"])
    assert not seen and not summary["preempted"]
