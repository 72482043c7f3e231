"""refil_torch's checkpoints (``run.py:_save_checkpoint``, ``_load_checkpoint``,
``restore_pipeline_state``, ``resume_warmup_blocks``, ``find_checkpoint``) on
the CPU, at the Group Matching size of ``tests/test_torch_pipeline.py:_port``;
counterparts of ``tests/test_checkpoint.py`` and the pipeline-level cases of
``tests/test_resume.py``. Every comparison is exact: a restore copies the
saved bits."""
import os

import pytest
import torch

from refil_torch import config as tconfig
from refil_torch import main as tmain
from refil_torch import run as trun
from test_torch_pipeline import _port


def _learner_tensors(learner):
    """{name: tensor} of the parameters, targets and RMSprop state."""
    out = {}
    for n, p, t in zip(learner.param_names(), learner.params, learner.target_params):
        out["param." + n], out["target." + n] = p, t
        for k, v in learner.optimiser.state.get(p, {}).items():
            out[f"opt.{n}.{k}"] = v
    return out


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_checkpoint_roundtrip(tmp_path):
    pipe, ps, _, learner, _ = _port(seed=0)
    pipe.block(ps, train=False)
    pipe.block(ps, train=True)  # updates: the optimiser state is not trivial
    path = str(tmp_path / "ckpt")
    info = trun._save_checkpoint(path, learner)
    assert info["bytes"] == os.path.getsize(os.path.join(path, trun.STATE_FILE)) > 0
    assert not os.path.exists(os.path.join(path, trun.STATE_FILE + ".tmp"))
    want = {k: v.clone() for k, v in _learner_tensors(learner).items()}
    assert any(k.startswith("opt.") for k in want)

    _, _, _, fresh, _ = _port(seed=99)  # other weights, no optimiser state yet
    assert trun._load_checkpoint(path, fresh) is None  # no pipeline state was saved
    _assert_equal(_learner_tensors(fresh), want)


def test_load_copies_into_the_live_tensors(tmp_path):
    """A captured CUDA graph replays on the tensors it was captured over, so
    a load must keep every tensor's storage: parameters, targets and the
    optimiser state."""
    pipe, ps, _, learner, _ = _port(seed=0)
    pipe.block(ps, train=False)
    pipe.block(ps, train=True)
    path = str(tmp_path / "ckpt")
    trun._save_checkpoint(path, learner)
    want = {k: v.clone() for k, v in _learner_tensors(learner).items()}
    pipe.block(ps, train=True)  # the live state moves on
    ptrs = {k: v.data_ptr() for k, v in _learner_tensors(learner).items()}
    trun._load_checkpoint(path, learner)
    live = _learner_tensors(learner)
    assert {k: v.data_ptr() for k, v in live.items()} == ptrs
    _assert_equal(live, want)


def test_load_before_any_update_zeroes_the_optimiser_in_place(tmp_path):
    pipe, ps, _, learner, _ = _port(seed=0)
    path = str(tmp_path / "ckpt")
    trun._save_checkpoint(path, learner)  # no update yet: no optimiser state
    pipe.block(ps, train=False)
    pipe.block(ps, train=True)
    opt = {k: v for k, v in _learner_tensors(learner).items() if k.startswith("opt.")}
    trun._load_checkpoint(path, learner)
    assert all(not v.any() for v in opt.values())


def test_checkpoint_rejects_another_model(tmp_path):
    _, _, _, learner, _ = _port(seed=0)
    path = str(tmp_path / "ckpt")
    trun._save_checkpoint(path, learner)
    f = os.path.join(path, trun.STATE_FILE)
    blob = torch.load(f, weights_only=True)
    name = learner.param_names()[0]
    blob["params"][name] = torch.zeros(tuple(blob["params"][name].shape) + (2,))
    torch.save(blob, f)
    with pytest.raises(ValueError, match="shape"):
        trun._load_checkpoint(path, learner)
    del blob["params"][name]
    torch.save(blob, f)
    with pytest.raises(KeyError, match="match"):
        trun._load_checkpoint(path, learner)


@pytest.mark.parametrize("with_ring", [True, False])
def test_pipeline_state_roundtrip(tmp_path, with_ring):
    """Counters and generators always round-trip; with the ring, blocks
    continued from the restore repeat the original's losses bit for bit;
    without it the fresh ring keeps its zero fill counters."""
    pipe, ps, _, learner, _ = _port(seed=0)
    pipe.block(ps, train=False)
    pipe.block(ps, train=True)
    path = str(tmp_path / "ckpt")
    trun._save_checkpoint(path, learner, pstate=ps, include_buffer=with_ring)
    counters = {k: int(getattr(ps, k)) for k in trun.PIPELINE_COUNTERS}
    gens = {k: g.get_state() for k, g in ps.generators.items()}
    losses = [float(pipe.block(ps, train=True)["metrics"]["loss"]) for _ in range(3)]

    pipe2, ps2, _, learner2, args2 = _port(seed=99)
    payload = trun._load_checkpoint(path, learner2)
    assert ("ring" in payload) == with_ring
    trun.restore_pipeline_state(ps2, payload)
    for k, g in ps2.generators.items():
        torch.testing.assert_close(g.get_state(), gens[k], rtol=0, atol=0)
    for k in ("t_env", "episode", "last_target_episode"):
        assert int(getattr(ps2, k)) == counters[k]
    if not with_ring:
        assert int(ps2.episodes_in_buffer) == int(ps2.buffer_index) == 0
        assert not any(v.any() for v in ps2.ring.values())
        assert trun.resume_warmup_blocks(args2, ps2) == pipe2.warmup_blocks()
        return
    assert int(ps2.episodes_in_buffer) == counters["episodes_in_buffer"]
    assert int(ps2.buffer_index) == counters["buffer_index"]
    assert trun.resume_warmup_blocks(args2, ps2) == 0
    resumed = [float(pipe2.block(ps2, train=True)["metrics"]["loss"]) for _ in range(3)]
    assert resumed == losses


def test_resume_warmup_from_partial_ring(tmp_path):
    """A checkpoint taken mid-warm-up restores a part-filled ring; the
    resume finishes filling it before it trains."""
    pipe, ps, _, learner, args = _port(batch_size_run=2, batch_size=8)
    assert pipe.warmup_blocks() == 4  # 8 episodes, 2 a block
    pipe.block(ps, train=False)
    path = str(tmp_path / "ckpt")
    trun._save_checkpoint(path, learner, pstate=ps, include_buffer=True)
    pipe2, ps2, _, learner2, _ = _port(batch_size_run=2, batch_size=8, seed=9)
    trun.restore_pipeline_state(ps2, trun._load_checkpoint(path, learner2))
    assert int(ps2.episodes_in_buffer) == 2
    assert trun.resume_warmup_blocks(args, ps2) == 3
    for _ in range(3):
        pipe2.block(ps2, train=False)
    trun._save_checkpoint(path, learner2, pstate=ps2, include_buffer=True)
    pipe3, ps3, _, learner3, _ = _port(batch_size_run=2, batch_size=8, seed=11)
    trun.restore_pipeline_state(ps3, trun._load_checkpoint(path, learner3))
    assert trun.resume_warmup_blocks(args, ps3) == 0


def test_restored_ring_takes_the_runs_buffer_dtype(tmp_path):
    """A float32 ring restored into a run with ``buffer_dtype=bfloat16`` is
    cast to the run's storage dtype (the config decides, not the file)."""
    pipe, ps, _, learner, _ = _port(seed=0)
    pipe.block(ps, train=False)
    path = str(tmp_path / "ckpt")
    trun._save_checkpoint(path, learner, pstate=ps, include_buffer=True)
    _, ps2, _, learner2, _ = _port(seed=0, buffer_dtype="bfloat16")
    trun.restore_pipeline_state(ps2, trun._load_checkpoint(path, learner2))
    assert ps2.ring["entities"].dtype == torch.bfloat16
    for k, buf in ps2.ring.items():
        torch.testing.assert_close(buf, ps.ring[k].to(buf.dtype), rtol=0, atol=0, msg=k)


def test_find_checkpoint(tmp_path):
    root = tmp_path / "models"
    assert trun.find_checkpoint(str(root), 0) is None
    for step, state in ((100, True), (250, True), (400, True), (900, False)):
        d = root / str(step)
        d.mkdir(parents=True)
        if state:
            (d / trun.STATE_FILE).write_bytes(b"x")
    (root / "notes").mkdir()
    assert trun.find_checkpoint(str(root), 0) == (400, str(root / "400"))  # 900 has no state
    assert trun.find_checkpoint(str(root), 230)[0] == 250
    assert trun.find_checkpoint(str(root), 10_000)[0] == 400
    with pytest.raises(FileNotFoundError):
        trun.find_checkpoint(str(root / "notes"), 0)


def test_classic_checkpoint_gives_back_the_learner(tmp_path, monkeypatch):
    """The classic loop saves the learner only (as the JAX package's does):
    its last checkpoint, written after the last update, loads back the run's
    final parameters, targets and RMSprop state exactly."""
    built = []
    build = trun.build_training

    def keep(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    monkeypatch.setattr(trun, "build_training", keep)
    argv = ["--config=refil_group_matching", "--env-config=group_matching", "with", "seed=2",
            "env_args.n_agents=4", "env_args.episode_limit=10", "batch_size_run=4",
            "batch_size=4", "buffer_size=16", "test_nepisode=4", "attn_embed_dim=16",
            "hypernet_embed=16", "mixing_embed_dim=8", "training_iters=2", "t_max=200",
            "use_fused_pipeline=False", "save_model=True", "save_model_interval=100",
            "use_cuda=False", f"local_results_path={tmp_path}"]
    summary = tmain.main(argv)
    assert summary["loop"] == "classic" and summary["updates"] >= 2
    assert len(summary["saves"]) >= 2 and summary["saves"][-1]["path"].endswith(
        str(summary["t_env"]))
    learner = built[0][1]
    last = summary["saves"][-1]["path"]
    assert "pipeline" not in torch.load(os.path.join(last, trun.STATE_FILE), weights_only=True)
    cfg = tconfig.load_config(alg="refil_group_matching", env="group_matching",
                              overrides=argv[3:] + ["seed=77"])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    _, fresh, _ = trun.build_training(args, None, torch.device("cpu"))
    assert trun._load_checkpoint(last, fresh) is None
    _assert_equal(_learner_tensors(fresh), _learner_tensors(learner))
