"""The flat path's command line on the CPU, at narrow widths and a short
episode limit: ``python -m refil_torch.main --config=qmix --env-config=sc2``
trains through the fused loop (the default) and the classic loop, under the
env's two names, with the ``vdn`` mixer, and with the ``multinomial``
selector over ``pi_logits``;
the ring carries the flat scheme's ``obs`` and ``state`` planes; a flat run
saves, resumes and is evaluated."""
import json
import math
import os

import pytest
import torch

from refil_torch import config as tconfig
from refil_torch import main as tmain
from refil_torch import run as trun
from refil_torch.core.pipeline import FusedPipeline

TINY = ["rnn_hidden_dim=16", "hypernet_embed=16", "mixing_embed_dim=8", "batch_size_run=4",
        "batch_size=4", "training_iters=2", "test_nepisode=4", "env_args.episode_limit=12",
        "t_max=100", "use_cuda=False"]


@pytest.mark.parametrize("env,extra", [
    ("sc2", []), ("sc2", ["use_fused_pipeline=False"]),
    ("sc2", ["mixer=vdn", "use_fused_pipeline=False"]),
    ("flat_battle", ["action_selector=multinomial", "agent_output_type=pi_logits",
                     "use_fused_pipeline=False"])])
def test_cli_trains_flat_on_cpu(tmp_path, env, extra):
    summary = tmain.main(["--config=qmix", f"--env-config={env}", "with", *TINY, *extra,
                          f"local_results_path={tmp_path}"])
    assert summary["device"] == "cpu" and summary["episode_limit"] == 12
    assert summary["loop"] == ("classic" if extra else "fused")
    assert summary["updates"] >= 1 and summary["iterations"] == 2 * summary["updates"]
    assert math.isfinite(summary["last_metrics"]["loss"])
    assert summary["params_max_abs_change"] > 0 and summary["test_blocks"] >= 1
    for k in ("battle_won_mean", "test_battle_won_mean", "win_rate"):
        assert k in summary["last_logged"], k


def test_flat_ring_planes_and_masks():
    cfg = tconfig.load_config(alg="qmix", env="sc2", overrides=TINY)
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, learner, gens = trun.build_training(args, None, torch.device("cpu"))
    S = runner.env.get_state_size()
    assert not args.entity_scheme and args.state_masks.shape == (6, S)
    assert learner.mixer.hypernet_layers == 2 and learner.mixer.state_masks is not None
    pipe = FusedPipeline(runner, learner, args.buffer_size, args)
    ps = pipe.init_state(gens["sample"])
    assert set(ps.ring) == {"obs", "state", "avail_actions", "actions", "actions_onehot",
                            "reward", "terminated", "filled"}
    assert ps.ring["state"].shape == (args.buffer_size, 13, S)
    pipe.run_blocks(ps, 1, train=False)
    stats = pipe.block(ps, train=True)
    assert math.isfinite(float(stats["metrics"]["loss"]))
    assert float(ps.ring["state"][:4].abs().sum()) > 0


def test_flat_checkpoint_resume_and_eval(tmp_path):
    """A flat fused run saves (ring included), a resume from it trains at
    once, and an eval-only run of it over the map's one scenario writes its
    test stats."""
    def cli(*extra):
        return tmain.main(["--config=qmix", "--env-config=sc2", "with", *TINY,
                           f"local_results_path={tmp_path}", *extra])

    first = cli("save_model=True", "save_model_interval=50", "checkpoint_buffer=True")
    (token,) = os.listdir(os.path.join(tmp_path, "models"))
    ckpt = os.path.join(tmp_path, "models", token)
    assert first["saves"]
    resumed = cli(f"checkpoint_path={ckpt}", "t_max=200")
    assert resumed["restored"]["t_env"] > 0 and resumed["dispatches"][0]["train"]
    out = os.path.join(tmp_path, "eval.json")
    ev = cli("evaluate=True", "eval_all_scen=True", f"checkpoint_path={ckpt}",
             f"eval_path={out}")
    assert ev["loop"] == "evaluate"
    with open(out) as f:
        res = json.load(f)
    assert list(res) == ["3m"] and "test_battle_won_mean" in res["3m"]
