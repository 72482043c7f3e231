"""refil_torch's CLI end to end on the CPU, its device rule, what it does
with the options that were refused before they were ported (the mesh,
multi-process runs, the scripted allies, replays and eval videos), the flat
path's pieces refused on the entity scheme, and the rule that the port
imports nothing of JAX."""
import ast
import glob
import importlib.util
import math
import os

import pytest
import torch

from refil_torch import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["attn_embed_dim=16", "hypernet_embed=16", "mixing_embed_dim=8", "attn_n_heads=2",
        "rnn_hidden_dim=16", "batch_size_run=4", "batch_size=4", "training_iters=2",
        "test_nepisode=4", "env_args.episode_limit=10", "t_max=60"]


def _cli(tmp_path, alg, *extra):
    return ["--config=" + alg, "--env-config=group_matching", "with", *TINY,
            f"local_results_path={tmp_path}", *extra]


@pytest.mark.parametrize("alg", ["refil_group_matching", "qmix_atten_group_matching"])
def test_cli_trains_on_cpu(tmp_path, alg):
    summary = tmain.main(_cli(tmp_path, alg, "use_cuda=False"))
    assert summary["device"] == "cpu"
    assert summary["updates"] >= 1 and summary["iterations"] == 2 * summary["updates"]
    assert math.isfinite(summary["last_metrics"]["loss"])
    assert summary["t_env"] > 60 and summary["test_blocks"] >= 1
    metrics = glob.glob(os.path.join(tmp_path, "metrics", "*.jsonl"))
    assert len(metrics) == 1 and os.path.getsize(metrics[0]) > 0


# (config, env config, scenario set): the slice-2 command, refil on
# entity_battle 3-8sz_symmetric, and every other combat configuration the
# JAX package ships, under sc2custom as the learning runs take them
COMBAT_CONFIGS = [("refil", "entity_battle", "3-8sz_symmetric"),
                  ("qmix_atten", "sc2custom", "3-8sz_symmetric"),
                  ("vdn_atten", "sc2custom", "3-8sz_symmetric"),
                  ("refil_vdn", "sc2custom", "3-8sz_symmetric"),
                  ("refil", "sc2custom", "3-8MMM_symmetric"),
                  ("refil", "sc2custom", "3-8csz_symmetric")]


@pytest.mark.parametrize("alg,env,scenario", COMBAT_CONFIGS)
def test_cli_trains_combat_on_cpu(tmp_path, alg, env, scenario):
    """Each combat configuration through the CLI at narrow widths and a
    short episode limit."""
    argv = [f"--config={alg}", f"--env-config={env}", "with", f"scenario={scenario}",
            *TINY, "use_cuda=False", f"local_results_path={tmp_path}"]
    summary = tmain.main(argv)
    assert summary["device"] == "cpu" and summary["episode_limit"] == 10
    assert summary["updates"] >= 1 and summary["iterations"] == 2 * summary["updates"]
    assert math.isfinite(summary["last_metrics"]["loss"])
    assert summary["params_max_abs_change"] > 0
    # the runner accounts the env's final-info keys and its battle stats
    for k in ("battle_won_mean", "episode_limit_mean", "test_battle_won_mean", "win_rate"):
        assert k in summary["last_logged"], k


def _learning_script():
    spec = importlib.util.spec_from_file_location(
        "learning_runs_torch_combat", os.path.join(ROOT, "scripts", "learning_runs_torch_combat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv,want,name,refs", [
    ([], ("refil", "3-8sz_symmetric", 0, 1_600_000), "refil_sz_s0", ["refil_sz", "refil_sz_s1"]),
    (["--config", "qmix_atten", "--t-max", "3800000"],
     ("qmix_atten", "3-8sz_symmetric", 0, 3_800_000), "qmix_atten_sz_s0",
     ["qmix_atten_sz", "qmix_atten_sz_s1"]),
    (["--config", "qmix_atten", "--scenario", "3-8MMM_symmetric"],
     ("qmix_atten", "3-8MMM_symmetric", 0, 1_600_000), "qmix_atten_mmm_s0", ["qmix_atten_mmm"]),
    (["--scenario", "3-8csz_symmetric", "--seed", "1", "lr=0.001"],
     ("refil", "3-8csz_symmetric", 1, 1_600_000, "lr=0.001"), "refil_csz_s1", ["refil_csz"]),
    (["--config", "vdn_atten"], ("vdn_atten", "3-8sz_symmetric", 0, 1_600_000),
     "vdn_atten_sz_s0", []),
])
def test_learning_script_maps_its_arguments(tmp_path, argv, want, name, refs):
    """``scripts/learning_runs_torch_combat.py``'s arguments to the CLI's
    argv (the shipped config under sc2custom, only scenario, seed and t_max
    set, then the extra overrides), the run's name and the reference runs
    (every seed of the config and set in results/r5_runs); no run starts."""
    mod = _learning_script()
    got_name, cli, got_refs = mod.plan(mod.parse([str(tmp_path), *argv]))
    config, scenario, seed, t_max, *extra = want
    assert got_name == name
    assert cli == [f"--config={config}", "--env-config=sc2custom", "with",
                   f"scenario={scenario}", f"seed={seed}", f"t_max={t_max}", f"name={name}",
                   f"local_results_path={os.path.join(tmp_path, name)}", *extra]
    assert tmain.parse_cli(cli)[:2] == (config, "sc2custom")
    assert [os.path.basename(d) for d in got_refs.values()] == refs
    for d in got_refs.values():  # each names a committed reference run with a curve
        assert mod.curve(os.path.join(ROOT, d)), d


def test_cli_with_use_cuda_and_no_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_cuda"):
        tmain.main(_cli(tmp_path, "refil_group_matching", "use_cuda=True"))


@pytest.mark.parametrize("extra", ["mesh_shape={'data':2}", "distributed=True", "agent=rnn",
                                   "mixer=qmix", "env=flat_battle", "env=sc2",
                                   "heuristic_ai=True", "save_replay=True",
                                   ("evaluate=True", "video_path=eval.mp4")])
def test_unported_features_raise(tmp_path, monkeypatch, extra):
    """Once refused, now ported, each option on Group Matching does what the
    JAX package does with it:
    * ``mesh_shape={'data':2}`` in one process: a ValueError (the mesh needs
      2 processes);
    * ``distributed=True`` with torchrun's variables for a world of one:
      trains over gloo and leaves no process group behind;
    * ``heuristic_ai``: trains (the env has no scripted policy);
    * ``save_replay`` without a checkpoint, ``evaluate`` and ``video_path``
      without one: train, writing no replay and no video (the eval branch
      needs a checkpoint, and Group Matching renders nothing).
    The flat path's agent, mixer and env in the entity-scheme config are a
    scheme mismatch, refused with a ValueError."""
    argv = _cli(tmp_path, "refil_group_matching", "use_cuda=False",
                *((extra,) if isinstance(extra, str) else extra))
    if extra in FLAT_ON_ENTITY_SCHEME:
        with pytest.raises(ValueError):
            tmain.main(argv)
        return
    if extra == "mesh_shape={'data':2}":
        with pytest.raises(ValueError, match="needs 2 processes"):
            tmain.main(argv)
        return
    if extra == "distributed=True":
        from refil_torch.parallel.gate import free_port

        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(free_port())),
                     ("WORLD_SIZE", "1"), ("RANK", "0")):
            monkeypatch.setenv(k, v)
    summary = tmain.main(argv)
    assert summary["loop"] == "fused" and summary["updates"] >= 1
    assert math.isfinite(summary["last_metrics"]["loss"])
    assert summary["world_size"] == 1 and not torch.distributed.is_initialized()
    assert not os.path.exists(os.path.join(tmp_path, "replays"))
    assert not glob.glob(os.path.join(tmp_path, "**", "eval*"), recursive=True)


FLAT_ON_ENTITY_SCHEME = ("agent=rnn", "mixer=qmix", "env=flat_battle", "env=sc2")


def test_cli_parse_matches_reference():
    from refil_tpu.main import parse_cli as jparse

    argv = ["--config=refil", "--env-config=group_matching", "with", "lr=0.1", "seed=3"]
    assert tmain.parse_cli(argv) == jparse(argv)
    with pytest.raises(SystemExit):
        tmain.parse_cli(["bogus"])


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = glob.glob(os.path.join(ROOT, "refil_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    banned = ("jax", "flax", "optax", "refil_tpu", "jaxlib", "chex")
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)


def test_port_config_files_mirror_the_reference():
    ref = sorted(os.path.relpath(p, os.path.join(ROOT, "refil_tpu", "config"))
                 for p in glob.glob(os.path.join(ROOT, "refil_tpu", "config", "**", "*.yaml"),
                                    recursive=True))
    port = sorted(os.path.relpath(p, os.path.join(ROOT, "refil_torch", "config"))
                  for p in glob.glob(os.path.join(ROOT, "refil_torch", "config", "**", "*.yaml"),
                                     recursive=True))
    assert port == ref
    from refil_torch.config import load_config as tload
    from refil_tpu.config import load_config as jload

    for alg, env in (("refil_group_matching", "group_matching"),
                     ("qmix_atten_group_matching", "group_matching"), ("refil", "entity_battle")):
        assert set(tload(alg, env)) == set(jload(alg, env))
