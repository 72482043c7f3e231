"""refil_torch's CLI end to end on the CPU, its device rule, what it does
with the options that were refused before they were ported (the mesh,
multi-process runs, the scripted allies, replays and eval videos), the flat
path's pieces refused on the entity scheme, and the rule that the port
imports nothing of JAX."""
import ast
import glob
import importlib.util
import json
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
    [(got_name, cli, got_refs)] = mod.plans(mod.parse([str(tmp_path), *argv]))
    config, scenario, seed, t_max, *extra = want
    assert got_name == name
    assert cli == [f"--config={config}", "--env-config=sc2custom", "with",
                   f"scenario={scenario}", f"seed={seed}", f"t_max={t_max}", f"name={name}",
                   f"local_results_path={os.path.join(tmp_path, name)}", *extra]
    assert tmain.parse_cli(cli)[:2] == (config, "sc2custom")
    assert [os.path.basename(d) for d in got_refs.values()] == refs
    for d in got_refs.values():  # each names a committed reference run with a curve
        assert mod.curve(os.path.join(ROOT, d)), d


@pytest.mark.parametrize("argv,want", [
    (["--run", "refil:csz:0:3100000", "--run", "qmix_atten:3-8MMM_symmetric:1"],
     [("refil_csz_s0", "refil", "3-8csz_symmetric", 0, 3_100_000, ["refil_csz"]),
      ("qmix_atten_mmm_s1", "qmix_atten", "3-8MMM_symmetric", 1, 1_600_000,
       ["qmix_atten_mmm"])]),
    (["--run", "refil:mmm:1", "--run", "refil:mmm:2", "--t-max", "1600000",
      "--stop-at", "0.9", "--parallel", "2", "lr=0.001"],
     [("refil_mmm_s1", "refil", "3-8MMM_symmetric", 1, 1_600_000, ["refil_mmm"]),
      ("refil_mmm_s2", "refil", "3-8MMM_symmetric", 2, 1_600_000, ["refil_mmm"])]),
    (["--run", "refil:sz:2:1900000", "--wall-limit", "3000"],
     [("refil_sz_s2", "refil", "3-8sz_symmetric", 2, 1_900_000, ["refil_sz", "refil_sz_s1"])]),
])
def test_learning_script_plans_several_runs(tmp_path, argv, want):
    """``--run CONFIG:SET:SEED[:T_MAX]`` (SET by either name; ``--t-max``
    where T_MAX is absent), one plan a run, each with the shared overrides;
    a run that ``--stop-at`` or ``--wall-limit`` may end writes its
    preemption checkpoint without the ring (it is deleted); no run starts."""
    mod = _learning_script()
    args = mod.parse([str(tmp_path), *argv])
    got = mod.plans(args)
    extra = [a for a in argv if "=" in a]
    if args.stop_at is not None or args.wall_limit is not None:
        extra.append("preempt_save_buffer=False")
    assert [name for name, _, _ in got] == [w[0] for w in want]
    for (name, cli, refs), (_, config, scenario, seed, t_max, ref_runs) in zip(got, want):
        assert cli == [f"--config={config}", "--env-config=sc2custom", "with",
                       f"scenario={scenario}", f"seed={seed}", f"t_max={t_max}",
                       f"name={name}", f"local_results_path={os.path.join(tmp_path, name)}",
                       *extra]
        assert tmain.parse_cli(cli)[:2] == (config, "sc2custom")
        assert [os.path.basename(d) for d in refs.values()] == ref_runs
    assert args.parallel == (2 if "--parallel" in argv else 0)


@pytest.mark.parametrize("argv", [["--run", "refil:sz"], ["--run", "refil:sz:0", "--run",
                                                         "refil:3-8sz_symmetric:0"]])
def test_learning_script_refuses_bad_runs(tmp_path, argv):
    """A ``--run`` without a seed, or two runs of one name, stop the script
    before any run starts."""
    mod = _learning_script()
    with pytest.raises(SystemExit):
        mod.plans(mod.parse([str(tmp_path), *argv]))


def test_learning_script_cards_and_sharing(monkeypatch):
    """Several cards: a starting run takes the first card the fewest running
    runs hold; one card: every run shares it; no nvidia-smi: None. Runs on
    one card whose spans overlap shared it for the overlap's seconds."""
    mod = _learning_script()
    four = [(str(i), "NVIDIA H100 80GB HBM3, 700.00 W") for i in range(4)]
    held = []
    for _ in range(6):
        held.append(mod.pick_card(four, held))
    assert held == ["0", "1", "2", "3", "0", "1"]
    assert mod.pick_card(four[:1], ["0", "0"]) == "0"
    assert mod.pick_card([], []) is None
    spans = {"a": ("0", 0.0, 100.0), "b": ("0", 40.0, 70.0), "c": ("1", 0.0, 100.0),
             "d": ("0", 100.0, 150.0)}
    assert mod.overlaps(spans) == {"a": {"b": 30.0}, "b": {"a": 30.0}, "c": {}, "d": {}}
    # the visible cards are the ones CUDA_VISIBLE_DEVICES names
    monkeypatch.setattr(mod.shutil, "which", lambda _: "/bin/nvidia-smi")
    monkeypatch.setattr(mod.subprocess, "run", lambda *a, **k: type(
        "R", (), {"stdout": "".join(f"{i}, {n}\n" for i, n in four)})())
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    assert mod.cards() == [four[1], four[3]]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert mod.cards() == four


def _verdict_script():
    spec = importlib.util.spec_from_file_location(
        "combat_curves_verdict", os.path.join(ROOT, "scripts", "combat_curves_verdict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("port,ref,want", [
    # every 0.5 within 2x, the 0.9 median within 1.5x
    ([(500, 1000), (600, 1400)], (400, 900), "variance"),
    # a seed that never reaches 0.9 counts as its last t_env: the median
    # 1,300 is over 1.5 x 800, and 800 lies outside 950-1,650 ...
    ([(500, 1000), (600, None)], (400, 800), "fault"),
    # ... but 1,000 lies inside 910-1,650, though the median 1,600 is over 1,500
    ([(500, 960), (600, None), (550, None)], (400, 1000), "variance"),
    # a 0.5 later than twice the reference's, or never
    ([(900, 1000)], (400, 900), "fault"),
    ([(None, None)], (400, 900), "fault"),
])
def test_combat_verdict_rule(port, ref, want):
    """``scripts/combat_curves_verdict.py``'s rule on made-up crossings in
    thousands of env steps (each port run's last t_env 1,600k)."""
    mod = _verdict_script()
    cross = lambda a, b: {"ge_0.5": a and a * 1000, "ge_0.9": b and b * 1000}  # noqa: E731
    got = mod.verdict({s: (cross(*v), 1_600_000) for s, v in enumerate(port)},
                      {0: cross(*ref)})
    assert got["verdict"] == want, got


def test_combat_verdict_reads_the_committed_runs(capsys):
    """The script over ``results/torch_runs``: one line a set that has both
    port and reference REFIL runs, each seed's crossings the learning
    script's, the ratio at 0.5 QMIX-atten's over REFIL's."""
    mod = _verdict_script()
    mod.main([])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {r["set"] for r in rows} == {"3-8sz_symmetric", "3-8MMM_symmetric",
                                        "3-8csz_symmetric"}
    runs = os.path.join(ROOT, "results", "torch_runs")
    for r in rows:
        short = mod.SETS[r["set"]]
        for seed, c in r["refil_seeds"].items():
            want = mod.crossings(mod.curve(os.path.join(runs, f"refil_{short}_s{seed}")))
            assert c == want
        for seed, ratio in r["ratio_0.5"].items():
            assert ratio == (r["qmix_atten_seeds"][seed]["ge_0.5"]
                             / r["refil_seeds"][seed]["ge_0.5"])
        assert r["verdict"] in ("variance", "fault")


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


# the port's own options, which the JAX package has no counterpart of:
# trace_blocks switches the fused pipeline's device stamps (core/pipeline.py)
PORT_ONLY_KEYS = {"trace_blocks"}


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
        port_keys = set(tload(alg, env))
        assert PORT_ONLY_KEYS <= port_keys
        assert port_keys - PORT_ONLY_KEYS == set(jload(alg, env))
