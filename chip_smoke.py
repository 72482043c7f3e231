"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no training

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for matmuls and cuDNN, so the plain versions are true float32.
  2. build: nvcc builds every ``refil_torch/csrc/*.cu`` for sm_90a from the
     sources in this checkout, one nvcc each, all at once; prints the build
     time and ptxas's registers and shared memory per kernel; then the launch
     plans of the attention calls and of the GRU forward.
  3. kernels: each kernel against its plain PyTorch version on the card, in
     float32 and bfloat16: the entity-attention forward and backward at every
     shape of the Group Matching slice and of the combat slice (a rollout
     step's at each width the slices' configs give a rollout: batch_size_run,
     the fused loop's one test rollout of all of test_nepisode and the eval
     phase's rollout of the combat config's own test_nepisode, and each
     scale run's (phase 13: Bp 512 and 4,096 at the combat widths, 4,096 at
     Group Matching's; the GRU at T 1, R 4,096 and 32,768); plus an
     Nq < Ne case with a fully blocked row, a post-masked row, no pre-mask,
     and batches that are not a multiple of the block's samples, one of them
     at the combat widths; and REFIL's own Group Matching pre-masks, the
     imagined groups' and the ground-truth groups', from
     ``build_imagine_masks``; and REFIL's square imagined pre-masks at the
     combat learner's shapes (the agent x3 call and both imagined hypernet
     calls) from rollouts of 3-8MMM_symmetric and 3-8csz_symmetric in which
     units die, each row with the rollout's dead share and its
     ``blocked_row_share`` (``combat_imagined_masks`` lines)), each also
     held to the plain version of its
     stages (``entity_attention_forward_staged``,
     ``entity_attention_backward_staged``) and called twice for identical
     bits; the GRU forward and backward at every shape of the combat slice,
     a ragged one, at every shape of the flat slice on 3m and on the
     widest map, 27m_vs_30m (its learner's whole episodes, its rollout's
     steps and its fused test rollout's, from ``config/algs/qmix.yaml`` and
     ``config/envs/sc2.yaml``), and a sweep of R and T across the
     rows-per-block plans,
     the backward also held to the plain version of its stages
     (``gru_backward_staged``) and called twice for identical bits; the
     attention's matrix product alone at the shapes both directions give it
     (the forward's output product with its bias, post-mask and bfloat16
     store) and at ragged ones. Times by CUDA events after warm-up: the
     kernel, the plain version and a PyTorch yardstick (attention: matmul +
     scaled_dot_product_attention; GRU: ``torch.nn.GRU`` in the kernel's
     dtype, or, where PyTorch refuses that dtype, the refusal's text and
     the float32 call, beside the hoisted input matmul plus the kernel),
     beside the least time the card could take (``bound_ms``). The calls
     of phase 4b's configurations, derived from their configs, are added
     where no row above has their shape (``config_shapes``).
  3b. combat_env: the combat env's step and observation kernels
     (``ops/combat_env.py``) against the env's op path on the card, every
     state, observation, reward, done and info tensor equal bit for bit over
     40 steps of random legal actions (``COMBAT_ENV_CASES``: 3-8sz at tier 7
     and B 8 and 4096, 3-8MMM at tier A, 3-8csz at tier 1, 3-8sz at tier 4,
     each B 37, and the flat env's walled corridor); then each kernel's
     device time a step at B 8 and 4096 beside its bytes bound and the op
     path's device time (``combat_env_time`` lines).
  4. fused slices, the default loop: ``refil_torch.main`` trains
     refil_group_matching (>= 8 learner updates), the flagship refil on
     entity_battle 3-8sz_symmetric at the config's full width (>= 2
     dispatches of >= 2 train blocks) and qmix on the flat env sc2 3m at
     its full width (``flat``: RNNAgent on the GRU kernels, QMixer), each
     block after the first of its kind a CUDA graph replay; prints
     env-steps/s (and over the replayed train blocks alone, the eager first
     one timed apart), the dispatches, the last
     metrics (combat: with battle_won_mean) and each graph's capture and
     instantiate seconds and pool size (``graphs`` lines); checks the
     kernels' launch counts (the counts, plus each graph's recorded
     launches times its replays less the capture's one count) against the
     counts the run's shapes imply, and that every later block of a kind
     was a replay of one recorded block's launches.
  4b. configs: every other combat configuration the JAX package ships
     (``CONFIG_RUNS``), each through ``refil_torch.main`` at full width in
     the fused loop under sc2custom: qmix_atten, vdn_atten and refil_vdn on
     3-8sz_symmetric, refil on 3-8MMM_symmetric and 3-8csz_symmetric; each
     >= 2 dispatches of >= 2 replayed train blocks, checked as phase 4's
     runs, and every logged loss and grad_norm finite; prints env-steps/s,
     seconds a replayed block, the train graph's pool and capture seconds;
     then phase 6's graph-versus-eager pair for qmix_atten (FlexQMixer's
     plain path, captured nowhere else); and the phase's seconds.
  5. classic slices: the same three configurations with
     ``use_fused_pipeline=False``, launch counts checked the same way.
  6. graph_vs_eager: one eager combat train block under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); then from
     one cloned state and cloned generator states one train block eagerly
     and one as a replay: ring planes and counters equal, parameters,
     targets and optimiser state within 1e-4 of max(1, |p|); two replays
     draw different actions. Then restore in place: a checkpoint of the
     live state (ring included) restored after another replay keeps every
     tensor's storage and gives back the saved values and generator states
     exactly, and one replay from it equals one eager block from it (same
     gate; the generators' states after each equal).
  7. resume: a fused combat run A saves (``save_model``, with the ring)
     and run B resumes from A's first checkpoint after a dispatch of
     replays to the same t_max: B's first block trains and every loss B
     logs equals A's at the same t_env within 1e-5 of max(1, |loss|); the
     checkpoint's bytes and save and load seconds.
  8. preempt: the CLI as a subprocess at its default dispatch size,
     SIGTERM after its first logged loss: exit 0, the preemption line, a
     checkpoint, and a resume from it that trains at once and logs past
     it; the subprocess's log tail printed where a check fails.
  9. eval: an eval-only run of A's checkpoint over every scenario of
     3-8sz_symmetric at the config's 160 test episodes a scenario: its
     stats, seconds a scenario and launches (the attention at Bp 160 and
     the GRU at T 1, R 1,280 are among phase 3's shapes).
  10. heuristic: ``heuristic_actions`` on the card against the port's on
     the CPU for the same states (a CPU rollout of 20 steps of 256 envs
     driven by the CPU heuristic; 3-8MMM_symmetric, whose Medivacs heal,
     and 3-8sz_symmetric; both ``heuristic_rest`` modes), integer-equal,
     each card call under ``set_sync_debug_mode("error")``; then phase 4's
     fused combat run, logging every block, with ``env_args.heuristic_ai``
     and without it: each run's env-steps/s, seconds a replayed train
     block and win share, launch counts checked as the slice's.
  11. record: an eval-only run of run A's checkpoint (one rollout of 160
     envs) with ``save_replay``, and ``video_path`` where matplotlib and
     imageio import (else ``"video": null`` with the import errors): the
     replay's keys are the JAX package's, one frame a step, and frame 0's
     positions equal the eval's reset state (rebuilt from the test
     generator's seed) stepped once with the restored agent's greedy
     actions; a video that fails to write fails the phase.
  12. distributed: a fused combat run as one NCCL process
     (``distributed=True``, world size 1, the sharded ring's path with its
     collectives captured in the graphs) against the undistributed run,
     both saving a checkpoint with the ring: every logged loss within 1e-5
     of max(1, |loss|); the graphs' recorded collectives: a block's stats
     all_gather (fewer bytes than one episode: no episode plane), the
     sample's reduce_scatter once a train block, the mask counts'
     all_reduce and one an update; the rank's ring bytes and episodes
     against the undistributed run's; the mesh run's last checkpoint
     restored into an undistributed pipeline, whose ring then equals the
     undistributed run's bit for bit; both runs' env-steps/s and replayed
     seconds a block.
  13. scale: the JAX package's own throughput configurations (bench.py)
     through ``refil_torch.main`` at full width in the fused loop, each in
     this process: refil_group_matching at batch_size_run 4096 (float32),
     refil on 3-8sz_symmetric under sc2custom in bfloat16 at B 512 and 4096
     (``SCALE_RUNS``), each >= 2 dispatches of >= 2 replayed train blocks
     and B-wide test rollouts; checked as phase 4's runs, and every logged
     loss and grad_norm finite; prints env-steps/s, seconds a replayed
     block, dispatches, test rollouts, graphs, ring bytes and peak device
     memory; then phase 6's graph-versus-eager pair at B 512 in bfloat16;
     and the phase's seconds.
  14. own kernels, last (once torch.profiler has run in a process, its
     later launches are slower): a profile of one attention forward, one
     attention backward and one GRU backward call, which must run only the
     repository's kernels; then one replay of the combat train block under
     the profiler: its attention and GRU launches, counted by a kernel only
     each launch runs, are the ones its capture recorded, and no library
     attention or recurrence kernel (SDPA, flash, cuDNN) runs in it.
  15. the ``kernels`` line (launches from the fused combat run, with the
     fused Group Matching and flat runs' and each config and scale run's
     beside them)
     and the last line
     ``{"ok": true, "device": ...}``.

Each phase that drives a path (4, each run of 4b and its pair, 5, 6, both
runs of 7, 8's resume, 9, the runs of 10, 11 and 12, and each run of 13
and its pair)
sets the launch counts to 0 just before it and reads them just after (8's
preempted run is another process, whose counts this one cannot read). It exits non-zero, printing no result, where CUDA
is not available or the ``refil_torch`` package is not beside it.
"""
from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_RESULTS = os.path.join(HERE, "results", "torch_smoke")

# the card's peaks used for bound_ms (H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {"fwd": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
       "bwd": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}

HEADS = 4
# (slice, name, Bp, Ne, Nq, pre-mask rows, width): every entity-attention call
# of one learner update. Group Matching (refil_group_matching): Ne = Nq = 8,
# D = E = O = 64. Combat (refil on 3-8sz_symmetric: batch 32 of 151 steps, 8
# agents and 8 enemies): Ne = 16, Nq = 8, D = E = O = 128; the agents'
# pre-masks are square (Ne rows), the hypernets' Na rows, their imagined
# masks square. ``attn_shapes`` adds the rollouts' calls.
ATTN_LEARNER_SHAPES = [
    ("group_matching", "agent_x3", 4896, 8, 8, 8, 64),
    ("group_matching", "target_agent", 1632, 8, 8, 8, 64),
    ("group_matching", "mixer", 1600, 8, 8, 8, 64),
    ("combat", "agent_x3", 14496, 16, 8, 16, 128),
    ("combat", "target_agent", 4832, 16, 8, 16, 128),
    ("combat", "mixer", 4800, 16, 8, 8, 128),
    ("combat", "mixer_imagined", 4800, 16, 8, 16, 128),
    ("combat", "target_mixer", 4832, 16, 8, 8, 128),
]
# a rollout step's agent call: (Ne, Nq, pre-mask rows, width, GRU rows an
# env; None where the agent has no GRU), Bp = the rollout's envs
ROLLOUT_CALL = {"group_matching": (8, 8, 8, 64, None), "combat": (16, 8, 16, 128, 8)}
# (name, T, R): every GRU call of a combat learner update (H = 64): the agent
# x3 and the target agent over whole episodes; and a ragged one.
# ``gru_shapes`` adds the rollouts' steps.
GRU_HIDDEN = 64
GRU_LEARNER_SHAPES = [("agent_x3", 151, 768), ("target_agent", 151, 256), ("ragged", 13, 37)]
# the forward's rows-per-block plan picks 1, 2, 4 or 8 rows by R: a sweep
# across it, at every T the slice uses and a ragged one
GRU_PLAN_ROWS = (1, 37, 64, 256, 768, 1000)
GRU_PLAN_STEPS = (1, 13, 151)


# the flat slice (qmix on sc2): its map, and the widest map of MAP_REGISTRY,
# whose GRU shapes are held to the plain version too
FLAT_MAPS = ("3m", "27m_vs_30m")


def flat_gru_shapes():
    """(name, T, R) of every GRU call of the flat slice on each of FLAT_MAPS,
    from its configs: the learner's whole episodes (live and target agent,
    T = episode_limit + 1, R = batch_size x agents), a training rollout's
    step (R = batch_size_run x agents) and the fused loop's test rollout's
    (all of test_nepisode in one rollout)."""
    from refil_torch.config import args_sanity_check, load_config
    from refil_torch.envs.combat.flat_env import MAP_REGISTRY

    rows = []
    for name in FLAT_MAPS:
        cfg = args_sanity_check(load_config(alg="qmix", env="sc2",
                                            overrides=[f"env_args.map_name={name}"]))
        ally, _, limit = MAP_REGISTRY[name]
        na = sum(n for n, _ in ally)
        bsr = cfg["batch_size_run"]
        n_test = max(1, cfg["test_nepisode"] // bsr) * bsr
        rows += [(f"{name}_learner", limit + 1, cfg["batch_size"] * na),
                 (f"{name}_rollout", 1, bsr * na)]
        if n_test != bsr:
            rows.append((f"{name}_test_rollout", 1, n_test * na))
    return rows


def slice_argv(path, fused):
    """The command line of a slice phase (the fused loop is the default)."""
    if path == "group_matching":
        argv = ["--config=refil_group_matching", "--env-config=group_matching", "with",
                f"t_max={GM_T_MAX}"]
    elif path == "flat":
        argv = ["--config=qmix", "--env-config=sc2", "with", f"t_max={FLAT_T_MAX}"]
    else:
        argv = ["--config=refil", "--env-config=entity_battle", "with",
                "scenario=3-8sz_symmetric", "test_nepisode=8",
                f"t_max={CB_FUSED_T_MAX if fused else CB_T_MAX}"]
    if not fused:
        argv.append("use_fused_pipeline=False")
    return argv + ["use_cuda=True", f"local_results_path={SMOKE_RESULTS}"]


# The JAX package's own throughput configurations (bench.py), trained
# through the port's CLI at full width in the fused loop: Group Matching at
# batch_size_run 4096 with the ring grown to B (bench.py:39-41), in float32;
# the flagship refil on 3-8sz_symmetric under sc2custom, the env config
# bench.py:_build_combat loads, in bfloat16 at B 512 and 4096 with the ring
# max(5000, 2 B) (bench.py:190; 5,000 rounds up to 5,120 at B 512).
SCALE_RUNS = {
    "gm_b4096": ("group_matching", [
        "--config=refil_group_matching", "--env-config=group_matching", "with",
        "batch_size_run=4096", "buffer_size=4096"]),
    "combat_b512_bf16": ("combat", [
        "--config=refil", "--env-config=sc2custom", "with", "scenario=3-8sz_symmetric",
        "batch_size_run=512", "compute_dtype=bfloat16", "buffer_size=5000"]),
    "combat_b4096_bf16": ("combat", [
        "--config=refil", "--env-config=sc2custom", "with", "scenario=3-8sz_symmetric",
        "batch_size_run=4096", "compute_dtype=bfloat16", "buffer_size=8192"]),
}
# t_max = SCALE_BLOCKS x B x episode_limit env steps: after the one warm-up
# block (B > batch_size), >= 2 dispatches of >= 2 replayed train blocks
# whatever the episodes' lengths; test_interval half of it, so a B-wide test
# rollout (test_nepisode < B) runs after the warm-up block and once more
SCALE_BLOCKS = 9


def blocks_t_max(argv, blocks):
    """``blocks`` full blocks of env steps under ``argv``: blocks x
    batch_size_run x episode_limit."""
    from refil_torch.config import load_config
    from refil_torch.main import parse_cli

    alg, env, overrides = parse_cli(argv)
    cfg = load_config(alg=alg, env=env, overrides=overrides)
    return blocks * cfg["batch_size_run"] * cfg["env_args"]["episode_limit"]


def scale_argv(name):
    """The command line of a scale run, its t_max and test_interval from
    its config's batch_size_run and episode_limit."""
    argv = SCALE_RUNS[name][1]
    t_max = blocks_t_max(argv, SCALE_BLOCKS)
    return [*argv, f"t_max={t_max}", f"test_interval={t_max // 2}", "use_cuda=True",
            f"local_results_path={os.path.join(SMOKE_RESULTS, name)}"]


# Every other combat configuration the JAX package ships (phase 4b), each
# through the port's CLI at full width in the fused loop under sc2custom, as
# the learning runs take it: qmix_atten (the agent without imagination,
# FlexQMixer's plain path), vdn_atten (VDNMixer) and refil_vdn (REFIL's
# imagined loss through VDNMixer) on 3-8sz_symmetric, and refil on the
# 3-8MMM_symmetric and 3-8csz_symmetric sets. Each value: (the key of its
# launch counts in PER_ITER, its command line).
CONFIG_RUNS = {
    "qmix_atten_sz": ("qmix_atten", ["--config=qmix_atten", "--env-config=sc2custom", "with",
                                     "scenario=3-8sz_symmetric"]),
    "vdn_atten_sz": ("vdn_atten", ["--config=vdn_atten", "--env-config=sc2custom", "with",
                                   "scenario=3-8sz_symmetric"]),
    "refil_vdn_sz": ("refil_vdn", ["--config=refil_vdn", "--env-config=sc2custom", "with",
                                   "scenario=3-8sz_symmetric"]),
    "refil_mmm": ("combat", ["--config=refil", "--env-config=sc2custom", "with",
                             "scenario=3-8MMM_symmetric"]),
    "refil_csz": ("combat", ["--config=refil", "--env-config=sc2custom", "with",
                             "scenario=3-8csz_symmetric"]),
}
# t_max = CONFIG_BLOCKS x batch_size_run x episode_limit env steps: after
# the 4 warm-up blocks (batch_size 32 of batch_size_run 8) the first train
# dispatch holds >= 4 blocks (the eager first, the captured one and >= 2
# replays) and the next >= 2 replays, whatever the episodes' lengths
CONFIG_BLOCKS = 10


def config_argv(name):
    """The command line of a CONFIG_RUNS run, its t_max from its config's
    batch_size_run and episode_limit."""
    argv = CONFIG_RUNS[name][1]
    return [*argv, f"t_max={blocks_t_max(argv, CONFIG_BLOCKS)}", "use_cuda=True",
            f"local_results_path={os.path.join(SMOKE_RESULTS, name)}"]


def config_calls(name):
    """Every entity-attention call ((tag, Bp, Ne, Nq, pre-mask rows, width))
    and GRU call ((tag, T, R)) of a CONFIG_RUNS run, from its config and its
    env's sizes: the live agent over the sampled episodes (x3 where it
    imagines), the target agent, FlexQMixer's hypernets on the trained steps
    (Na-row pre-masks; square on the imagined path) and the target mixer's
    on all of them (VDNMixer calls none), and a rollout step at each width
    the fused loop rolls out."""
    from refil_torch.config import args_sanity_check, config_to_args, load_config
    from refil_torch.main import parse_cli
    from refil_torch.run import build_env

    argv = config_argv(name)
    alg, env, overrides = parse_cli(argv)
    args = config_to_args(args_sanity_check(load_config(alg=alg, env=env,
                                                        overrides=overrides)))
    info = build_env(args, torch.device("cpu")).env_info()
    na, ne, steps = info["n_agents"], info["n_entities"], info["episode_limit"]
    bs, x = args.batch_size, 3 if "imagine" in args.agent else 1
    w = args.attn_embed_dim
    attn = [("agent", x * bs * (steps + 1), ne, na, ne, w),
            ("target_agent", bs * (steps + 1), ne, na, ne, w)]
    gru = [("agent", steps + 1, x * bs * na), ("target_agent", steps + 1, bs * na)]
    if args.mixer == "flex_qmix":
        hw = args.hypernet_embed
        attn += [("mixer", bs * steps, ne, na, na, hw),
                 ("target_mixer", bs * (steps + 1), ne, na, na, hw)]
        if x == 3:
            attn.append(("mixer_imagined", bs * steps, ne, na, ne, hw))
    for tag, envs in fused_widths(argv).items():
        attn.append((tag, envs, ne, na, ne, w))
        gru.append((tag, 1, envs * na))
    return attn, gru


def config_shapes(attn_rows, gru_rows):
    """The calls of every CONFIG_RUNS run that ``attn_rows`` and ``gru_rows``
    (phase 3's) do not already hold, by shape; prints every run's calls and
    the new ones (``config_shapes``)."""
    have_a = {tuple(r[2:]) for r in attn_rows}
    have_g = {tuple(r[1:]) for r in gru_rows}
    new_a, new_g, calls = [], [], {}
    for name in CONFIG_RUNS:
        attn, gru = config_calls(name)
        calls[name] = {"attention": attn, "gru": gru}
        for tag, *shape in attn:
            if tuple(shape) not in have_a:
                have_a.add(tuple(shape))
                new_a.append((name, tag, *shape))
        for tag, *shape in gru:
            if tuple(shape) not in have_g:
                have_g.add(tuple(shape))
                new_g.append((f"{name}_{tag}", *shape))
    emit("config_shapes", calls=calls, new_attention=new_a, new_gru=new_g)
    return new_a, new_g


def eval_argv(checkpoint_path, load_step):
    """The command line of the eval phase: an eval-only combat run over every
    scenario of 3-8sz_symmetric at the config's own test_nepisode."""
    return ["--config=refil", "--env-config=entity_battle", "with", "scenario=3-8sz_symmetric",
            "evaluate=True", "eval_all_scen=True", f"checkpoint_path={checkpoint_path}",
            f"load_step={load_step}", "use_cuda=True",
            f"eval_path={os.path.join(SMOKE_RESULTS, 'eval', 'eval.json')}",
            f"local_results_path={os.path.join(SMOKE_RESULTS, 'eval')}"]


def n_test_episodes(argv):
    """The width of one test rollout of the fused loop (or of an eval-only
    run) under ``argv``: all of test_nepisode, a multiple of batch_size_run
    (``run.py``)."""
    from refil_torch.config import args_sanity_check, load_config
    from refil_torch.main import parse_cli

    alg, env, overrides = parse_cli(argv)
    cfg = args_sanity_check(load_config(alg=alg, env=env, overrides=overrides))
    bsr = cfg["batch_size_run"]
    return bsr, max(1, cfg["test_nepisode"] // bsr) * bsr


def fused_widths(argv):
    """{name: envs} of a fused run's rollouts: a training rollout steps
    batch_size_run envs, a test run all of test_nepisode in one rollout
    (``run.py:_run_fused_loop``)."""
    bsr, n_test = n_test_episodes(argv)
    return {"rollout": bsr, **({"test_rollout": n_test} if n_test != bsr else {})}


def rollout_widths(path):
    """{name: envs} of the rollouts a slice's runs make, from its config: a
    training rollout (and each of the classic loop's test runs) steps
    batch_size_run envs, the fused loop's test run all of test_nepisode in
    one rollout, and on combat the eval phase's rollout all of the config's
    own test_nepisode; then each scale run's on that path, named after it."""
    out = fused_widths(slice_argv(path, fused=True))
    if path == "combat":
        n_eval = n_test_episodes(eval_argv("", 0))[1]
        if n_eval not in out.values():
            out["eval_rollout"] = n_eval
    for name, (on, _) in SCALE_RUNS.items():
        if on == path:
            out.update({f"{name}_{tag}": envs
                        for tag, envs in fused_widths(scale_argv(name)).items()})
    return out


def attn_shapes():
    """Every entity-attention call of the slices: a learner update's, and a
    rollout step's at each width the slices' rollouts run at."""
    rows = list(ATTN_LEARNER_SHAPES)
    for path, (ne, nq, mrows, width, _) in ROLLOUT_CALL.items():
        for tag, envs in rollout_widths(path).items():
            rows.append((path, tag, envs, ne, nq, mrows, width))
    return rows


def gru_shapes():
    """Every GRU call of the combat slice: a learner update's, and a
    rollout step's (T = 1) at each width its rollouts run at."""
    per_env = ROLLOUT_CALL["combat"][4]
    return GRU_LEARNER_SHAPES + [(tag, 1, envs * per_env)
                                 for tag, envs in rollout_widths("combat").items()]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def make_inputs(Bp, Ne, Nq, D, E, O, dtype, seed, pre=True, mask_rows=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    ents = torch.relu(torch.randn((Bp, Ne, D), generator=g, device=dev)).to(dtype)
    wi = ((torch.rand((D, 3 * E), generator=g, device=dev) * 2 - 1) / math.sqrt(D)).to(dtype)
    wo = ((torch.rand((E, O), generator=g, device=dev) * 2 - 1) / math.sqrt(E)).to(dtype)
    bo = ((torch.rand((O,), generator=g, device=dev) * 2 - 1) / math.sqrt(E)).to(dtype)
    pre_mask = None
    if pre:
        rows = mask_rows or Nq
        pre_mask = torch.rand((Bp, rows, Ne), generator=g, device=dev) < 0.25
        pre_mask[0, min(1, Nq - 1), :] = True  # a fully blocked row -> exact zeros
    post_mask = torch.rand((Bp, Nq), generator=g, device=dev) < 0.1
    post_mask[0, 0] = True
    gout = torch.randn((Bp, Nq, O), generator=g, device=dev).to(dtype)
    return ents, wi, wo, bo, pre_mask, post_mask, gout


def library_attention(ents, wi, wo, bo, pre_mask, post_mask, n_heads):
    """Yardstick: one PyTorch composition of the same function, with
    scaled_dot_product_attention. Timed here only; the port never calls it."""
    Bp, Ne, _ = ents.shape
    Nq = post_mask.shape[1]
    E = wi.shape[1] // 3
    hd = E // n_heads
    qkv = torch.matmul(ents, wi)
    q = qkv[:, :Nq, :E].reshape(Bp, Nq, n_heads, hd).transpose(1, 2)
    k = qkv[:, :, E:2 * E].reshape(Bp, Ne, n_heads, hd).transpose(1, 2)
    v = qkv[:, :, 2 * E:].reshape(Bp, Ne, n_heads, hd).transpose(1, 2)
    if pre_mask is None:
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    else:
        keep = ~pre_mask[:, :Nq]
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep[:, None])
        a = a.masked_fill(~keep.any(-1)[:, None, :, None], 0.0)
    a = a.transpose(1, 2).reshape(Bp, Nq, E)
    return (torch.matmul(a, wo) + bo).masked_fill(post_mask[..., None], 0.0)


def cost(Bp, Ne, Nq, D, E, O, dtype, pre: bool, bwd: bool):
    """(bytes, flops) the function needs: each input read once, each output
    written once; multiply-adds count 2 operations. K and V are projected
    for all Ne rows, Q only for the Nq rows that query, as the kernels do."""
    b = torch.tensor([], dtype=dtype).element_size()
    weights = (D * 3 * E + E * O + O) * b
    masks = Bp * Nq * (Ne if pre else 0) + Bp * Nq
    qkv = 2 * Bp * (Ne * 2 * E + Nq * E) * D
    scores = 2 * 2 * Bp * Nq * Ne * E  # q k^T and w v
    proj = 2 * Bp * Nq * E * O
    if not bwd:
        return Bp * Ne * D * b + weights + masks + Bp * Nq * O * b, qkv + scores + proj
    reads = Bp * Ne * D * b + Bp * Nq * O * b + weights + masks
    writes = Bp * Ne * D * 4 + (D * 3 * E + E * O + O) * 4
    flops = qkv + scores + 2 * proj + 2 * scores + 2 * qkv  # recompute + VJPs
    return reads + writes, flops


def gru_cost(T, R, H, dtype, bwd: bool):
    """(bytes, flops) of the GRU recurrence: each input read once, each
    output written once; the operations are the recurrent products'
    multiply-adds (2 each; the gates' elementwise work, under 5%, is not
    counted): h @ W_h per step forward; backward, its recomputation,
    dgh @ W_h^T and h^T @ dgh."""
    b = torch.tensor([], dtype=dtype).element_size()
    weights = (H * 3 * H + H) * 4
    product = 2 * T * R * H * 3 * H
    if not bwd:
        return T * R * 3 * H * b + weights + R * H * 4 + T * R * H * b, product
    reads = T * R * 3 * H * b + 2 * T * R * H * b + R * H * 4 + weights
    writes = T * R * 3 * H * 4 + weights + R * H * 4
    return reads + writes, 3 * product


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=5):
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed and timed by CUDA events, so the host's time to issue a call
    (which ``cuda_time_ms`` includes where a call is shorter than it) is out
    of the measurement. None, with the error printed, if capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as err:
        emit("note", device_ms=f"graph capture failed: {err}")
        return None
    return cuda_time_ms(graph.replay, iters=replays, warmup=1) / iters


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max()) if a.numel() else 0.0


def scaled_err(a, b) -> float:
    """max |a - b| / max(1, max |b|): a gradient summed over thousands of
    samples is compared at the tolerance relative to its own scale."""
    if not a.numel():
        return 0.0
    return max_err(a, b) / max(1.0, float(b.detach().float().abs().max()))


# ---------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = smi_name_power()
    print(name_power, flush=True)
    emit("device", nvidia_smi=name_power, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return name_power


def phase_build(attn_rows, gru_rows):
    from refil_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.ptxas.splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        emit("build", source=f"refil_torch/csrc/{name}.cu", nvcc_seconds=round(b.seconds, 2),
             wall_seconds=round(wall, 2), ptxas=ptxas)
    from refil_torch.ops import entity_attn

    for path, _, Bp, ne, nq, _, width in attn_rows:
        for dtype in (torch.float32, torch.bfloat16):
            for bwd in (False, True):
                plan = entity_attn.launch_plan(bwd, dtype, (Bp, ne, nq, width, width, width,
                                                            HEADS), torch.cuda.current_device())
                emit("launch_plan", kernel="entity_attn_bwd" if bwd else "entity_attn_fwd",
                     path=path, Bp=Bp, width=width, dtype=str(dtype).replace("torch.", ""),
                     **plan._asdict())
    from refil_torch.ops import gru_kernel

    # the plan sweep at the learner's T, then every call of the slices
    for tag, T, R in [("plan", 151, R) for R in GRU_PLAN_ROWS] + list(gru_rows):
        for dtype in (torch.float32, torch.bfloat16):
            for bwd in (False, True):
                plan = gru_kernel.launch_plan(bwd, T, R, GRU_HIDDEN, dtype,
                                              torch.cuda.current_device())
                emit("launch_plan", kernel="gru_bwd" if bwd else "gru_fwd", case=tag, T=T,
                     R=R, dtype=str(dtype).replace("torch.", ""), **plan._asdict())
    return built


def phase_sass(built):
    """The built attention library's machine code (``cuobjdump -sass``):
    every instance of the tensor-core product (``gemm_kernel_tc``) runs
    warpgroup MMAs (``HGMMA``), and no FMA instance (``gemm_kernel``) does."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", built["entity_attn"].path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hgmma = {}  # function -> HGMMA instructions in it
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            hgmma[name] = 0
        elif name is not None and "HGMMA" in line:
            hgmma[name] += 1
    tc = {n: c for n, c in hgmma.items() if "gemm_kernel_tc" in n}
    fma = {n: c for n, c in hgmma.items() if "gemm_kernel" in n and n not in tc}
    ok = bool(tc) and bool(fma) and all(tc.values()) and not any(fma.values())
    emit("sass", ok=ok, library=os.path.basename(built["entity_attn"].path),
         tensor_core_instances=tc, fma_instances=fma,
         others_with_hgmma=[n for n, c in hgmma.items() if c and n not in tc])
    if not ok:
        raise AssertionError("the bfloat16 product instances lack HGMMA, or an FMA one has it")


def check_case(tag, Bp, Ne, Nq, D, E, O, H, dtype, pre=True, mask_rows=None, seed=0,
               timing=False, path=None, masks=None):
    from refil_torch.ops import entity_attn
    from refil_torch.ops.attention import entity_attention as plain
    from refil_torch.ops.attention import entity_attention_backward_staged as staged
    from refil_torch.ops.attention import entity_attention_forward_staged as staged_fwd

    ents, wi, wo, bo, pm, qm, gout = make_inputs(Bp, Ne, Nq, D, E, O, dtype, seed, pre,
                                                 mask_rows)
    if masks is not None:  # given (pre-mask, post-mask) in place of the random ones
        pm, qm = masks
    out_k = entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, H)
    out_k2 = entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, H)
    out_p = plain(ents, wi, wo, bo, pm, qm, H)
    out_s = staged_fwd(ents, wi, wo, bo, pm, qm, H).out
    torch.cuda.synchronize()
    fwd_err = max_err(out_k, out_p)
    fwd_stage_err = max_err(out_k, out_s)
    fwd_same_bits = torch.equal(out_k, out_k2)
    if pm is not None:
        # a fully blocked row attends to nothing: its output is exactly the bias
        blocked = pm[:, :Nq].all(-1)
        expect = torch.where(qm[..., None], torch.zeros_like(bo), bo).expand_as(out_k)
        if not torch.equal(out_k[blocked], expect[blocked]):
            raise AssertionError(f"{tag}: a fully blocked row is not exactly the bias")
    if not torch.isfinite(out_k.float()).all():
        raise AssertionError(f"{tag}: forward kernel gave a non-finite value")

    # backward: kernel vs autograd of the plain version, same inputs and g;
    # a second call must give the same bits (no atomics, sums in fixed order)
    grads_k = entity_attn.kernel_backward(ents, wi, wo, pm, qm, gout, H)
    grads_k2 = entity_attn.kernel_backward(ents, wi, wo, pm, qm, gout, H)
    leaves = [t.detach().clone().requires_grad_(True) for t in (ents, wi, wo, bo)]
    out_ref = plain(*leaves, pm, qm, H)
    grads_p = torch.autograd.grad(out_ref, leaves, gout, retain_graph=True)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(grads_k, grads_k2))
    names = ("d_entities", "d_in_kernel", "d_out_kernel", "d_out_bias")
    bwd_err = {n: scaled_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    # and against the plain version of its stages, which rounds where it does
    grads_s = staged(ents, wi, wo, pm, qm, gout, H)
    stage_err = {n: scaled_err(a, b) for n, a, b in zip(names, grads_k, grads_s)}
    tol_f, tol_b = TOL["fwd"][dtype], TOL["bwd"][dtype]
    row = dict(kernel="entity_attn", path=path, case=tag, Bp=Bp, Ne=Ne, Nq=Nq, D=D, E=E, O=O,
               heads=H, mask_rows=mask_rows or Nq,
               blocked_row_share=(None if pm is None else float(pm[:, :Nq].all(-1).float().mean())),
               dtype=str(dtype).replace("torch.", ""), pre_mask=pre,
               fwd_max_abs_err=fwd_err, fwd_vs_stages_max_abs_err=fwd_stage_err, fwd_tol=tol_f,
               fwd_two_calls_same_bits=fwd_same_bits, bwd_scaled_err=bwd_err, bwd_tol=tol_b,
               bwd_max_abs_err=max(max_err(a, b) for a, b in zip(grads_k, grads_p)),
               bwd_vs_stages_scaled_err=stage_err, bwd_two_calls_same_bits=same_bits)
    ok = (fwd_err <= tol_f and fwd_stage_err <= tol_f and fwd_same_bits and same_bits
          and all(v <= tol_b for v in (*bwd_err.values(), *stage_err.values())))

    if timing:
        lib_leaves = [t.detach().clone().requires_grad_(True) for t in (ents, wi, wo, bo)]
        out_lib = library_attention(*lib_leaves, pm, qm, H)
        row["library_fwd_max_abs_err"] = max_err(out_lib, out_p)
        row["ms"] = {
            "fwd": cuda_time_ms(lambda: entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, H)),
            "fwd_plain": cuda_time_ms(lambda: plain(ents, wi, wo, bo, pm, qm, H)),
            "fwd_library": cuda_time_ms(lambda: library_attention(ents, wi, wo, bo, pm, qm, H)),
            "bwd": cuda_time_ms(lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, gout, H)),
            "bwd_plain": cuda_time_ms(
                lambda: torch.autograd.grad(out_ref, leaves, gout, retain_graph=True)),
            "bwd_library": cuda_time_ms(
                lambda: torch.autograd.grad(out_lib, lib_leaves, gout, retain_graph=True)),
            "fwd_device": device_ms(
                lambda: entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, H)),
            "bwd_device": device_ms(
                lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, gout, H)),
        }
        for kind in ("fwd", "bwd"):
            nbytes, flops = cost(Bp, Ne, Nq, D, E, O, dtype, pre, kind == "bwd")
            row[f"{kind}_bytes"], row[f"{kind}_flops"] = nbytes, flops
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(nbytes, flops, dtype)
    emit("kernels_check", ok=ok, **row)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {tag} {dtype}")
    return row


def gemm_instance(ta, tb, M, N, chunks):
    """The instance of csrc/gemm.cuh a product takes: two bfloat16 operands
    the tensor cores (with the tile ``gemm::tc::tile_of`` picks), any
    other the f32 FMA one."""
    from refil_torch.ops import entity_attn as ea

    if not ta == tb == torch.bfloat16:
        return "fma_f32"
    rows, cols = ctypes.c_int(), ctypes.c_int()
    lib = ea._lib()
    ea._check(lib, lib.entity_attn_gemm_tile(M, N, chunks, torch.cuda.current_device(),
                                             ctypes.byref(rows), ctypes.byref(cols)), "tile")
    return f"wgmma_bf16_{rows.value}x{cols.value}"


def check_gemm(tag, ta, tb, ka, M, N, K, a_map=(1, 1), c_map=(1, 1), add=False,
               rnd=False, chunks=1, pad=0, seed=0, timing=False, tc=torch.float32,
               epilogue=False):
    """The attention's matrix product (csrc/gemm.cuh) alone against its plain
    version: random operands laid out as the forward and backward lay them
    (row maps, leading dimensions ``pad`` elements wider than the matrix,
    which takes the element-by-element copy where a row is not 16-byte
    aligned), a random output buffer of type ``tc``, so that what the
    product must not touch is held too; ``epilogue``: a random bias and
    dropped rows, as the forward's output product has. f32 sums within 1e-5
    of the output's scale where K <= 1024, 1e-4 for the tall K of the weight
    gradients (bfloat16 operands, on the tensor cores, too: their products
    are exact in f32 and only the order of the f32 sum differs); 2e-2 where
    the output is rounded to bfloat16. A second call into a copy of the
    same output buffer must give the same bits."""
    from refil_torch.ops import entity_attn as ea

    g = torch.Generator(device="cuda").manual_seed(seed)

    def operand(dtype, n_rows, n_cols, rmap):
        group, stride = rmap
        phys = ((n_rows - 1) // group) * stride + (n_rows - 1) % group + 1
        ld = n_cols + pad
        flat = torch.randn((phys * ld,), generator=g, device="cuda").to(dtype)
        return ea.Operand(flat, ld, group, stride)

    a = operand(ta, *((M, K) if ka else (K, M)), a_map)
    b = operand(tb, K, N, (1, 1))
    c0 = operand(tc, M, N, c_map)
    chunk_stride = c0.flat.numel() if chunks > 1 else 0
    c_flat = torch.randn((c0.flat.numel() * chunks,), generator=g, device="cuda").to(tc)
    c_k = c0._replace(flat=c_flat.clone())
    c_k2 = c0._replace(flat=c_flat.clone())
    c_p = c0._replace(flat=c_flat.clone())
    kw = dict(add=add, round_bf16=rnd, chunks=chunks, chunk_stride=chunk_stride)
    if epilogue:
        kw["bias"] = torch.randn((N,), generator=g, device="cuda").to(tc)
        kw["drop"] = torch.rand((M,), generator=g, device="cuda") < 0.1
    ea.gemm(a, b, c_k, M, N, K, ka, **kw)
    ea.gemm(a, b, c_k2, M, N, K, ka, **kw)
    ea.plain_gemm(a, b, c_p, M, N, K, ka, **kw)
    torch.cuda.synchronize()
    err = scaled_err(c_k.flat, c_p.flat)
    same_bits = torch.equal(c_k.flat, c_k2.flat)
    tol = 2e-2 if rnd or tc == torch.bfloat16 else (1e-5 if K <= 1024 else 1e-4)
    row = dict(kernel="entity_attn_gemm", case=tag, A=str(ta).replace("torch.", ""),
               B=str(tb).replace("torch.", ""), C=str(tc).replace("torch.", ""), ka=ka, M=M,
               N=N, K=K, a_map=a_map, c_map=c_map, add=add, round_bf16=rnd, chunks=chunks,
               pad=pad, epilogue=epilogue, instance=gemm_instance(ta, tb, M, N, chunks),
               scaled_err=err, tol=tol, two_calls_same_bits=same_bits)
    if timing:
        ms = cuda_time_ms(lambda: ea.gemm(a, b, c_k, M, N, K, ka, **kw))
        A = a.flat.view(-1, a.ld)[:, :K] if ka else a.flat.view(-1, a.ld)[:, :M].T
        B = b.flat.view(-1, b.ld)[:, :N]
        row["ms"] = ms
        row["tflops"] = 2.0 * M * N * K / ms / 1e9
        row["library_ms"] = cuda_time_ms(lambda: torch.matmul(A, B))  # cuBLAS, yardstick
    emit("kernels_check", ok=err <= tol and same_bits, **row)
    if not (err <= tol and same_bits):
        raise AssertionError(f"gemm disagrees with its plain version or itself: {tag}")
    return row


def phase_gemm():
    """The product at each of the forward's and the backward's shapes for
    the combat target agent's call (Bp 4,832, Ne 16, Nq 8, widths 128), in
    the layouts, types, row maps and epilogues they give it: in float32 on
    the FMA instance, in bfloat16 (every operand a bfloat16 plane) on the
    tensor cores; at a Group Matching shape that takes 64-row tiles; then
    ragged M, N, K and unaligned rows (32- and 64-row tiles). In bfloat16
    also every N the attention's products take (64 to 384; k-contiguous A,
    K 128, and m-contiguous A, tall K in split-K chunks) at full and
    ragged M. Each call twice, for the same bits."""
    f32, b16 = torch.float32, torch.bfloat16
    Bp, Ne, Nq, W = 4832, 16, 8, 128
    re_, rq, sel = Bp * Ne, Bp * Nq, (Nq, Ne)
    for T in (f32, b16):
        rnd = T == b16
        shapes = [  # tag, A, ka, M, N, K, a_map, c_map, add, rnd, chunks, C
            ("kv", True, re_, 2 * W, W, (1, 1), (1, 1), False, rnd, 1, T),
            ("q", True, rq, W, W, sel, (1, 1), False, rnd, 1, T),
            ("dattn", True, rq, W, W, (1, 1), (1, 1), False, False, 1, T),
            ("dents_kv", True, re_, W, 2 * W, (1, 1), (1, 1), False, False, 1, f32),
            ("dents_q", True, rq, W, W, (1, 1), sel, True, False, 1, f32),
            ("dw_kv", False, W, 2 * W, re_, (1, 1), (1, 1), False, False, 264, f32),
            ("dw_q", False, W, W, rq, sel, (1, 1), False, False, 264, f32),
            ("dw_o", False, W, W, rq, (1, 1), (1, 1), False, False, 264, f32),
        ]
        for i, (tag, *case) in enumerate(shapes):
            ka, M, N, K, a_map, c_map, add, r, chunks, tc = case
            check_gemm(tag, T, T, ka, M, N, K, a_map, c_map, add, r, chunks, seed=40 + i,
                       timing=tag in ("kv", "dw_kv"), tc=tc)
        # Group Matching's target-agent K|V projection (Bp 1,632, widths
        # 64): too few 128-row tiles for the SMs, so 64-row tiles
        check_gemm("kv_gm_target", T, T, True, 1632 * 8, 128, 64, rnd=rnd, seed=49, tc=T)
        # the forward's output product: attn W_o + b_o, post-masked rows 0,
        # stored in the inputs' type
        check_gemm("fwd_out", T, T, True, rq, W, W, seed=50, tc=T, epilogue=True)
        check_gemm("fwd_out_ragged", T, T, True, 37, 45, 23, pad=3, seed=51, tc=T,
                   epilogue=True)
        for i, ka in enumerate((True, False)):
            for add in (False, True):
                for pad in (0, 3):
                    check_gemm(f"ragged_pad{pad}", T, T, ka, 37, 45, 23, a_map=(5, 8),
                               c_map=(3, 4), add=add, rnd=rnd and ka and not add, chunks=3,
                               pad=pad, seed=60 + 4 * i + 2 * add + pad)
    # the tensor cores at every N of the attention's products, both majors of
    # A, full and ragged M, rows unaligned (pad 3) and aligned
    for i, N in enumerate((64, 128, 192, 256, 384)):
        check_gemm(f"n{N}_ka", b16, b16, True, 2 * 4832 + 37, N, W, pad=3 * (i % 2),
                   seed=80 + i)
        check_gemm(f"n{N}_ka_bf16_out", b16, b16, True, 4832, N, W, rnd=True, seed=85 + i,
                   tc=b16)
        check_gemm(f"n{N}_mk", b16, b16, False, W + 64 * (i % 2), N, rq + 5, pad=3 * (i % 2),
                   chunks=264, seed=90 + i)


OWN_TAGS = ("entity_attn", "gru_", "gemm_kernel", "combat_")
# kernels of a library's attention or recurrence (SDPA, flash, cuDNN): none
# may run in a replayed block, whose attention and GRU are the repository's
LIBRARY_TAGS = ("flash", "fmha", "sdpa", "scaled_dot", "efficient_attention", "cudnn", "rnn",
                "lstm")
# one kernel of each wrapper's launch that no other launch runs
ANCHORS = {"entity_attn_fwd": "entity_attn_fwd_sample_kernel",
           "entity_attn_bwd": "entity_attn_bwd_sample_kernel",
           "gru_fwd": "gru_fwd_kernel", "gru_bwd": "gru_bwd_kernel",
           "combat_step": "combat_step_kernel", "combat_observe": "combat_observe_kernel"}


def profile_kernels(call):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def profile_replay(pipe, ps, name_power):
    """One replay of the captured combat train block under the profiler:
    its attention and GRU work runs in the repository's kernels, each
    wrapper's launches as many times as the capture recorded (counted by a
    kernel only that launch runs; the combat env's step and observation
    kernels too), and no library attention or recurrence kernel runs; the
    rest is PyTorch's kernels for the runner, the dense layers and the
    optimiser."""
    rec = pipe.graphs["train"]
    kernels = profile_kernels(lambda: pipe.run_blocks(ps, 1, train=True))
    own = [(n, us) for _, n, us in kernels if any(t in n for t in OWN_TAGS)]
    library = sorted({n for _, n, _ in kernels if not any(t in n for t in OWN_TAGS)
                      and (any(t in n.lower() for t in LIBRARY_TAGS) or "attention" in n.lower())})
    anchors = {k: sum(tag in n for _, n, _ in kernels) for k, tag in ANCHORS.items()}
    recorded = {k: rec.launches[k] for k in ANCHORS}
    others = {}
    for _, n, us in kernels:
        if not any(t in n for t in OWN_TAGS):
            c, t = others.get(n[:70], (0, 0.0))
            others[n[:70]] = (c + 1, t + us)
    device_us = sum(us for _, _, us in kernels)
    emit("own_kernels", call="combat_train_block_replay", card=name_power, traced=bool(kernels),
         kernels=len(kernels), device_us=device_us, own_kernels=len(own),
         own_device_us=sum(us for _, us in own), launches_by_anchor=anchors,
         launches_recorded=recorded, library_kernels=library,
         top_other=[{"name": n, "calls": c, "us": t} for n, (c, t) in
                    sorted(others.items(), key=lambda kv: -kv[1][1])[:12]])
    if not kernels or library or anchors != recorded:
        raise AssertionError(f"the replayed train block: library kernels {library}, launches "
                             f"{anchors} != recorded {recorded}")


def own_kernels_only(replay=None, Bp=4832, Ne=16, Nq=8, W=128, T=151, R=768):
    """Profiles one call each of the attention forward and backward at a
    combat shape, in float32 and in bfloat16 (its products on the tensor
    cores), and of the GRU backward at the agent's: every device kernel each
    runs must be one of csrc/'s (entity_attn*, gru_*, the products
    gemm.cuh), no cuBLAS, SDPA or PyTorch kernel. Prints the per-kernel
    device times of each call, in launch order (its stages). With
    ``replay`` (pipeline, state), then ``profile_replay``."""
    from refil_torch.ops import entity_attn, gru_kernel

    xs, wx, bx, wh, bhn, h0, g = make_gru_inputs(T, R, GRU_HIDDEN, torch.float32, 8)
    xw = (torch.matmul(xs, wx) + bx).transpose(0, 1).contiguous()
    hs = gru_kernel.kernel_forward(xw, wh, bhn, h0)
    calls = {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        ents, wi, wo, bo, pm, qm, gout = make_inputs(Bp, Ne, Nq, W, W, W, dtype, 7,
                                                     mask_rows=Ne)
        calls["entity_attn_fwd" + suffix] = functools.partial(
            entity_attn.kernel_forward, ents, wi, wo, bo, pm, qm, HEADS)
        calls["entity_attn_bwd" + suffix] = functools.partial(
            entity_attn.kernel_backward, ents, wi, wo, pm, qm, gout, HEADS)
    calls["gru_bwd"] = lambda: gru_kernel.kernel_backward(xw, hs, h0, wh, bhn, g)
    for name, call in calls.items():
        call()
        kernels = profile_kernels(call)
        foreign = sorted({n for _, n, _ in kernels if not any(tag in n for tag in OWN_TAGS)})
        emit("own_kernels", call=name, kernels=[{"name": n[:90], "us": us} for _, n, us in kernels],
             device_us=sum(us for _, _, us in kernels), foreign=foreign, traced=bool(kernels))
        if foreign:
            raise AssertionError(f"{name} ran kernels that are not the repository's: {foreign}")
    if replay is not None:
        profile_replay(*replay)


def make_gru_inputs(T, R, H, dtype, seed):
    """xs (R, T, H) and GRUSequence-style weights: U(+-1/sqrt(H)) everywhere."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *shape: (torch.rand(shape, generator=g, device="cuda") * 2 - 1) / math.sqrt(H)
    xs = torch.randn((R, T, H), generator=g, device="cuda").to(dtype)
    wi, bi, wh, bhn = u(H, 3 * H), u(3 * H), u(H, 3 * H), u(H)
    h0 = 0.5 * torch.randn((R, H), generator=g, device="cuda")
    gout = torch.randn((T, R, H), generator=g, device="cuda").to(dtype)
    return xs, wi, bi, wh, bhn, h0, gout


def library_gru(xs, wi, bi, wh, bhn, h0):
    """Yardstick: cuDNN's torch.nn.GRU over the same xs and weights (its
    b_hr = b_hz = 0; b_in with the input projection). Timed here only; the
    port never calls it."""
    R, T, D = xs.shape
    H = wh.shape[0]
    gru = torch.nn.GRU(D, H, batch_first=True).cuda()
    with torch.no_grad():
        gru.weight_ih_l0.copy_(wi.T)
        gru.weight_hh_l0.copy_(wh.T)
        gru.bias_ih_l0.copy_(bi)
        gru.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * H, device="cuda"), bhn]))
    return gru


def time_library_gru(xs, wi, bi, wh, bhn, h0, gout, hs_ref, dtype):
    """``torch.nn.GRU`` (``library_gru``) in ``dtype`` on the same inputs:
    its forward's max abs difference from ``hs_ref``, and its forward and
    backward timed (``fwd_library``, ``bwd_library``)."""
    gru = library_gru(xs, wi, bi, wh, bhn, h0).to(dtype)
    h0_l = h0[None].to(dtype)
    xs_l = xs.detach().clone().requires_grad_(True)
    out_l, _ = gru(xs_l, h0_l)
    lib_leaves = [xs_l, *gru.parameters()]
    gl = gout.transpose(0, 1)
    torch.autograd.grad(out_l, lib_leaves, gl, retain_graph=True)
    torch.cuda.synchronize()
    return {"dtype": str(dtype).replace("torch.", ""),
            "err": max_err(out_l.transpose(0, 1), hs_ref),
            "fwd_library": cuda_time_ms(lambda: gru(xs, h0_l)),
            "bwd_library": cuda_time_ms(
                lambda: torch.autograd.grad(out_l, lib_leaves, gl, retain_graph=True))}


def check_gru(tag, T, R, H, dtype, seed=0, timing=False, path="combat"):
    from refil_torch.ops import gru_kernel
    from refil_torch.ops.gru import gru_backward_staged as staged
    from refil_torch.ops.gru import gru_sequence as plain

    xs, wi, bi, wh, bhn, h0, gout = make_gru_inputs(T, R, H, dtype, seed)
    hoist = lambda: (torch.matmul(xs, wi.to(dtype)) + bi.to(dtype)).transpose(0, 1).contiguous()
    xw = hoist()
    hs_k = gru_kernel.kernel_forward(xw, wh, bhn, h0)
    hs_p = plain(xw, wh, bhn, h0)
    torch.cuda.synchronize()
    fwd_err = max_err(hs_k, hs_p)
    if not torch.isfinite(hs_k.float()).all():
        raise AssertionError(f"gru {tag}: forward kernel gave a non-finite value")
    # backward: kernel vs autograd of the plain version and vs the plain
    # version of its stages; a second call must give the same bits
    grads_k = gru_kernel.kernel_backward(xw, hs_k, h0, wh, bhn, gout)
    grads_k2 = gru_kernel.kernel_backward(xw, hs_k, h0, wh, bhn, gout)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xw, wh, bhn, h0)]
    out_ref = plain(*leaves)
    grads_p = torch.autograd.grad(out_ref, leaves, gout, retain_graph=True)
    grads_s = staged(xw, hs_k, h0, wh, bhn, gout)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(grads_k, grads_k2))
    names = ("d_xw", "d_wh", "d_bhn", "d_h0")
    bwd_err = {n: scaled_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    stage_err = {n: scaled_err(a, b) for n, a, b in zip(names, grads_k, grads_s)}
    tol_f, tol_b = TOL["fwd"][dtype], TOL["bwd"][dtype]
    row = dict(kernel="gru", path=path, case=tag, T=T, R=R, H=H,
               dtype=str(dtype).replace("torch.", ""), fwd_max_abs_err=fwd_err, fwd_tol=tol_f,
               bwd_scaled_err=bwd_err, bwd_tol=tol_b,
               bwd_max_abs_err=max(max_err(a, b) for a, b in zip(grads_k, grads_p)),
               bwd_vs_stages_scaled_err=stage_err, bwd_two_calls_same_bits=same_bits)
    ok = (fwd_err <= tol_f and same_bits
          and all(v <= tol_b for v in (*bwd_err.values(), *stage_err.values())))
    if timing:
        ms = {
            "fwd": cuda_time_ms(lambda: gru_kernel.kernel_forward(xw, wh, bhn, h0)),
            "fwd_plain": cuda_time_ms(lambda: plain(xw, wh, bhn, h0), iters=5),
            "hoisted_matmul_plus_fwd": cuda_time_ms(
                lambda: gru_kernel.kernel_forward(hoist(), wh, bhn, h0)),
            "bwd": cuda_time_ms(lambda: gru_kernel.kernel_backward(xw, hs_k, h0, wh, bhn, gout)),
            "bwd_plain": cuda_time_ms(
                lambda: torch.autograd.grad(out_ref, leaves, gout, retain_graph=True), iters=5),
            "fwd_device": device_ms(lambda: gru_kernel.kernel_forward(xw, wh, bhn, h0)),
            "bwd_device": device_ms(
                lambda: gru_kernel.kernel_backward(xw, hs_k, h0, wh, bhn, gout)),
        }
        # torch.nn.GRU in the kernel's dtype; where PyTorch refuses that
        # dtype, the refusal's text and the float32 call as the yardstick
        try:
            lib = time_library_gru(xs, wi, bi, wh, bhn, h0, gout, hs_p, dtype)
        except RuntimeError as e:
            if dtype == torch.float32:
                raise
            row["library_refused"] = f"{type(e).__name__}: {e}"
            lib = time_library_gru(xs.float(), wi, bi, wh, bhn, h0, gout.float(),
                                   hs_p.float(), torch.float32)
        row["library_dtype"], row["library_fwd_max_abs_err"] = lib.pop("dtype"), lib.pop("err")
        ms.update(lib)
        row["ms"] = ms
        for kind in ("fwd", "bwd"):
            nbytes, flops = gru_cost(T, R, H, dtype, kind == "bwd")
            row[f"{kind}_bytes"], row[f"{kind}_flops"] = nbytes, flops
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound(nbytes, flops, dtype)
    emit("kernels_check", ok=ok, **row)
    if not ok:
        raise AssertionError(f"GRU kernel disagrees with its plain version: {tag} {dtype}")
    return row


def imagined_masks_cases(dtype=torch.float32):
    """The attention kernel on REFIL's own pre-masks at Group Matching's
    learner shapes (refil_group_matching: batch 32 of 51 steps, Na = Ne = 8,
    widths 64): ``build_imagine_masks`` on the masks of a batch of the GM env
    (its obs and entity masks are all clear, so the masks are the random
    groups'), drawn from a generator as the learner draws them; the agent x3
    call (full view, within, interact: Bp 4,896) and both imagined hypernet
    calls (within and interact, no obs mask: Bp 1,600 of the 50 trained
    steps, 8 rows), the agent-row masks the FF agent and the linear mixer
    take; and the same with the ground-truth groups of ``test_gt_factors``'s
    diagnostic. Forward and gradients against the plain version, as
    ``check_case`` does; ``blocked_row_share`` is the share of query rows
    the pre-mask blocks whole."""
    from refil_torch.envs.group_matching import GroupMatching
    from refil_torch.config import load_config
    from refil_torch.ops.masks import build_imagine_masks

    cfg = load_config(alg="refil_group_matching", env="group_matching")
    env = GroupMatching(**cfg["env_args"], device="cuda")
    B, T1, Na = cfg["batch_size"], cfg["env_args"]["episode_limit"] + 1, env.env_info()["n_agents"]
    _, obs = env.reset(B, generator=torch.Generator(device="cuda").manual_seed(5))
    om = obs["obs_mask"][:, None].expand(B, T1, -1, -1).contiguous()
    em = obs["entity_mask"][:, None].expand(B, T1, -1).contiguous()
    gt = obs["gt_mask"][:, None].expand(B, T1, -1, -1).contiguous()
    Ne, W = em.shape[-1], cfg["attn_embed_dim"]
    rows = []
    for kind, kw in (("imagined", {"generator": torch.Generator(device="cuda").manual_seed(6)}),
                     ("gt", {"gt_mask": gt, "use_gt_factors": True})):
        m = build_imagine_masks(om, em, Na, agent_rows=True, **kw)
        post = em[..., :Na]
        agent_pre = torch.cat([om[:, :, :Na], m.within, m.interact]).reshape(-1, Na, Ne)
        agent_post = torch.cat([post] * 3).reshape(-1, Na)
        cases = [(f"agent_x3_{kind}", agent_pre, agent_post)]
        for half, mm in (("within", m.w_noobs), ("interact", m.i_noobs)):
            cases.append((f"mixer_{kind}_{half}", mm[:, :-1].reshape(-1, Na, Ne),
                          post[:, :-1].reshape(-1, Na)))
        for i, (tag, pre, qm) in enumerate(cases):
            rows.append(check_case(tag, pre.shape[0], Ne, Na, W, W, W, HEADS, dtype,
                                   mask_rows=Na, seed=70 + i, path="group_matching",
                                   masks=(pre.contiguous(), qm.contiguous())))
    return rows


def combat_rollout_masks(cfg, scenario, B, seed, device="cuda"):
    """(obs_mask (B, T+1, Ne, Ne), entity_mask (B, T+1, Ne), dead share, Na): B
    episodes of ``EntityBattle`` on ``scenario`` under the config's env_args,
    each agent taking a uniform available action (the learner's first
    episodes, at epsilon 1), the steps after an episode's end zeroed as the
    runner stores them. The dead share is that of the present entity-steps
    of the episodes whose unit is dead (its obs_mask row blocks every other
    entity)."""
    from refil_torch.envs.combat.env import EntityBattle
    from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY

    env = EntityBattle(**{**cfg["env_args"], "scenario_dict": SCENARIO_REGISTRY[scenario]()},
                       device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state, obs = env.reset(B, generator=gen)
    alive = torch.ones(B, dtype=torch.bool, device=device)
    oms, ems, fills = [obs["obs_mask"]], [obs["entity_mask"]], [alive]
    for _ in range(env.episode_limit):
        avail = obs["avail_actions"]
        pick = torch.multinomial(avail.reshape(-1, avail.shape[-1]).float(), 1, generator=gen)
        state, obs, _, done, _ = env.step(state, pick.reshape(avail.shape[:2]))
        oms.append(obs["obs_mask"] & alive[:, None, None])
        ems.append(obs["entity_mask"] & alive[:, None])
        fills.append(alive)
        alive = alive & ~done
    om, em, filled = torch.stack(oms, 1), torch.stack(ems, 1), torch.stack(fills, 1)
    dead = (om | torch.eye(om.shape[-1], dtype=torch.bool, device=device)).all(-1) & ~em
    present = ~em & filled[..., None]
    return om, em, float(dead[present].float().mean()), env.env_info()["n_agents"]


# REFIL's imagined masks on the combat sets whose units differ most from
# 3-8sz's, Medivacs (which heal) and Colossi, by their short names
COMBAT_IMAGINED_SETS = {"3-8MMM_symmetric": "mmm", "3-8csz_symmetric": "csz"}


def combat_imagined_masks():
    """{scenario: (config, obs_mask, entity_mask, dead share, Na, imagine
    masks)}: one batch of the refil learner's (under sc2custom) a set, the
    bipartition drawn from a generator as the learner draws it."""
    from refil_torch.config import load_config
    from refil_torch.ops.masks import build_imagine_masks

    out = {}
    for s, scenario in enumerate(COMBAT_IMAGINED_SETS):
        cfg = load_config(alg="refil", env="sc2custom", overrides=[f"scenario={scenario}"])
        om, em, dead, na = combat_rollout_masks(cfg, scenario, cfg["batch_size"], seed=40 + s)
        out[scenario] = (cfg, om, em, dead, na, build_imagine_masks(
            om, em, na, agent_rows=False,
            generator=torch.Generator(device="cuda").manual_seed(50 + s)))
    return out


def combat_imagined_masks_cases(imagined, dtype=torch.float32):
    """The attention kernel on REFIL's own pre-masks at the combat learner's
    shapes (refil under sc2custom: batch 32 of 151 steps, Ne 16, Na 8, widths
    128), from rollouts of ``COMBAT_IMAGINED_SETS`` in which units die
    (``imagined``, ``combat_imagined_masks()``): ``build_imagine_masks`` on
    their obs and entity masks; the agent x3 call
    with the square pre-masks the RNN agent takes (full view, within,
    interact: Bp 14,496, 16 rows) and both imagined hypernet calls (within
    and interact, no obs mask: Bp 4,800 of the 150 trained steps, 16 rows),
    each post-masked by the agents' entity mask. Forward and gradients
    against the plain version, as ``check_case`` does; each row also carries
    its set and the rollout's dead share beside ``blocked_row_share``."""
    rows = []
    for s, (scenario, (cfg, om, em, dead, Na, m)) in enumerate(imagined.items()):
        Ne = em.shape[-1]
        post = em[..., :Na]
        cases = [("agent_x3", cfg["attn_embed_dim"],
                  torch.cat([om, m.within, m.interact]).reshape(-1, Ne, Ne),
                  torch.cat([post] * 3).reshape(-1, Na))]
        for half, mm in (("within", m.w_noobs), ("interact", m.i_noobs)):
            cases.append((f"mixer_imagined_{half}", cfg["hypernet_embed"],
                          mm[:, :-1].reshape(-1, Ne, Ne), post[:, :-1].reshape(-1, Na)))
        short = COMBAT_IMAGINED_SETS[scenario]
        for i, (tag, W, pre, qm) in enumerate(cases):
            row = check_case(f"{tag}_{short}", pre.shape[0], Ne, Na, W, W, W, HEADS, dtype,
                             mask_rows=Ne, seed=80 + 3 * s + i, path="combat_imagined",
                             masks=(pre.contiguous(), qm.contiguous()))
            row.update(scenario=scenario, dead_share=dead)
            emit("combat_imagined_masks", scenario=scenario, case=row["case"],
                 dtype=row["dtype"], Bp=row["Bp"], dead_share=dead,
                 blocked_row_share=row["blocked_row_share"])
            rows.append(row)
    return rows


# the combat env's kernels beside its op path (phase 3): (set, difficulty, B);
# the cells' own set and tier at their widths, Medivacs at the top tier,
# Colossi at the bottom, a ragged block of 37 envs; then the flat env's
# walled corridor through its core's step
COMBAT_ENV_CASES = (("3-8sz_symmetric", "7", 8), ("3-8sz_symmetric", "7", 4096),
                    ("3-8MMM_symmetric", "A", 37), ("3-8csz_symmetric", "1", 37),
                    ("3-8sz_symmetric", "4", 37))
COMBAT_ENV_STEPS = 40
# timed at the benchmark cells' widths, from a state this many steps in
COMBAT_ENV_TIMING = (8, 4096)
COMBAT_ENV_WARM_STEPS = 20


def combat_env_equal(what, got, ref):
    """The names of the tensors that differ (dtype, shape or any bit)."""
    return [f"{what}.{k}" for k in ref if got[k].dtype != ref[k].dtype
            or got[k].shape != ref[k].shape or not torch.equal(got[k], ref[k])]


def combat_env_walk(core, state, steps, gen, flat=None, check=True):
    """``steps`` env steps of uniformly random legal actions from ``state``,
    the kernels beside the op path from the same state each step when
    ``check`` (a finished env keeps its state, as the runner keeps it).
    Returns (state, actions of the last step, names of the tensors that
    differed, the share of battles that ended)."""
    from refil_torch.envs.combat.flat_env import FlatState

    B = state.t.shape[0]
    alive = torch.ones(B, dtype=torch.bool, device=state.t.device)
    bad, actions = [], None
    for t in range(steps):
        obs = core.observe(state)
        if check:
            bad += combat_env_equal(f"observe{t}", obs, core.observe_plain(state))
        avail = obs["avail_actions"] if flat is None else flat.get_avail_actions(
            FlatState(core=state, last_action=None))
        u = torch.rand(avail.shape, generator=gen, device=avail.device)
        actions = u.masked_fill(~avail, -1.0).argmax(-1)
        if flat is not None:
            actions = flat._to_entity_actions(actions, state)
        new, reward, done, info = core.step_state(state, actions)
        if check:
            ref = core.step_state_plain(state, actions)
            bad += combat_env_equal(
                f"step{t}", {**new._asdict(), "reward": reward, "done": done, **info},
                {**ref[0]._asdict(), "reward": ref[1], "done": ref[2], **ref[3]})
        state = type(state)(*[torch.where(alive.view((B,) + (1,) * (n.dim() - 1)), n, o)
                              for n, o in zip(new, state)])
        alive = alive & ~done
    return state, actions, bad, 1.0 - float(alive.float().mean())


def phase_combat_env(name_power):
    """The combat env's step and observation kernels against the op path on
    the card (``COMBAT_ENV_CASES``: every state, observation, reward, done
    and info tensor equal bit for bit, each step of ``COMBAT_ENV_STEPS``
    from a reset); then, at the cells' 3-8sz_symmetric tier 7 and B 8 and
    4096, each kernel's device time a step (its launches captured in a
    graph, so the host's issue is out) against its bytes bound and against
    the op path's device time (``combat_env`` and ``combat_env_time``
    lines)."""
    from refil_torch.envs.combat.env import EntityBattle
    from refil_torch.envs.combat.flat_env import FlatBattle
    from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY
    from refil_torch.ops import combat_env

    def entity_env(scenario, difficulty):
        return EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), difficulty=difficulty,
                            device="cuda")

    failed = []
    for scenario, difficulty, B in COMBAT_ENV_CASES:
        env = entity_env(scenario, difficulty)
        gen = torch.Generator(device="cuda").manual_seed(B + ord(difficulty))
        state, obs = env.reset(B, generator=gen)
        bad = combat_env_equal("reset", obs, env.observe_plain(state))
        _, _, walk_bad, ended = combat_env_walk(env, state, COMBAT_ENV_STEPS, gen)
        bad += walk_bad
        emit("combat_env", card=name_power, case=f"{scenario}/{difficulty}", B=B,
             steps=COMBAT_ENV_STEPS, ended_share=ended, ok=not bad, differ=bad[:20])
        failed += bad
    fenv = FlatBattle(map_name="corridor", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    fstate, _ = fenv.reset(37, generator=gen)
    _, _, bad, ended = combat_env_walk(fenv.core, fstate.core, COMBAT_ENV_STEPS, gen, flat=fenv)
    emit("combat_env", card=name_power, case="flat/corridor", B=37, steps=COMBAT_ENV_STEPS,
         ended_share=ended, ok=not bad, differ=bad[:20])
    failed += bad
    if failed:
        raise AssertionError(f"combat_env: the kernels differ from the op path: {failed[:20]}")

    env = entity_env("3-8sz_symmetric", "7")
    for B in COMBAT_ENV_TIMING:
        gen = torch.Generator(device="cuda").manual_seed(B)
        state, _ = env.reset(B, generator=gen)
        state, actions, _, _ = combat_env_walk(env, state, COMBAT_ENV_WARM_STEPS, gen,
                                               check=False)
        nbytes = combat_env.bytes_per_step(env, B)
        calls = {"combat_step": (lambda: env.step_state(state, actions),
                                 lambda: env.step_state_plain(state, actions)),
                 "combat_observe": (lambda: env.observe(state),
                                    lambda: env.observe_plain(state))}
        row = {}
        for name, (kernel, plain) in calls.items():
            row[name] = {"ms": device_ms(kernel, iters=50), "plain_ms": device_ms(plain),
                         "issue_ms": cuda_time_ms(kernel, iters=50),
                         "bytes": nbytes[name],
                         "bound_ms": nbytes[name] / PEAK_BYTES_PER_S * 1e3}
        emit("combat_env_time", card=name_power, case="3-8sz_symmetric/7", B=B, **row)


def phase_kernels(attn_rows, gru_rows):
    rows, imagined = [], combat_imagined_masks()
    for dtype in (torch.float32, torch.bfloat16):
        for i, (path, tag, Bp, ne, nq, mrows, w) in enumerate(attn_rows):
            rows.append(check_case(tag, Bp, ne, nq, w, w, w, HEADS, dtype, mask_rows=mrows,
                                   seed=i, timing=True, path=path))
        # Nq < Ne, Bp not a multiple of the block's samples, a pre-mask with
        # more rows than queries, and no pre-mask at all
        rows.append(check_case("nq_lt_ne", 37, 8, 5, 64, 64, 64, HEADS, dtype, mask_rows=8,
                               seed=11))
        rows.append(check_case("nq_lt_ne_no_pre_mask", 37, 8, 5, 64, 64, 64, HEADS, dtype,
                               pre=False, seed=12))
        rows.append(check_case("narrow_uneven", 3, 6, 6, 24, 32, 16, 2, dtype, seed=13))
        rows.append(check_case("combat_widths_uneven", 37, 16, 8, 128, 128, 128, HEADS, dtype,
                               mask_rows=16, seed=14))
        rows += imagined_masks_cases(dtype)
        rows += combat_imagined_masks_cases(imagined, dtype)
        for i, (tag, T, R) in enumerate(gru_rows):
            rows.append(check_gru(tag, T, R, GRU_HIDDEN, dtype, seed=20 + i, timing=True))
        if dtype == torch.float32:  # the flat slice's learner is float32
            for i, (tag, T, R) in enumerate(flat_gru_shapes()):
                rows.append(check_gru(tag, T, R, GRU_HIDDEN, dtype, seed=30 + i, timing=True,
                                      path="flat"))
        for T in GRU_PLAN_STEPS:
            for R in GRU_PLAN_ROWS:
                check_gru(f"plan_T{T}_R{R}", T, R, GRU_HIDDEN, dtype, seed=T + R)
    phase_gemm()
    return rows


# Kernel launches a learner iteration, a rollout step and a gt diagnostic
# make. refil_group_matching: 9 forward and 6 backward attention calls an
# iteration (agent x3 fwd+bwd, target agent fwd, mixer chosen path
# hyper_w_1 + V fwd+bwd, imagined path hyper_w_1 x2 + V fwd+bwd, target mixer
# hyper_w_1 + V fwd); a diagnostic is two imagine passes of agent +
# hyper_w_1 x2 + V; the FF agent runs no GRU. refil (combat): 15 forward and
# 10 backward attention calls (agent x3 fwd+bwd, target agent fwd, mixer
# chosen path hyper_w_1, hyper_b_1, hyper_w_final, V fwd+bwd, imagined path
# hyper_w_1 x2, hyper_b_1, hyper_w_final, V fwd+bwd, target mixer 4 fwd), 2
# GRU forwards (agent x3, target agent) and 1 GRU backward. A rollout step
# is one attention forward, and on combat one GRU forward (T = 1).
# qmix on the flat env: no attention; 2 GRU forwards (live and target
# agent) and 1 backward an iteration, one GRU forward (T = 1) a rollout step.
# The other combat configurations (CONFIG_RUNS; refil on MMM and csz is
# "combat"): qmix_atten 10 forward and 5 backward attention calls (agent
# fwd+bwd, target agent fwd, mixer hyper_w_1, hyper_b_1, hyper_w_final, V
# fwd+bwd, target mixer 4 fwd); vdn_atten and refil_vdn 2 and 1 (the agent,
# x3 for refil_vdn in one call, fwd+bwd, and the target agent fwd: VDNMixer
# is a sum); each 2 GRU forwards and 1 backward, a rollout step as combat's.
PER_ITER = {"group_matching": {"entity_attn_fwd": 9, "entity_attn_bwd": 6},
            "combat": {"entity_attn_fwd": 15, "entity_attn_bwd": 10, "gru_fwd": 2,
                       "gru_bwd": 1},
            "flat": {"gru_fwd": 2, "gru_bwd": 1},
            "qmix_atten": {"entity_attn_fwd": 10, "entity_attn_bwd": 5, "gru_fwd": 2,
                           "gru_bwd": 1},
            "vdn_atten": {"entity_attn_fwd": 2, "entity_attn_bwd": 1, "gru_fwd": 2,
                          "gru_bwd": 1},
            "refil_vdn": {"entity_attn_fwd": 2, "entity_attn_bwd": 1, "gru_fwd": 2,
                          "gru_bwd": 1}}
PER_STEP = {"group_matching": {"entity_attn_fwd": 1},
            "combat": {"entity_attn_fwd": 1, "gru_fwd": 1}, "flat": {"gru_fwd": 1},
            **{k: {"entity_attn_fwd": 1, "gru_fwd": 1}
               for k in ("qmix_atten", "vdn_atten", "refil_vdn")}}
PER_DIAG = {"group_matching": {"entity_attn_fwd": 8}, "combat": {}, "flat": {},
            "qmix_atten": {}, "vdn_atten": {}, "refil_vdn": {}}
GM_T_MAX = 8000  # 20 blocks of 400 env steps, 4 of them warm-up: 16 learner updates
# blocks of <= 8 x 150 env steps run while t_env <= 7200: >= 7 blocks; the
# ring holds batch_size 32 episodes after 4 blocks, so the classic loop,
# which trains from the 4th block on, makes >= 4 learner updates of 8
# iterations
CB_T_MAX = 7200
# the fused combat run: >= 2 dispatches of >= 2 train blocks after the 4
# warm-up blocks (a dispatch holds remaining // 1200 blocks, a power of two)
CB_FUSED_T_MAX = 9600
# the flat slice on 3m: blocks of <= 8 x 60 env steps, 4 warm-up blocks
# (batch_size 32), then >= 8 train blocks, a dispatch holding
# remaining // 480 blocks
FLAT_T_MAX = 6000
KERNEL_LAUNCHES = ("entity_attn_fwd", "entity_attn_bwd", "gru_fwd", "gru_bwd", "combat_step",
                   "combat_observe")
# The combat env's kernels (ops/combat_env.py) by path: on an entity combat
# env a rollout step is one combat_step and one combat_observe, and a reset
# one combat_observe (each rollout's, and the fused loop's one-env reset that
# sizes the ring, ``batch_spec``); a recording step keeps the op path for its
# render extras and launches only combat_observe. The flat env steps its
# core through combat_step and observes on its own ops: of its resets only
# its core's observation launches. Group Matching has no combat env.
ENV_KERNELS = {"group_matching": None, "flat": "flat"}


def expected_launches(path, iterations, rollout_steps, diag_calls, resets=0, record=False):
    """The launches of ``iterations`` learner iterations, ``rollout_steps``
    env steps (``record``: recording ones) in ``resets`` env resets and
    ``diag_calls`` gt diagnostics on ``path``."""
    out = dict.fromkeys(KERNEL_LAUNCHES + ("entity_attn_gemm",), 0)
    for table, n in ((PER_ITER, iterations), (PER_STEP, rollout_steps), (PER_DIAG, diag_calls)):
        for k, per in table[path].items():
            out[k] += per * n
    env = ENV_KERNELS.get(path, "entity")
    if env is not None:
        out["combat_step"] += 0 if record else rollout_steps
        out["combat_observe"] += resets + (rollout_steps if env == "entity" else 0)
    return out


def reset_launches():
    from refil_torch.ops import combat_env, entity_attn, gru_kernel

    entity_attn.reset_launches()
    gru_kernel.reset_launches()
    combat_env.reset_launches()


def read_launches(graphs=None):
    """The launches made since the last reset. The wrappers count in Python,
    where a capture records a block's launches without launching and a
    replay runs none of it: so each graph adds its recorded launches times
    its replays less the one count its capture left."""
    from refil_torch.ops import combat_env, entity_attn, gru_kernel

    out = {**entity_attn.launches, **gru_kernel.launches, **combat_env.launches}
    for g in (graphs or {}).values():
        for k in out:  # a mesh's graph also records its collectives
            out[k] += g["launches"].get(k, 0) * (g["replays"] - 1)
    return out


def run_slice(path, argv, name_power, min_updates, phase="slice", collectives=False):
    from refil_torch import main as tmain

    # no preemption guard in this process: a SIGTERM sent to the smoke must
    # stop it, not cut one run short and let the later phases go on
    argv = [*argv, "handle_preemption=False"]
    reset_launches()  # count only this path's launches
    t0 = time.perf_counter()
    summary = tmain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(summary.get("graphs"))
    loss = summary["last_metrics"].get("loss", float("nan"))
    per_iter = summary["iterations"] // max(summary["updates"], 1)
    rollouts = summary["blocks"] + summary["test_blocks"]
    expected = expected_launches(path, summary["iterations"], summary["episode_limit"] * rollouts,
                                 summary["diag_calls"],
                                 resets=rollouts + int(summary["loop"] == "fused"))
    row = dict(path=path, loop=summary["loop"],
               command="python -m refil_torch.main " + " ".join(argv),
               wall_seconds=wall, card=name_power, env_steps_per_s=summary["env_steps_per_s"],
               train_seconds=summary["train_seconds"], t_env=summary["t_env"],
               blocks=summary["blocks"], test_blocks=summary["test_blocks"],
               updates=summary["updates"], iterations=summary["iterations"],
               diag_calls=summary["diag_calls"], last_metrics=summary["last_metrics"],
               last_logged=summary["last_logged"],
               params_max_abs_change=summary["params_max_abs_change"], launches=launches,
               expected_launches=expected)
    if summary["loop"] == "fused":
        row["dispatches"] = summary["dispatches"]
        # every replayed train block: the train dispatches less the eager
        # first train block and the capture
        train = [d for d in summary["dispatches"] if d["train"]]
        seconds = sum(d["replay_seconds"] for d in train)
        blocks = row["replayed_train_blocks"] = sum(d["replays"] for d in train)
        row["replayed_train_env_steps_per_s"] = (
            sum(d["replay_env_steps"] for d in train) / seconds if blocks else None)
        row["replayed_train_seconds_per_block"] = seconds / blocks if blocks else None
    emit(phase, **row)
    if summary["updates"] < min_updates:
        raise AssertionError(f"{path}: only {summary['updates']} learner updates ran")
    if not math.isfinite(loss):
        raise AssertionError(f"{path}: loss is not finite: {loss}")
    if not summary["params_max_abs_change"] > 0:
        raise AssertionError(f"{path}: training did not change the parameters")
    if launches != expected or min(launches[k] for k in PER_ITER[path]) <= 0:
        raise AssertionError(f"{path}: kernel launches {launches} != expected {expected}")
    if summary["loop"] == "fused":
        check_graphs(path, summary, per_iter, name_power, collectives)
    return summary, launches


def check_graphs(path, summary, per_iter, name_power, collectives=False):
    """The fused run replayed every block after the first of its kind, and
    each capture recorded one block's launches; with ``collectives`` (a
    data mesh) also its collectives: one all_gather a block (its stats), one
    reduce_scatter a train block (the sample), one all_reduce of the
    block's mask counts and one an update."""
    graphs = summary["graphs"]
    warm = summary["blocks"] - summary["updates"]
    T = summary["episode_limit"]
    want = {"warm": (warm - 2, expected_launches(path, 0, T, 0, resets=1)),
            "train": (summary["updates"] - 2,
                      expected_launches(path, per_iter, T, int(summary["diag_calls"] > 0),
                                        resets=1))}
    if collectives:  # the stats' all_gather; the sample's exchange, the
        # mask counts' all_reduce and one an update (and the gt diagnostics')
        want["warm"][1].update(all_gather=1, all_reduce=0, reduce_scatter=0)
        want["train"][1].update(all_gather=1, reduce_scatter=1, all_reduce=per_iter + 1
                                + int(summary["diag_calls"] > 0))
    emit("graphs", path=path, card=name_power, **graphs)
    for kind, (replays, launches) in want.items():
        g = graphs.get(kind)
        if replays < 0:  # one block of its kind, run eagerly: nothing captured
            if g is not None:
                raise AssertionError(f"{path}: a {kind} graph for one block: {g}")
            continue
        if replays < 1 and kind == "warm":
            continue
        # the first block of a kind runs eagerly, the second is captured and
        # replayed, every later one replayed
        if g is None or g["replays"] != replays + 1 or g["launches"] != launches:
            raise AssertionError(f"{path}: {kind} graph {g} != {replays + 1} replays of "
                                 f"{launches}")


def phase_fused(path, name_power):
    argv = slice_argv(path, fused=True)
    if path in ("group_matching", "flat"):
        summary, launches = run_slice(path, argv, name_power, 8)
        if path == "flat" and "battle_won_mean" not in summary["last_logged"]:
            raise AssertionError("flat: the runner logged no battle_won_mean")
    else:
        summary, launches = run_slice(path, argv, name_power, 4)
        multi = [d for d in summary["dispatches"] if d["train"] and d["blocks"] >= 2]
        if len(multi) < 2:
            raise AssertionError(f"combat: fewer than 2 dispatches of >= 2 train blocks: "
                                 f"{summary['dispatches']}")
        if "battle_won_mean" not in summary["last_logged"]:
            raise AssertionError("combat: the runner logged no battle_won_mean")
    return launches


def phase_configs(name_power):
    """Phase 4b: each of CONFIG_RUNS through ``refil_torch.main``, launch
    counts reset before it and read after it, checked as a slice's
    (launches against the counts its shapes imply, finite last loss, every
    later block of a kind a replay of the recorded launches) and by
    ``checked_run``. Prints (``config_run``, ``graphs`` and ``config``
    lines) its env-steps/s (whole run and replayed train blocks), seconds a
    replayed block, dispatches, last metrics, the graphs' pools and capture
    seconds and the test rollouts. Then a replayed train block against an
    eager one from one cloned state for qmix_atten, whose mixer path no
    other phase captures (``phase_graph_vs_eager``), and the phase's
    seconds. Returns each run's launches."""
    t0 = time.perf_counter()
    launches = {name: checked_run("config", name, path, config_argv(name), name_power)
                for name, (path, _) in CONFIG_RUNS.items()}
    phase_graph_vs_eager(name_power, CONFIG_RUNS["qmix_atten_sz"][1],
                         phase="config_graph_vs_eager", path="qmix_atten")
    emit("configs_phase", card=name_power, seconds=time.perf_counter() - t0)
    return launches


def phase_classic(path, name_power):
    argv = slice_argv(path, fused=False)
    if path in ("group_matching", "flat"):
        run_slice(path, argv, name_power, 8)
    else:
        summary, _ = run_slice(path, argv, name_power, 4)
        if "battle_won_mean" not in summary["last_logged"]:
            raise AssertionError("combat: the runner logged no battle_won_mean")


def state_tensors(ps):
    """Every tensor a block changes: the ring, the counters, the parameters,
    the targets and the optimiser state."""
    out = {f"ring.{k}": v for k, v in ps.ring.items()}
    for n in ("buffer_index", "episodes_in_buffer", "t_env", "episode", "last_target_episode"):
        out[n] = getattr(ps, n)
    learner = ps.train
    for i, (p, t) in enumerate(zip(learner.params, learner.target_params)):
        out[f"param.{i}"], out[f"target.{i}"] = p.data, t.data
        for k, v in learner.optimiser.state[p].items():
            out[f"opt.{i}.{k}"] = v
    return out


def phase_graph_vs_eager(name_power, argv=None, phase="graph_vs_eager", path="combat"):
    """One combat train block eagerly and one as a graph replay, from one
    cloned state and cloned generator states: the ring planes and counters
    equal, the parameters, targets and optimiser state within 1e-4 of
    max(1, |p|) (PyTorch's backward kernels may sum with atomics). Before
    it, one eager train block under ``set_sync_debug_mode("error")``: the
    block waits for the device nowhere. After it, two replays must draw
    different actions (the generators are registered with the graph).
    ``argv``: the combat command line whose pipeline this builds (default:
    refil on 3-8sz_symmetric, whose pipeline then also restores a
    checkpoint in place), ``path`` the key of its launch counts in
    PER_ITER. Returns the pipeline and its state, for
    ``own_kernels_only``."""
    from refil_torch import config as tconfig
    from refil_torch import run as trun
    from refil_torch.core.pipeline import FusedPipeline
    from refil_torch.main import parse_cli

    alg, env, overrides = parse_cli(argv or ["--config=refil", "--env-config=entity_battle",
                                             "with", "scenario=3-8sz_symmetric"])
    cfg = tconfig.load_config(alg=alg, env=env, overrides=[*overrides, "use_cuda=True"])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    dev = torch.device("cuda", torch.cuda.current_device())
    reset_launches()
    runner, learner, gens = trun.build_training(args, None, dev)
    pipe = FusedPipeline(runner, learner, args.buffer_size, args)
    ps = pipe.init_state(gens["sample"])
    warm = pipe.warmup_blocks()
    for _ in range(warm):
        pipe.run_blocks(ps, 1, train=False)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.block_device(ps, train=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    snap = {k: v.clone() for k, v in state_tensors(ps).items()}
    gen_states = {k: g.get_state() for k, g in ps.generators.items()}
    eager_stats = pipe.run_blocks(ps, 1, train=True)  # the first of run_blocks: eager
    eager = {k: v.clone() for k, v in state_tensors(ps).items()}
    for k, v in state_tensors(ps).items():
        v.copy_(snap[k])
    for k, g in ps.generators.items():
        g.set_state(gen_states[k])
    graph_stats = pipe.run_blocks(ps, 1, train=True)  # captured, then replayed
    if "train" not in pipe.graphs:
        raise AssertionError("graph_vs_eager: the train block was not captured")
    graph = state_tensors(ps)
    exact = {k: torch.equal(eager[k], graph[k]) for k in eager
             if not k.startswith(("param", "target", "opt"))}
    scaled = {}
    for k in eager:
        if k.startswith(("param", "target", "opt")):
            group = k.split(".")[0] + ("" if not k.startswith("opt") else "." + k.split(".")[2])
            err = scaled_err(graph[k], eager[k])
            scaled[group] = max(scaled.get(group, 0.0), err)
    stats_equal = all(np.array_equal(eager_stats[k], graph_stats[k])
                      for k in ("ep_returns", "ep_lengths", "epsilon", "t_env"))
    metrics_err = {k: abs(float(graph_stats["metrics"][k][0] - eager_stats["metrics"][k][0]))
                   / max(1.0, abs(float(eager_stats["metrics"][k][0])))
                   for k in eager_stats["metrics"]}

    def last_block_actions():
        end = int(ps.buffer_index) or pipe.buffer_size
        return ps.ring["actions"][end - pipe.batch_size_run:end].clone()

    first = last_block_actions()
    pipe.run_blocks(ps, 1, train=True)
    differ = float((first != last_block_actions()).float().mean())

    graphs = {k: g.summary() for k, g in pipe.graphs.items()}
    launches = read_launches(graphs)
    T = runner.episode_limit
    n_train = 1 + 1 + 1 + 1  # sync-checked, eager, captured and replayed, replayed
    expected = {k: warm * a + n_train * b for (k, a), b in zip(
        expected_launches(path, 0, T, 0, resets=1).items(),
        expected_launches(path, args.training_iters, T, 0, resets=1).values())}
    expected["combat_observe"] += 1  # init_state's one-env reset (batch_spec)
    tol = 1e-4
    ok = (all(exact.values()) and all(v <= tol for v in scaled.values()) and stats_equal
          and differ > 0 and launches == expected)
    emit(phase, card=name_power, ok=ok, command=argv, exact=exact, scaled_err=scaled, tol=tol,
         stats_equal=stats_equal, metrics_scaled_err=metrics_err,
         replays_actions_differ_share=differ, sync_free_eager_block=True, graphs=graphs,
         launches=launches, expected_launches=expected)
    if not ok:
        raise AssertionError(f"{phase}: the replayed block disagrees with the eager one")
    if argv is None:
        check_restore_in_place(pipe, ps, name_power)
    return pipe, ps


def check_restore_in_place(pipe, ps, name_power, tol=1e-4):
    """After the train graph's capture: a checkpoint of the live state, ring
    included, is written (``run._save_checkpoint``), one more replay moves
    the state on, and the checkpoint is restored (``run._load_checkpoint``,
    ``run.restore_pipeline_state``): every tensor keeps its storage and
    gets back the saved values exactly, the generators their states. Then
    one replay from the restored state against one eager block from it
    (restored again): ring and counters equal, parameters, targets and
    optimiser state within ``tol`` of max(1, |p|), and the generators'
    states after each equal (a replay advances them as an eager block does)."""
    from refil_torch import run as trun

    path = fresh_dir(os.path.join(SMOKE_RESULTS, "restore_in_place"))
    torch.cuda.synchronize()
    saved = {k: v.clone() for k, v in state_tensors(ps).items()}
    saved_gens = {k: g.get_state() for k, g in ps.generators.items()}
    info = trun._save_checkpoint(path, ps.train, pstate=ps, include_buffer=True)
    pipe.run_blocks(ps, 1, train=True)  # a replay: the live state moves on
    ptrs = {k: v.data_ptr() for k, v in state_tensors(ps).items()}

    def restore():
        t0 = time.perf_counter()
        trun.restore_pipeline_state(ps, trun._load_checkpoint(path, ps.train))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def gen_states():
        return {k: g.get_state() for k, g in ps.generators.items()}

    load_seconds = restore()
    live = state_tensors(ps)
    in_place = set(live) == set(ptrs) and all(live[k].data_ptr() == ptrs[k] for k in live)
    exact = (all(torch.equal(live[k], saved[k]) for k in saved)
             and all(torch.equal(v, saved_gens[k]) for k, v in gen_states().items()))
    replays_before = pipe.graphs["train"].replays
    pipe.run_blocks(ps, 1, train=True)
    replayed = pipe.graphs["train"].replays == replays_before + 1
    by_replay = {k: v.clone() for k, v in state_tensors(ps).items()}
    gens_replay = gen_states()
    restore()
    pipe.block_device(ps, train=True)
    torch.cuda.synchronize()
    by_eager = state_tensors(ps)
    gens_equal = all(torch.equal(v, gens_replay[k]) for k, v in gen_states().items())
    ring_counters_equal = all(torch.equal(by_eager[k], by_replay[k]) for k in by_eager
                              if not k.startswith(("param", "target", "opt")))
    scaled = max(scaled_err(by_replay[k], by_eager[k]) for k in by_eager
                 if k.startswith(("param", "target", "opt")))
    ok = in_place and exact and replayed and gens_equal and ring_counters_equal and scaled <= tol
    emit("restore_in_place", card=name_power, ok=ok, checkpoint_bytes=info["bytes"],
         save_seconds=info["seconds"], load_seconds=load_seconds, tensors_kept_storage=in_place,
         restored_exact=exact, replayed=replayed, generator_states_equal=gens_equal,
         ring_counters_equal=ring_counters_equal, params_scaled_err=scaled, tol=tol)
    shutil.rmtree(path, ignore_errors=True)
    if not ok:
        raise AssertionError("restore_in_place: a replay from a restored state disagrees with "
                             "an eager block from it")


def resume_argv(tag, t_max, *extra):
    """A fused combat run at full width that logs every learner update."""
    return ["--config=refil", "--env-config=entity_battle", "with", "scenario=3-8sz_symmetric",
            "test_nepisode=8", f"t_max={t_max}", "learner_log_interval=1", "use_cuda=True",
            f"local_results_path={os.path.join(SMOKE_RESULTS, tag)}", *extra]


def fresh_dir(path):
    """Removes ``path`` and what it holds, raising where it cannot: a rerun
    in this checkout must not read the last run's files."""
    if os.path.lexists(path):
        shutil.rmtree(path)
    return path


def logged(results_dir, key):
    """[(t, value)] of ``key`` in a run's metrics JSONL; a line still being
    written (no newline yet) is left for the next read."""
    mdir = os.path.join(results_dir, "metrics")
    rows = []
    for fn in (os.listdir(mdir) if os.path.isdir(mdir) else []):
        with open(os.path.join(mdir, fn)) as f:
            rows += [json.loads(line) for line in f if line.endswith("\n")]
    return sorted((r["t"], r["value"]) for r in rows if r["key"] == key)


def checkpoint_dir(results_dir):
    """The one run token's directory of checkpoints under ``results_dir``."""
    root = os.path.join(results_dir, "models")
    (token,) = os.listdir(root)
    return os.path.join(root, token)


# the resume phase: run A saves at t_env ~ 400 (after its first dispatch),
# then every RESUME_SAVE_INTERVAL steps, and at its end; random play takes
# ~440 env steps a block, so the second save lands after the first train
# dispatch that replays (the warm-up ends at ~1,760, the first train block
# runs eagerly, the second is captured and replayed); run B resumes there
RESUME_T_MAX = 6000
RESUME_SAVE_INTERVAL = 2400


def phase_resume(name_power):
    """Run A (fused combat, save_model with the ring) and run B, resumed
    from A's first checkpoint after a dispatch of graph replays, to the same
    t_max: B's first block trains (the ring was restored), and every loss B
    logs equals A's at the same t_env, within 1e-5 of max(1, |loss|) (A's
    blocks there are replays, B's first is eager). Each run's launches are
    checked as a slice's. Returns (checkpoint directory, step) for the eval
    phase."""
    a_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "resume_A"))
    b_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "resume_B"))
    save = ["save_model=True", f"save_model_interval={RESUME_SAVE_INTERVAL}",
            "checkpoint_buffer=True"]
    sa, _ = run_slice("combat", resume_argv("resume_A", RESUME_T_MAX, *save), name_power, 4,
                      phase="resume_run")
    replayed_end, t = None, 0
    for d in sa["dispatches"]:
        t += d["env_steps"]
        if d["train"] and d["replays"] and replayed_end is None:
            replayed_end = t
    steps = [int(os.path.basename(x["path"])) for x in sa["saves"]]
    after = [st for st in steps if replayed_end is not None and replayed_end <= st < sa["t_env"]]
    if not after:
        raise AssertionError(f"resume: no checkpoint after the first replayed train dispatch "
                             f"(saves {steps}, replays end at {replayed_end})")
    step = after[0]
    ckpt = checkpoint_dir(a_dir)
    sb, _ = run_slice("combat", resume_argv("resume_B", RESUME_T_MAX, f"checkpoint_path={ckpt}",
                                            f"load_step={step}"), name_power, 2,
                      phase="resume_run")
    tail_a = [r for r in logged(a_dir, "loss") if r[0] > step]
    tail_b = [r for r in logged(b_dir, "loss") if r[0] > step]
    same_t = [t for t, _ in tail_a] == [t for t, _ in tail_b]
    diffs = [abs(va - vb) / max(1.0, abs(va)) for (_, va), (_, vb) in zip(tail_a, tail_b)]
    first_train = sb["dispatches"][0]["train"]
    saved = next(x for x in sa["saves"] if int(os.path.basename(x["path"])) == step)
    ok = bool(tail_a) and same_t and max(diffs) <= 1e-5 and first_train
    emit("resume", card=name_power, ok=ok, resume_step=step, saves=sa["saves"],
         checkpoint_bytes=saved["bytes"], save_seconds=saved["seconds"],
         load_seconds=sb["restored"]["seconds"], losses_compared=len(tail_a),
         same_t_env=same_t, max_scaled_loss_diff=max(diffs) if diffs else None,
         max_abs_loss_diff=max((abs(va - vb) for (_, va), (_, vb) in zip(tail_a, tail_b)),
                               default=None),
         bit_equal=tail_a == tail_b, b_first_dispatch_trains=first_train, tol=1e-5)
    if not ok:
        raise AssertionError("resume: the resumed run's losses disagree with the unbroken run's")
    # keep only the checkpoint the eval phase loads: each holds the 2.5 GB ring
    for st in steps:
        if st != step:
            shutil.rmtree(os.path.join(ckpt, str(st)), ignore_errors=True)
    return ckpt, step


def phase_preempt(name_power, deadline_s=300):
    """The CLI as a subprocess (fused combat at its default dispatch size,
    handle_preemption by default): SIGTERM once it has logged a loss; it
    must exit 0 saying it was preempted, with a checkpoint, and a resume
    from it (in this process) must train at once (the checkpoint held the
    ring) and log a loss past the preemption t_env. The subprocess's log
    tail is printed whenever a check fails."""
    a_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "preempt_A"))
    b_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "preempt_B"))
    log_path = os.path.join(SMOKE_RESULTS, "preempt_A.log")
    os.makedirs(SMOKE_RESULTS, exist_ok=True)
    cmd = [sys.executable, "-m", "refil_torch.main", *resume_argv("preempt_A", 10 ** 7)]
    t0 = time.perf_counter()
    rc = t_signal = t_exit = None
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=subprocess.STDOUT)
        try:
            # a_dir was empty at the start: any loss there is this run's
            while not logged(a_dir, "loss") and proc.poll() is None:
                if time.perf_counter() - t0 > deadline_s:
                    break
                time.sleep(0.5)
            if proc.poll() is None and logged(a_dir, "loss"):
                t_signal = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=deadline_s)
                t_exit = time.perf_counter()
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        text = f.read()
    root = os.path.join(a_dir, "models")
    tokens = os.listdir(root) if os.path.isdir(root) else []
    steps = ([int(n) for n in os.listdir(os.path.join(root, tokens[0])) if n.isdigit()]
             if len(tokens) == 1 else [])
    saved = (t_signal is not None and rc == 0 and "Preempted at t_env=" in text
             and bool(steps))
    row = dict(card=name_power, rc=rc, signalled=t_signal is not None,
               seconds_to_first_loss=None if t_signal is None else t_signal - t0,
               seconds_signal_to_exit=None if t_exit is None else t_exit - t_signal,
               checkpoint_steps=steps)
    if not saved:
        emit("preempt", ok=False, **row, log_tail=text[-3000:])
        raise AssertionError("preempt: SIGTERM after the first loss did not give exit 0, "
                             "the preemption line and a checkpoint (log tail above)")
    ckpt, preempt_t = os.path.join(root, tokens[0]), max(steps)
    sb, launches = run_slice("combat", resume_argv("preempt_B", preempt_t + 1,
                                                   f"checkpoint_path={ckpt}"), name_power, 1,
                             phase="resume_run")
    past = [t for t, _ in logged(b_dir, "loss") if t > preempt_t]
    ok = sb["dispatches"][0]["train"] and bool(past)
    emit("preempt", ok=ok, **row, preempt_t_env=preempt_t,
         checkpoint_bytes=os.path.getsize(os.path.join(ckpt, str(preempt_t), "state.pt")),
         resume_first_dispatch_trains=sb["dispatches"][0]["train"], losses_past_preempt=past,
         resume_launches=launches, log_tail=None if ok else text[-3000:])
    if not ok:
        raise AssertionError("preempt: the resume from the preemption checkpoint did not train "
                             "at once and past it")
    shutil.rmtree(ckpt, ignore_errors=True)


def phase_eval(name_power, ckpt, step):
    """An eval-only run of run A's checkpoint over every scenario of
    3-8sz_symmetric, each one greedy rollout of the config's test_nepisode
    envs on that scenario: finite stats for every scenario, and the launches
    one attention forward, one GRU forward, one combat_step and one
    combat_observe a step of each rollout, and one combat_observe its
    reset."""
    from refil_torch import main as tmain

    argv = eval_argv(ckpt, step)
    fresh_dir(os.path.join(SMOKE_RESULTS, "eval"))
    reset_launches()
    t0 = time.perf_counter()
    summary = tmain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    res, secs = summary["eval"], summary["eval_seconds"]
    steps = summary["episode_limit"] * len(secs)
    expected = expected_launches("combat", 0, steps, 0, resets=len(secs))
    with open(os.path.join(SMOKE_RESULTS, "eval", "eval.json")) as f:
        written = json.load(f)
    finite = all(math.isfinite(v) for r in res.values() for v in r.values())
    ok = (summary["loop"] == "evaluate" and summary["restored"]["t_env"] == step and finite
          and written == res and len(res) == len(secs) > 1 and launches == expected)
    emit("eval", card=name_power, ok=ok, command="python -m refil_torch.main " + " ".join(argv),
         wall_seconds=wall, scenarios=len(res), episodes_per_scenario=summary["eval_episodes"],
         seconds_per_scenario=secs,
         battle_won_mean={k: r.get("test_battle_won_mean") for k, r in res.items()},
         launches=launches, expected_launches=expected)
    if not ok:
        raise AssertionError("eval: the eval-only run failed its checks")


# ---------------------------------------------------------------- slice 8
HEURISTIC_SCENARIOS = ("3-8MMM_symmetric", "3-8sz_symmetric")
HEURISTIC_ENVS, HEURISTIC_STEPS = 256, 20


def _to(state, dev):
    return type(state)(*(v.to(dev) for v in state))


def check_heuristic_on_card(name_power):
    """``heuristic_actions`` on the card against the port's on the CPU for the
    same states: a CPU rollout of HEURISTIC_STEPS steps driven by the CPU
    heuristic, each state copied to the card, both emit modes, integer-equal,
    each card call under ``set_sync_debug_mode("error")`` (a captured block
    holds it). A mismatch is printed with the distances it chose between."""
    from refil_torch.envs.combat.env import EntityBattle, _norm
    from refil_torch.envs.combat.scenarios import SCENARIO_REGISTRY

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for scenario in HEURISTIC_SCENARIOS:
        for rest in (False, True):
            cpu = EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), heuristic_rest=rest)
            card = EntityBattle(scenario_dict=SCENARIO_REGISTRY[scenario](), heuristic_rest=rest,
                                device=dev)
            state, obs = cpu.reset(HEURISTIC_ENVS, generator=torch.Generator().manual_seed(5))
            mismatches, compared = [], 0
            for t in range(HEURISTIC_STEPS):
                want = cpu.heuristic_actions(state, obs["avail_actions"])
                on_card, avail = _to(state, dev), obs["avail_actions"].to(dev)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = card.heuristic_actions(on_card, avail)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                got = got.cpu()
                compared += got.numel()
                for b, a in torch.nonzero(got != want).tolist()[:5]:
                    d = _norm(state.a_pos[b, a][None] - state.e_pos[b]).tolist()
                    mismatches.append({"step": t, "env": b, "agent": a, "cpu": int(want[b, a]),
                                       "card": int(got[b, a]), "enemy_distances": d})
                state, obs, _, _, _ = cpu.step(state, want)
            rows.append({"scenario": scenario, "heuristic_rest": rest, "actions": compared,
                         "mismatches": mismatches})
    ok = all(not r["mismatches"] for r in rows)
    emit("heuristic_check", card=name_power, ok=ok, steps=HEURISTIC_STEPS,
         envs=HEURISTIC_ENVS, cases=rows, sync_free=True)
    if not ok:
        raise AssertionError("heuristic: the card's actions differ from the CPU's")


def phase_heuristic(name_power):
    """The heuristic on the card against the CPU; then the fused combat
    slice's run (phase 4's command, logging every block) with and without
    ``env_args.heuristic_ai=True``, launch counts checked as the slice's:
    with it, each later block replays a graph that holds the heuristic.
    Prints both runs' env-steps/s, seconds a replayed train block and win
    share over their logged training blocks."""
    check_heuristic_on_card(name_power)
    runs = {}
    for tag, extra in (("heuristic", ["env_args.heuristic_ai=True"]), ("learner", [])):
        out = fresh_dir(os.path.join(SMOKE_RESULTS, f"heuristic_{tag}"))
        argv = [a for a in slice_argv("combat", fused=True)
                if not a.startswith("local_results_path=")]
        summary, _ = run_slice("combat", [*argv, *extra, "runner_log_interval=1",
                                          f"local_results_path={out}"], name_power, 4,
                               phase="heuristic_run")
        won = [v for _, v in logged(out, "battle_won_mean")]
        runs[tag] = {"env_steps_per_s": summary["env_steps_per_s"],
                     "replayed_train_seconds_per_block": _replayed(summary),
                     "battle_won_mean": float(np.mean(won)) if won else None,
                     "blocks_logged": len(won),
                     "ep_length_mean": float(np.mean([v for _, v in
                                                      logged(out, "ep_length_mean")]))}
    ok = all(r["battle_won_mean"] is not None for r in runs.values())
    emit("heuristic", card=name_power, ok=ok, **runs)
    if not ok:
        raise AssertionError("heuristic: a run logged no battle_won_mean")


RENDER_KEYS = ("pos", "health", "shield", "health_max", "shield_max", "type", "active",
               "is_ally", "target", "facing", "facing_valid", "cd_ratio")


def phase_record(name_power, ckpt, step):
    """An eval-only run of run A's checkpoint (one greedy rollout of the
    config's test_nepisode envs over drawn scenarios) with ``save_replay``,
    and ``video_path`` where matplotlib and imageio import (else the video
    is null, with the import error). The replay has the JAX package's keys
    and one frame a step; its frame 0 is the eval rollout's reset state
    after one step: the phase rebuilds that state from the test generator's
    seed, steps it with the restored agent's greedy actions, and requires
    frame 0's positions to equal it exactly (and its types and active
    slots the reset's). Launches: one attention and one GRU forward a step,
    one combat_observe a step and the reset's, and no combat_step (a
    recording step keeps the op path for its render extras)."""
    from refil_torch import config as tconfig
    from refil_torch import main as tmain
    from refil_torch import run as trun
    from refil_torch.main import parse_cli

    out_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "record"))
    missing = []
    for module in ("matplotlib", "imageio"):
        try:
            __import__(module)
        except ImportError as e:
            missing.append(f"{type(e).__name__}: {e}")
    no_video = "; ".join(missing) or None
    argv = ["--config=refil", "--env-config=entity_battle", "with", "scenario=3-8sz_symmetric",
            f"checkpoint_path={ckpt}", f"load_step={step}", "use_cuda=True", "save_replay=True",
            f"local_results_path={out_dir}"]
    if no_video is None:
        argv.append(f"video_path={os.path.join(out_dir, 'eval')}")
    reset_launches()
    t0 = time.perf_counter()
    summary = tmain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    T = summary["episode_limit"]
    z = np.load(summary["replay"])
    keys_ok = sorted(z.files) == sorted(RENDER_KEYS)
    frames_ok = keys_ok and all(z[k].shape[0] == T for k in RENDER_KEYS)

    # the eval rollout's first step, rebuilt
    alg, env_name, overrides = parse_cli(argv)
    args = tconfig.config_to_args(tconfig.args_sanity_check(tconfig.load_config(
        alg=alg, env=env_name, overrides=overrides)))
    dev = trun.resolve_device(args)
    runner, learner, gens = trun.build_training(args, None, dev)
    trun._load_checkpoint(os.path.join(ckpt, str(step)), learner)
    n = summary["eval_episodes"]
    with torch.no_grad():
        state, obs = runner.env.reset(n, generator=gens["test"], test=True)
        q, _ = runner.mac.forward_step(obs, torch.zeros((n, runner.n_agents, runner.n_actions),
                                                       device=dev),
                                       runner.mac.init_hidden(n))
        greedy = q.masked_fill(~obs["avail_actions"], float("-inf")).argmax(-1)
        after = runner.env.render_state(runner.env.step(state, greedy)[0])
    reset = {k: v.cpu().numpy() for k, v in runner.env.render_state(state).items()}
    first_ok = frames_ok and bool(
        np.array_equal(z["pos"][0], after["pos"].cpu().numpy())
        and all(np.array_equal(z[k][0], reset[k]) for k in ("type", "active", "is_ally")))
    video = summary["video"]
    video_ok = no_video is not None or (video is not None and os.path.getsize(video) > 0)
    expected = expected_launches("combat", 0, T, 0, resets=1, record=True)
    ok = (summary["loop"] == "evaluate" and keys_ok and frames_ok and first_ok and video_ok
          and launches == expected)
    emit("record", card=name_power, ok=ok, command="python -m refil_torch.main " + " ".join(argv),
         wall_seconds=wall, seconds_per_scenario=summary["eval_seconds"], episodes=n,
         replay=summary["replay"], replay_bytes=os.path.getsize(summary["replay"]),
         replay_keys=sorted(z.files), frames=int(z["pos"].shape[0]) if keys_ok else None,
         frame0_positions_equal_rebuilt_step=first_ok, video=video,
         video_bytes=os.path.getsize(video) if video else None,
         video_reason=no_video, battle_won_mean=summary["eval"].get("test_battle_won_mean"),
         launches=launches, expected_launches=expected)
    if not ok:
        raise AssertionError("record: the recorded eval failed its checks")
    shutil.rmtree(ckpt, ignore_errors=True)


DIST_T_MAX = 6000


def phase_distributed(name_power):
    """A fused combat run at full width with ``distributed=True`` as one
    NCCL process, the sharded ring's path, against the undistributed run at
    the same seed, each saving a checkpoint with the ring: every loss logged
    (each update) equal within 1e-5 of max(1, |loss|), both runs' launches
    checked as a slice's, and the distributed graphs' recorded collectives
    (``check_graphs``): the train graph's all_gather carries fewer bytes
    than one episode (the stats, no episode plane). The rank's ring holds
    what the undistributed ring holds (world size 1), and the mesh run's
    last checkpoint, restored into an undistributed pipeline, gives its ring
    the undistributed run's bytes exactly. At world size 1 NCCL launches no
    kernel for a sum (its all_gather and reduce_scatter are device copies,
    its in-place all_reduce nothing), so equal losses over the replayed
    blocks are what show the captured copies replay."""
    import torch.distributed as dist

    from refil_torch.parallel.gate import free_port

    off_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "dist_off"))
    on_dir = fresh_dir(os.path.join(SMOKE_RESULTS, "dist_on"))
    # a checkpoint with the ring after the first dispatch and at the end
    save = ["save_model=True", f"save_model_interval={10 * DIST_T_MAX}",
            "checkpoint_buffer=True"]
    s_off, _ = run_slice("combat", resume_argv("dist_off", DIST_T_MAX, *save), name_power, 4,
                         phase="distributed_run")
    s_on, _ = run_slice("combat", resume_argv(
        "dist_on", DIST_T_MAX, *save, "distributed=True", "num_processes=1", "process_id=0",
        f"coordinator_address=127.0.0.1:{free_port()}"), name_power, 4,
        phase="distributed_run", collectives=True)
    a, b = logged(off_dir, "loss"), logged(on_dir, "loss")
    same_t = [t for t, _ in a] == [t for t, _ in b]
    diffs = [abs(va - vb) / max(1.0, abs(va)) for (_, va), (_, vb) in zip(a, b)]
    train = s_on["graphs"]["train"]
    moved = train.get("collective_bytes", {})
    episode_bytes = s_off["ring_bytes"] // s_off["ring_episodes"]
    ring_same = (s_on["ring_bytes"] == s_off["ring_bytes"] == s_on["ring_bytes_world"]
                 and s_on["ring_episodes"] == s_off["ring_episodes"])
    restored = restore_mesh_ring(s_on, s_off)
    ok = (bool(a) and same_t and max(diffs) <= 1e-5 and s_on["world_size"] == 1
          and not dist.is_initialized() and train["launches"].get("reduce_scatter") == 1
          and 0 < moved.get("all_gather", 0) < episode_bytes and ring_same
          and restored["ring_bit_equal"] and restored["counters_equal"])
    emit("distributed", card=name_power, ok=ok, backend="nccl", world_size=s_on["world_size"],
         losses_compared=len(a), same_t_env=same_t, max_scaled_loss_diff=max(diffs, default=None),
         bit_equal=a == b, tol=1e-5, train_graph_launches=train["launches"],
         train_graph_collective_bytes=moved, episode_bytes=episode_bytes,
         ring_bytes=s_on["ring_bytes"], ring_episodes=s_on["ring_episodes"],
         ring_bytes_world=s_on["ring_bytes_world"],
         undistributed_ring_bytes=s_off["ring_bytes"], **restored,
         env_steps_per_s=s_on["env_steps_per_s"],
         undistributed_env_steps_per_s=s_off["env_steps_per_s"],
         replayed_seconds_per_block=_replayed(s_on),
         undistributed_replayed_seconds_per_block=_replayed(s_off))
    shutil.rmtree(off_dir, ignore_errors=True)
    shutil.rmtree(on_dir, ignore_errors=True)
    if not ok:
        raise AssertionError("distributed: the one-process NCCL run disagrees with the "
                             "undistributed run")


def restore_mesh_ring(s_on, s_off):
    """The mesh run's last checkpoint (its ring gathered in global slot
    order) restored, as a resume does, into a fresh undistributed combat
    pipeline on the card; its ring and counters against the undistributed
    run's last checkpoint, bit for bit."""
    from refil_torch import config as tconfig
    from refil_torch import run as trun
    from refil_torch.core.pipeline import FusedPipeline

    on, off = s_on["saves"][-1], s_off["saves"][-1]
    payload_off = torch.load(os.path.join(off["path"], trun.STATE_FILE), map_location="cpu",
                             weights_only=True)["pipeline"]
    argv = resume_argv("dist_restore", DIST_T_MAX)
    cfg = tconfig.load_config(alg="refil", env="entity_battle", overrides=argv[3:])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    device = torch.device("cuda", torch.cuda.current_device())
    runner, learner, gens = trun.build_training(args, None, device)
    pipe = FusedPipeline(runner, learner, args.buffer_size, args)
    ps = pipe.init_state(gens["sample"])
    t0 = time.perf_counter()
    trun.restore_pipeline_state(ps, trun._load_checkpoint(on["path"], learner))
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    ring_equal = set(ps.ring) == set(payload_off["ring"]) and all(
        torch.equal(v.cpu().view(torch.uint8), payload_off["ring"][k].view(torch.uint8))
        for k, v in ps.ring.items())
    counters = all(int(getattr(ps, k)) == payload_off[k] for k in trun.PIPELINE_COUNTERS)
    out = {"ring_bit_equal": ring_equal, "counters_equal": counters,
           "checkpoint_t_env": [payload_off["t_env"], int(ps.t_env)],
           "checkpoint_bytes": on["bytes"], "undistributed_checkpoint_bytes": off["bytes"],
           "save_seconds": on["seconds"], "undistributed_save_seconds": off["seconds"],
           "ring_gather_device_bytes": on.get("ring_gather_bytes"),
           "restore_seconds": load_seconds}
    del ps, pipe, runner, learner, payload_off
    torch.cuda.empty_cache()
    return out


def _replayed(summary):
    train = [d for d in summary["dispatches"] if d["train"]]
    blocks = sum(d["replays"] for d in train)
    return sum(d["replay_seconds"] for d in train) / blocks if blocks else None


def checked_run(phase, name, path, argv, name_power, extra=lambda summary: ({}, {})):
    """One run of phase 4b or 13 through ``run_slice`` (its ``<phase>_run``
    line holds the rates, dispatches and last metrics, the ``graphs`` line
    the captures), its results in a fresh directory; then >= 2 dispatches of
    >= 2 replayed train blocks, every logged loss and grad_norm finite, on
    combat a battle_won_mean logged, and the checks ``extra(summary)``
    returns beside its fields for the ``<phase>`` line. Returns the run's
    launches."""
    out = fresh_dir(os.path.join(SMOKE_RESULTS, name))
    summary, launches = run_slice(path, argv, name_power, 4, phase=f"{phase}_run")
    replayed = [d["replays"] for d in summary["dispatches"] if d["train"]]
    logged_vals = {k: [v for _, v in logged(out, k)] for k in ("loss", "grad_norm")}
    row, more = extra(summary)
    checks = {
        "two_dispatches_of_two_replays": sum(r >= 2 for r in replayed) >= 2,
        "finite_losses": all(vals and all(map(math.isfinite, vals))
                             for vals in logged_vals.values()),
        "battle_won_logged": (path == "group_matching"
                              or "battle_won_mean" in summary["last_logged"]),
        **more,
    }
    emit(phase, ok=all(checks.values()), checks=checks, run=name, card=name_power,
         replays_per_train_dispatch=replayed, tests=summary["tests"],
         losses_logged=len(logged_vals["loss"]), **row)
    if not all(checks.values()):
        raise AssertionError(f"{phase} {name}: failed {[k for k, v in checks.items() if not v]}")
    return launches


def phase_scale(name_power):
    """Each of SCALE_RUNS through ``refil_torch.main``, launch counts reset
    before it and read after it, checked as a slice's (launches, finite last
    loss, every later block of a kind a replay); then, for each: >= 2
    dispatches of >= 2 replayed train blocks, >= 1 test rollout of
    batch_size_run envs, every logged loss and grad_norm finite and, on
    combat, a battle_won_mean logged. Prints (``scale_run``, ``graphs``
    and ``scale`` lines) its env-steps/s (whole run and replayed train
    blocks), seconds a replayed block, dispatches, last metrics, graphs,
    test rollouts, ring bytes and peak device memory. Then a replayed
    train block against an eager one from one cloned state at
    combat_b512_bf16 (``phase_graph_vs_eager``). Returns each run's launches."""
    t0 = time.perf_counter()
    launches = {}
    for name, (path, _) in SCALE_RUNS.items():
        argv = scale_argv(name)
        bsr = n_test_episodes(argv)[0]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()

        def memory_and_tests(summary):
            row = dict(batch_size_run=bsr, ring_bytes=summary["ring_bytes"],
                       allocated_before_bytes=before,
                       max_memory_allocated=torch.cuda.max_memory_allocated(),
                       max_memory_reserved=torch.cuda.max_memory_reserved())
            return row, {"b_wide_test_rollout": bool(summary["tests"]) and all(
                t["episodes"] == bsr for t in summary["tests"])}

        launches[name] = checked_run("scale", name, path, argv, name_power, memory_and_tests)
    phase_graph_vs_eager(name_power, SCALE_RUNS["combat_b512_bf16"][1],
                         phase="scale_graph_vs_eager")
    emit("scale_phase", card=name_power, seconds=time.perf_counter() - t0)
    return launches


def kernels_line(rows, launches_by_path, launches_by_run):
    """One entry per ported kernel, its numbers from the largest call of the
    combat slice in float32 (attention: agent x3, Bp = 14496; GRU: agent x3,
    T = 151, R = 768); ``launches`` from the combat slice's run, and the
    Group Matching and flat slices' and each config and scale run's beside
    it; the attention's also its rows on REFIL's imagined masks from the
    3-8MMM and 3-8csz rollouts (``combat_imagined``)."""
    attn = next(r for r in rows if r["kernel"] == "entity_attn" and r["path"] == "combat"
                and r["case"] == "agent_x3" and r["dtype"] == "float32")
    gru = next(r for r in rows if r["kernel"] == "gru" and r["case"] == "agent_x3"
               and r["dtype"] == "float32")
    bf16 = {k: next(r for r in rows if r["kernel"] == k and r["case"] == "agent_x3"
                    and r.get("path") == "combat" and r["dtype"] == "bfloat16")
            for k in ("entity_attn", "gru")}
    imagined = [r for r in rows if r.get("path") == "combat_imagined"]
    out = []
    for row, kind, name, source, replaces in (
            (attn, "fwd", "entity_attn_fwd", "entity_attn.cu", "pallas_attn.py:87"),
            (attn, "bwd", "entity_attn_bwd", "entity_attn.cu", "pallas_attn.py:224"),
            (gru, "fwd", "gru_fwd", "gru.cu", "pallas_gru.py:113"),
            (gru, "bwd", "gru_bwd", "gru.cu", "pallas_gru.py:136")):
        b = bf16[row["kernel"]]
        out.append({
            "name": name, "route": "cuda", "source": f"refil_torch/csrc/{source}",
            "replaces": f"refil_tpu/ops/{replaces}",
            "launches": launches_by_path["combat"][name],
            "launches_group_matching": launches_by_path["group_matching"][name],
            "launches_flat": launches_by_path["flat"][name],
            **{f"launches_{run}": n[name] for run, n in launches_by_run.items()},
            "max_abs_err": row[f"{kind}_max_abs_err"], "ms": row["ms"][kind],
            "plain_ms": row["ms"][f"{kind}_plain"], "bound_ms": row[f"{kind}_bound_ms"],
            "bound_by": row[f"{kind}_bound_by"], "library_ms": row["ms"][f"{kind}_library"],
            # the same call in bfloat16 (the attention's products on the tensor cores)
            "bf16": {"max_abs_err": b[f"{kind}_max_abs_err"], "ms": b["ms"][kind],
                     "plain_ms": b["ms"][f"{kind}_plain"], "bound_ms": b[f"{kind}_bound_ms"],
                     "bound_by": b[f"{kind}_bound_by"],
                     "library_ms": b["ms"][f"{kind}_library"],
                     # the GRU's yardstick is float32's where PyTorch refuses bf16
                     "library_dtype": b.get("library_dtype", "bfloat16")},
            # REFIL's imagined pre-masks from the combat sets' rollouts
            **({"combat_imagined": [
                {"case": r["case"], "dtype": r["dtype"], "Bp": r["Bp"],
                 "blocked_row_share": r["blocked_row_share"], "dead_share": r["dead_share"],
                 "max_abs_err": r[f"{kind}_max_abs_err"],
                 **({"scaled_err": max(r["bwd_scaled_err"].values())} if kind == "bwd" else {})}
                for r in imagined]} if row["kernel"] == "entity_attn" else {}),
        })
    return {"kernels": out}


SLICES = ("group_matching", "combat", "flat")


def main(argv) -> None:
    kernels_only = "--kernels-only" in argv
    if not os.path.isdir(os.path.join(HERE, "refil_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    name_power = phase_device()
    attn_rows, gru_rows = attn_shapes(), gru_shapes()
    new_attn, new_gru = config_shapes(attn_rows, gru_rows)
    attn_rows, gru_rows = attn_rows + new_attn, gru_rows + new_gru
    phase_sass(phase_build(attn_rows, gru_rows))
    rows = phase_kernels(attn_rows, gru_rows)
    phase_combat_env(name_power)
    replay = None
    if not kernels_only:
        launches = {path: phase_fused(path, name_power) for path in SLICES}
        configs = phase_configs(name_power)
        for path in SLICES:
            phase_classic(path, name_power)
        replay = (*phase_graph_vs_eager(name_power), name_power)
        ckpt, step = phase_resume(name_power)
        phase_preempt(name_power)
        phase_eval(name_power, ckpt, step)
        phase_heuristic(name_power)
        phase_record(name_power, ckpt, step)
        phase_distributed(name_power)
        scale = phase_scale(name_power)
    # last: once torch.profiler has run in a process, every later kernel
    # launch there is slower, and the slices' env-steps/s would show it
    own_kernels_only(replay)
    if kernels_only:
        return
    print(name_power, flush=True)
    print(json.dumps(kernels_line(rows, launches, {**configs, **scale})), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
