"""Experiment orchestration, port of ``refil_tpu/run.py`` (``run`` ->
``run_sequential``, ``:312-503``, and ``_run_fused_loop``, ``:505-654``).

Two training loops, as in the JAX package:

* the fused loop (``use_fused_pipeline``, the default, unless the ring is
  kept on the host with ``buffer_cpu_only``): ``core/pipeline.py`` runs each
  episode block (rollout, ring insert, sample, ``training_iters`` updates,
  target sync) with no host sync, on CUDA as a replayed CUDA graph, up to
  ``max_blocks_per_dispatch`` blocks between the host's test and log
  boundaries in one dispatch, with one fetch of their stats;
* the classic loop (``use_fused_pipeline=False`` or ``buffer_cpu_only``):
  each block a rollout, a ring insert, and, once the ring holds
  ``batch_size`` episodes, ``training_iters`` learner updates on
  ``sample_many`` samples, with the host between the stages.

Then, in both, the periodic greedy test runs and logging. Not ported yet,
and refused with ``NotImplementedError`` when asked for: checkpoints,
resume, preemption handling, eval-only runs, the mesh, multi-process runs
and TensorBoard.

Device: ``use_cuda`` (default True) runs on the CUDA card and raises where
there is none; ``use_cuda=False`` runs on the CPU.
"""
from __future__ import annotations

import datetime
import pprint
import time
from os.path import join
from typing import Any, Dict

import numpy as np
import torch

from .config import args_sanity_check, config_to_args
from .controllers.mac import MAC_REGISTRY
from .core.buffer import ReplayBuffer
from .core.pipeline import FusedPipeline
from .envs import ENV_REGISTRY
from .envs.combat.scenarios import SCENARIO_REGISTRY
from .learners.q_learner import QLearner
from .runners.vector_runner import VectorRunner
from .utils.logging import Logger, get_logger
from .utils.profiling import PhaseTimer
from .utils.timehelper import time_left, time_str

# config keys whose feature is not ported yet -> the ROADMAP item that holds it
_UNPORTED = {
    "checkpoint_path": "checkpoint load/resume (ROADMAP queue A item 9)",
    "save_model": "checkpoint save (ROADMAP queue A item 9)",
    "handle_preemption": "preemption handling (ROADMAP queue A item 9)",
    "evaluate": "eval-only runs (ROADMAP queue A item 9)",
    "save_replay": "replays (ROADMAP queue A item 9)",
    "use_tensorboard": "TensorBoard logging (ROADMAP queue A item 9)",
    "mesh_shape": "the device mesh (ROADMAP queue A item 11)",
    "distributed": "multi-process runs (ROADMAP queue A item 11)",
    "heuristic_ai": "the scripted ally policy (heuristic_actions, ROADMAP queue A item 7)",
}


def resolve_device(args) -> torch.device:
    """The card when ``use_cuda`` (the default), else the CPU. Never falls
    back: ``use_cuda`` without a CUDA device raises."""
    if bool(getattr(args, "use_cuda", True)):
        if not torch.cuda.is_available():
            raise RuntimeError("use_cuda=True but no CUDA device is available; pass "
                               "use_cuda=False to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def refuse_unported(args) -> None:
    for key, what in _UNPORTED.items():
        if getattr(args, key, None):
            raise NotImplementedError(f"{key}={getattr(args, key)!r}: {what} is not ported "
                                      "to refil_torch yet")
    # the reference ships the scripted-ally knobs under env_args as well
    for key in ("heuristic_ai", "heuristic_rest"):
        if args.env_args.get(key):
            raise NotImplementedError(f"env_args.{key}=True: the scripted ally policy "
                                      "(heuristic_actions, ROADMAP queue A item 7) is not "
                                      "ported to refil_torch yet")
    if args.env not in ENV_REGISTRY:
        item = _UNPORTED_ENVS.get(args.env, "ROADMAP queue A")
        raise NotImplementedError(f"env {args.env!r} is not ported yet ({item}); ported: "
                                  f"{sorted(ENV_REGISTRY)}")


# envs the JAX package has and the port does not yet -> the ROADMAP item
_UNPORTED_ENVS = {
    "flat_battle": "the flat path, ROADMAP queue A item 10",
    "sc2custom": "the reference's name for entity_battle, ROADMAP queue A item 7; use "
                 "env=entity_battle",
}


def build_env(args, device: torch.device):
    """The env of ``args.env``; the combat env takes its scenario set from
    the registry by ``args.scenario``, as ``refil_tpu/run.py:build_env`` does."""
    env_args = dict(args.env_args)
    if args.env == "entity_battle":
        env_args["scenario_dict"] = SCENARIO_REGISTRY[args.scenario]()
    return ENV_REGISTRY[args.env](**env_args, device=device)


def run(config: Dict[str, Any]) -> Dict[str, Any]:
    """Runs one experiment; returns ``run_sequential``'s summary."""
    config = args_sanity_check(config)
    args = config_to_args(config)
    refuse_unported(args)
    device = resolve_device(args)
    logger = Logger(get_logger())
    logger.console_logger.info("Experiment Parameters:\n\n%s\n",
                               pprint.pformat(config, indent=4, width=1))
    args.unique_token = "{}__{}".format(
        args.name, datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f"))
    logger.setup_jsonl(join(args.local_results_path, "metrics", args.unique_token + ".jsonl"))
    try:
        summary = run_sequential(args, logger, device)
    finally:
        logger.close()
    logger.console_logger.info("Finished")
    return summary


def _generators(seed: int, device: torch.device) -> Dict[str, torch.Generator]:
    """Independent generators for init, rollout, learner and the fused
    pipeline's sampling, from ``seed``."""
    init_s, roll_s, learn_s, sample_s = np.random.SeedSequence(seed).generate_state(4)
    return {
        "init": torch.Generator().manual_seed(int(init_s)),
        "rollout": torch.Generator(device=device).manual_seed(int(roll_s)),
        "learner": torch.Generator(device=device).manual_seed(int(learn_s)),
        "sample": torch.Generator(device=device).manual_seed(int(sample_s)),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_training(args, logger, device: torch.device):
    """The env, controller, runner and learner of a run, and its generators."""
    env = build_env(args, device)
    env_info = env.env_info()
    gens = _generators(int(getattr(args, "seed", 0)), device)
    mac = MAC_REGISTRY[args.mac](args, env_info, device, generator=gens["init"])
    runner = VectorRunner(env, mac, args, logger, generator=gens["rollout"])
    learner = QLearner(mac, args, env_info, device, generator=gens["learner"],
                       init_generator=gens["init"])
    return runner, learner, gens


def run_sequential(args, logger: Logger, device: torch.device) -> Dict[str, Any]:
    """Trains with the fused loop or the classic one (see the module's
    docstring). Returns a summary: the loop, counts of blocks, updates and
    diagnostics, the last learner metrics, the env-steps/s of the training
    blocks (rollout + insert + updates, timed to a device sync; test runs,
    logging and the fused loop's graph captures excluded), the last value
    of every logged stat, and for the fused loop its graphs and dispatches
    (each also with the seconds and env steps of its graph replays alone)."""
    runner, learner, gens = build_training(args, logger, device)
    initial_params = [p.detach().clone() for p in learner.params]
    use_fused = bool(getattr(args, "use_fused_pipeline", True)) and not bool(
        getattr(args, "buffer_cpu_only", False))
    logger.console_logger.info("Beginning training for %s timesteps on %s (%s loop)",
                               args.t_max, device, "fused" if use_fused else "classic")
    loop = _run_fused_loop if use_fused else _run_classic_loop
    summary = loop(args, runner, learner, logger, device, gens)
    logger.console_logger.info("Finished Training")
    steps, seconds = summary.pop("train_steps"), summary["train_seconds"]
    return {
        **summary,
        "loop": "fused" if use_fused else "classic",
        "t_env": runner.t_env,
        "episode_limit": runner.episode_limit,
        "env_steps_per_s": steps / seconds if seconds else float("nan"),
        "last_logged": {k: v[-1][1] for k, v in logger.stats.items()},
        "params_max_abs_change": max(float((p.detach() - p0).abs().max())
                                     for p, p0 in zip(learner.params, initial_params)),
        "device": str(device),
    }


def _log_due(args, runner, logger, state) -> None:
    """Logs the ``episode`` stat and the recent-stats table on the
    ``log_interval`` cadence (``state``: the loop's episode and last_log_T)."""
    if (runner.t_env - state["last_log_T"]) >= args.log_interval:
        logger.log_stat("episode", state["episode"], runner.t_env)
        logger.print_recent_stats()
        state["last_log_T"] = runner.t_env


def _run_classic_loop(args, runner, learner, logger, device, gens) -> Dict[str, Any]:
    """The classic loop (``refil_tpu/run.py:411-503``)."""
    log = logger.console_logger
    buffer_device = torch.device("cpu") if getattr(args, "buffer_cpu_only", False) else device
    buffer = None
    cadence = {"episode": 0, "last_log_T": 0}
    last_test_T = -args.test_interval - 1
    start_time = last_time = time.time()
    counts = {"blocks": 0, "test_blocks": 0, "updates": 0, "iterations": 0, "diag_calls": 0}
    train_seconds, train_steps = 0.0, 0
    last_metrics: Dict[str, float] = {}

    while runner.t_env <= args.t_max:
        t_block = time.perf_counter()
        t_before = runner.t_env
        episode_batch = runner.run(test_mode=False)
        if buffer is None:
            buffer = ReplayBuffer(episode_batch, args.buffer_size, seed=args.seed,
                                  device=buffer_device,
                                  feature_dtype=getattr(args, "buffer_dtype", "float32"))
        buffer.insert_episode_batch(episode_batch)
        counts["blocks"] += 1

        metrics = None
        if buffer.can_sample(args.batch_size):
            samples = buffer.sample_many(args.training_iters, args.batch_size, device=device)
            metrics = learner.train_iters(samples, runner.t_env, cadence["episode"])
            counts["updates"] += 1
            counts["iterations"] += args.training_iters
        _sync(device)
        train_seconds += time.perf_counter() - t_block
        train_steps += runner.t_env - t_before

        if metrics is not None and runner.t_env - learner.log_stats_t >= args.learner_log_interval:
            last_metrics = {k: float(v) for k, v in metrics.items()}
            for k, v in last_metrics.items():
                if k != "loss_td":
                    logger.log_stat(k, v, runner.t_env)
            if getattr(args, "test_gt_factors", False):
                last_sample = {k: v[-1] for k, v in samples.items()}
                diag = learner.gt_diagnostics(last_sample)
                if diag:
                    counts["diag_calls"] += 1
                    for k, v in diag.items():
                        logger.log_stat(k, float(v), runner.t_env)
            learner.log_stats_t = runner.t_env
        elif metrics is not None:
            last_metrics = {k: float(v) for k, v in metrics.items()}

        n_test_runs = max(1, args.test_nepisode // runner.batch_size)
        if (runner.t_env - last_test_T) / args.test_interval >= 1.0:
            log.info("t_env: %s / %s", runner.t_env, args.t_max)
            log.info("Estimated time left: %s. Time passed: %s",
                     time_left(last_time, last_test_T, runner.t_env, args.t_max),
                     time_str(time.time() - start_time))
            last_time = time.time()
            last_test_T = runner.t_env
            for _ in range(n_test_runs):
                runner.run(test_mode=True)
                counts["test_blocks"] += 1

        cadence["episode"] += args.batch_size_run
        _log_due(args, runner, logger, cadence)

    return {**counts, "episodes": cadence["episode"], "train_seconds": train_seconds,
            "train_steps": train_steps, "last_metrics": last_metrics}


def _run_fused_loop(args, runner, learner, logger, device, gens) -> Dict[str, Any]:
    """The fused loop (``refil_tpu/run.py:_run_fused_loop``): one dispatch
    of ``run_blocks`` between host-cadence boundaries (test, t_max), each
    block accounted on the host from the stats fetched once per dispatch."""
    log = logger.console_logger
    pipeline = FusedPipeline(runner, learner, args.buffer_size, args)
    ps = pipeline.init_state(gens["sample"], t_env=runner.t_env)
    warm = pipeline.warmup_blocks()
    timer = PhaseTimer()
    cadence = {"episode": int(ps.episode), "last_log_T": 0}
    blocks_done = 0
    last_test_T = -args.test_interval - 1
    start_time = last_time = time.time()
    counts = {"blocks": 0, "test_blocks": 0, "updates": 0, "iterations": 0, "diag_calls": 0}
    train_seconds, train_steps = 0.0, 0
    last_metrics: Dict[str, float] = {}
    dispatches = []

    # Between host-cadence boundaries (test, t_max) the loop runs as many
    # blocks as fit in one dispatch. A block takes at most batch_size_run *
    # episode_limit env steps, so ``remaining // bound`` blocks never cross a
    # boundary before the single-block loop would: the logged series are the
    # same as with one block a dispatch. Sizes are powers of two, warm-up and
    # train blocks never share a dispatch.
    max_steps_per_block = args.batch_size_run * runner.episode_limit
    max_dispatch = int(getattr(args, "max_blocks_per_dispatch", 32))

    def n_blocks_to_boundary() -> int:
        remaining = max(0, min(last_test_T + args.test_interval, args.t_max + 1) - runner.t_env)
        n = min(max(1, remaining // max_steps_per_block), max_dispatch)
        if blocks_done < warm:
            n = min(n, warm - blocks_done)
        return 1 << (int(n).bit_length() - 1)

    while runner.t_env <= args.t_max:
        n_blocks = n_blocks_to_boundary()
        train = blocks_done >= warm
        t_before, setup_before = runner.t_env, pipeline.setup_seconds
        eager_before, replays_before = pipeline.eager_seconds, pipeline.replays()
        t_disp = time.perf_counter()
        stats = pipeline.run_blocks(ps, n_blocks, train=train)
        seconds = time.perf_counter() - t_disp - (pipeline.setup_seconds - setup_before)
        replays = pipeline.replays() - replays_before
        timer.note("block", seconds / n_blocks)
        blocks_done += n_blocks
        counts["blocks"] += n_blocks
        if train:
            counts["updates"] += n_blocks
            counts["iterations"] += n_blocks * args.training_iters
            counts["diag_calls"] += n_blocks if pipeline.gt_diag else 0

        for bi in range(n_blocks):
            cadence["episode"] += args.batch_size_run
            runner.t_env = int(stats["t_env"][bi])
            runner.epsilon = float(stats["epsilon"][bi])
            runner.account_block({"ep_returns": stats["ep_returns"][bi],
                                  "ep_lengths": stats["ep_lengths"][bi],
                                  "final_info": {k: v[bi] for k, v in stats["final_info"].items()}},
                                 test_mode=False)
            if train:
                last_metrics = {k: float(v[bi]) for k, v in stats["metrics"].items()}
                if runner.t_env - learner.log_stats_t >= args.learner_log_interval:
                    for k, v in last_metrics.items():
                        if k != "loss_td":
                            logger.log_stat(k, v, runner.t_env)
                    for k, v in timer.stats().items():
                        logger.log_stat(k, v, runner.t_env)
                    learner.log_stats_t = runner.t_env
        train_seconds += seconds
        train_steps += runner.t_env - t_before
        # the replays alone: an eager block (the first of its kind) leads
        # its dispatch, so the replays are the dispatch's last blocks
        eager = n_blocks - replays
        replay_seconds = seconds - (pipeline.eager_seconds - eager_before)
        replay_t0 = int(stats["t_env"][eager - 1]) if eager else t_before
        dispatches.append({"blocks": n_blocks, "train": train, "seconds": seconds,
                           "env_steps": runner.t_env - t_before, "replays": replays,
                           "replay_seconds": replay_seconds if replays else 0.0,
                           "replay_env_steps": runner.t_env - replay_t0 if replays else 0})

        # periodic greedy test runs: all of test_nepisode as one wider rollout
        n_test_eps = max(1, args.test_nepisode // runner.batch_size) * runner.batch_size
        if (runner.t_env - last_test_T) / args.test_interval >= 1.0:
            log.info("t_env: %s / %s", runner.t_env, args.t_max)
            log.info("Estimated time left: %s. Time passed: %s",
                     time_left(last_time, last_test_T, runner.t_env, args.t_max),
                     time_str(time.time() - start_time))
            last_time = time.time()
            last_test_T = runner.t_env
            runner.run(test_mode=True, batch_size=n_test_eps)
            counts["test_blocks"] += 1

        _log_due(args, runner, logger, cadence)

    if pipeline.graphs:
        log.info("CUDA graphs: %s", {k: g.summary() for k, g in pipeline.graphs.items()})
    return {**counts, "episodes": cadence["episode"], "train_seconds": train_seconds,
            "train_steps": train_steps, "last_metrics": last_metrics, "dispatches": dispatches,
            "graphs": {k: g.summary() for k, g in pipeline.graphs.items()}}
