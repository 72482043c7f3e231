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

Then, in both, the periodic greedy test runs (on a generator of their own,
so they leave the training stream alone), logging, checkpoints on the
``save_model_interval`` cadence and the preemption check: a SIGTERM lets the
in-flight block or dispatch finish, writes a checkpoint and returns.

A run's one recorder (``utils/profiling.PhaseTimer``) holds the spans of
set-up's steps (``build_training``'s, the kernel libraries' first loads, the
ring, the eager first blocks and captures) and of the loop's (each dispatch,
its launches, sync and accounting, the tests, saves and logging), and the
fused pipeline's per-block stamps; the fused summary's ``spans`` is its
snapshot as the loop returns.

Checkpoints (``models/<token>/<t_env>/state.pt``, ``torch.save`` of CPU
tensors, written to a tmp file and renamed): the learner's parameters,
targets and RMSprop state; a fused run adds the pipeline's counters and its
rollout, sample and learner generators, and with ``checkpoint_buffer`` the
replay ring, so a resumed fused run repeats the unbroken run exactly. A
restore copies into the live tensors in place, since a captured CUDA graph
replays only on the tensors it was captured over. ``checkpoint_path`` loads
the newest step (or the one nearest ``load_step``) and, under ``evaluate``,
runs only ``evaluate_sequential``, which with ``video_path`` or
``save_replay`` also records its first rollout and writes the eval video and
``replays/<token>.npz`` (``envs/combat/render.py``).

The scheme comes from ``env_args.entity_scheme``: the entity envs (Group
Matching, ``entity_battle``) feed ``entity_mac`` and the entity mixers; the
flat env (``flat_battle``, ``sc2``) feeds ``basic_mac`` and ``qmix`` over its
global state, with its per-entity obs and state masks in ``args.obs_masks``
and ``args.state_masks``.

``heuristic_ai`` (config or ``env_args``) acts with the combat env's
scripted ally policy (``VectorRunner``).

Multi-process data parallelism (``parallel/mesh.py``): ``distributed=True``
joins a process group before any device access, one process per device;
``mesh_shape`` must equal the world size. Both loops then shard each
training rollout and the replay ring over the ranks (``buffer_size / n``
episodes a rank), hand each rank its shard of every sample in one exchange
and all-reduce each update's gradients; test rollouts and eval run whole on
every rank; rank 0 alone writes logs, TensorBoard and checkpoints (a
checkpoint's ring gathered to it in global slot order, so it resumes at any
world size the sizes divide over), and the ranks agree on a preemption at
each dispatch or block boundary.

Device: ``use_cuda`` (default True) runs on the CUDA card (a rank's card
under ``distributed``) and raises where there is none; ``use_cuda=False``
runs on the CPU.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import pprint
import signal
import time
from os.path import abspath, dirname, join
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import args_sanity_check, config_to_args
from .controllers.mac import MAC_REGISTRY
from .core.buffer import ReplayBuffer
from .core.pipeline import FusedPipeline
from .envs import ENV_REGISTRY
from .envs.combat.scenarios import SCENARIO_REGISTRY
from .learners.q_learner import QLearner
from .parallel.mesh import maybe_init_distributed, maybe_make_mesh
from .runners.vector_runner import VectorRunner
from .utils import profiling
from .utils.logging import Logger, get_logger
from .utils.profiling import PhaseTimer
from .utils.timehelper import time_left, time_str

STATE_FILE = "state.pt"


class PreemptionGuard:
    """SIGTERM (a cloud eviction notice) sets ``requested``; the training
    loop finishes the in-flight block or dispatch, writes a checkpoint and
    returns, so the run restarts from there with ``checkpoint_path=``
    (``refil_tpu/run.py:PreemptionGuard``). ``restore`` puts back the
    handler that ``install`` replaced. The handler only sets the flag: the
    loop logs the preemption, since a handler that writes to a stream can
    land inside another write to it."""

    def __init__(self):
        self.requested = False
        self._previous = None
        self._installed = False

    def install(self) -> "PreemptionGuard":
        def _handler(signum, frame):
            self.requested = True

        try:
            self._previous = signal.signal(signal.SIGTERM, _handler)
            self._installed = True
        except ValueError:
            pass  # not the main thread: the guard stays inert
        return self

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._previous)
            self._installed = False


def resolve_device(args) -> torch.device:
    """The card when ``use_cuda`` (the default), else the CPU; in a process
    group, card ``rank % device_count``. Never falls back: ``use_cuda``
    without a CUDA device raises."""
    if bool(getattr(args, "use_cuda", True)):
        if not torch.cuda.is_available():
            raise RuntimeError("use_cuda=True but no CUDA device is available; pass "
                               "use_cuda=False to run on the CPU")
        if dist.is_initialized():
            return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _is_main() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def build_env(args, device: torch.device):
    """The env of ``args.env``; the combat env, under either of its names,
    takes its scenario set from the registry by ``args.scenario``, as
    ``refil_tpu/run.py:build_env`` does."""
    env_args = dict(args.env_args)
    if args.env in ("entity_battle", "sc2custom"):
        env_args["scenario_dict"] = SCENARIO_REGISTRY[args.scenario]()
    return ENV_REGISTRY[args.env](**env_args, device=device)


def run(config: Dict[str, Any]) -> Dict[str, Any]:
    """Runs one experiment; returns ``run_sequential``'s summary. Under
    ``distributed``, joins the process group first (before any device
    access) and leaves it at the end."""
    config = args_sanity_check(config)
    created = maybe_init_distributed(config)
    try:
        args = config_to_args(config)
        if args.env not in ENV_REGISTRY:
            raise ValueError(f"env {args.env!r} not recognised; known: {sorted(ENV_REGISTRY)}")
        device = resolve_device(args)
        console = get_logger()
        if not _is_main():  # the other ranks say only what goes wrong
            console = console.getChild(f"rank{dist.get_rank()}")
            console.setLevel(logging.WARNING)
        logger = Logger(console)
        logger.console_logger.info("Experiment Parameters:\n\n%s\n",
                                   pprint.pformat(config, indent=4, width=1))
        args.unique_token = "{}__{}".format(
            args.name, datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f"))
        if _is_main():
            if args.use_tensorboard:
                logger.setup_tb(join(args.local_results_path, args.tb_dirname,
                                     args.unique_token))
            logger.setup_jsonl(join(args.local_results_path, "metrics",
                                    args.unique_token + ".jsonl"))
        try:
            summary = run_sequential(args, logger, device)
        finally:
            logger.close()
        logger.console_logger.info("Finished")
        return summary
    finally:
        if created:
            dist.destroy_process_group()


def _generators(seed: int, device: torch.device) -> Dict[str, torch.Generator]:
    """Independent generators for init, rollout, learner, the fused
    pipeline's sampling and the test runs, from ``seed``."""
    init_s, roll_s, learn_s, sample_s, test_s = np.random.SeedSequence(seed).generate_state(5)
    return {
        "init": torch.Generator().manual_seed(int(init_s)),
        "rollout": torch.Generator(device=device).manual_seed(int(roll_s)),
        "learner": torch.Generator(device=device).manual_seed(int(learn_s)),
        "sample": torch.Generator(device=device).manual_seed(int(sample_s)),
        "test": torch.Generator(device=device).manual_seed(int(test_s)),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_training(args, logger, device: torch.device):
    """The env, controller, runner and learner of a run, and its generators;
    each step a span (``build.<step>``) of the run's recorder."""
    # the scheme flags (refil_tpu/run.py:313-329)
    args.entity_scheme = bool(args.env_args.get("entity_scheme", False))
    with profiling.span("build.env"):
        env = build_env(args, device)
        if args.entity_scheme:
            env_info = env.env_info()
        else:
            # the flat env attaches its per-entity obs and state masks
            env_info = env.env_info(args)
            args.obs_masks, args.state_masks = env_info["masks"]
    gens = _generators(int(getattr(args, "seed", 0)), device)
    with profiling.span("build.controller"):
        mac = MAC_REGISTRY[args.mac](args, env_info, device, generator=gens["init"])
    with profiling.span("build.runner"):
        runner = VectorRunner(env, mac, args, logger, generator=gens["rollout"])
    with profiling.span("build.learner"):
        learner = QLearner(mac, args, env_info, device, generator=gens["learner"],
                           init_generator=gens["init"])
    return runner, learner, gens


# ------------------------------------------------------------------ checkpoints
# the PipelineState counters a fused checkpoint holds
PIPELINE_COUNTERS = ("buffer_index", "episodes_in_buffer", "t_env", "episode",
                     "last_target_episode")


def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    """``dst.copy_(src)`` in place, cast to ``dst``'s dtype on the host (one
    host-to-device copy); shapes must agree."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"checkpoint tensor {name}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))


def _save_checkpoint(path: str, learner, pstate=None, include_buffer: bool = False,
                     ring=None) -> Dict[str, Any]:
    """Writes ``path/state.pt``: the learner's parameters, targets and
    RMSprop state by parameter name; with ``pstate`` (a ``PipelineState``)
    also its counters and generator states, and, behind ``include_buffer``,
    the ring: ``ring`` where given (the whole ring on the host, in global
    slot order, which a sharded ring's ``_host_ring`` gathers), else a copy
    of this process's ring. The write goes to a tmp file that is then
    renamed, so a crash mid-save leaves no truncated checkpoint. Returns the
    file's bytes and the seconds the save took."""
    t0 = time.perf_counter()
    names = learner.param_names()
    opt = learner.optimiser.state
    blob: Dict[str, Any] = {
        "params": {n: p.detach().cpu() for n, p in zip(names, learner.params)},
        "target": {n: t.detach().cpu() for n, t in zip(names, learner.target_params)},
        "opt": {n: {k: v.detach().cpu() for k, v in opt[p].items()}
                for n, p in zip(names, learner.params) if p in opt},
    }
    if pstate is not None:
        pipe: Dict[str, Any] = {k: int(getattr(pstate, k)) for k in PIPELINE_COUNTERS}
        pipe["generators"] = {k: g.get_state() for k, g in pstate.generators.items()}
        if include_buffer:
            if ring is None and pstate.layout is not None:
                raise ValueError("a sharded ring is saved gathered (_save_on_main)")
            pipe["ring"] = ring if ring is not None else _host_ring(pstate, None)[0]
        blob["pipeline"] = pipe
    os.makedirs(path, exist_ok=True)
    tmp = join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, join(path, STATE_FILE))
    return {"path": path, "bytes": os.path.getsize(join(path, STATE_FILE)),
            "seconds": time.perf_counter() - t0}


def _load_checkpoint(path: str, learner) -> Optional[Dict[str, Any]]:
    """Copies the parameters, targets and RMSprop state of ``path/state.pt``
    into the learner's live tensors, in place; returns the pipeline payload
    (None where the checkpoint has none) for ``restore_pipeline_state``."""
    blob = torch.load(join(path, STATE_FILE), map_location="cpu", weights_only=True)
    names = learner.param_names()
    for group in ("params", "target"):
        if set(blob[group]) != set(names):
            raise KeyError(f"checkpoint {group} {sorted(set(blob[group]) ^ set(names))} do not "
                           "match the learner's parameters")
    opt = learner.optimiser.state
    capturable = learner.optimiser.param_groups[0]["capturable"]
    with torch.no_grad():
        for n, p, t in zip(names, learner.params, learner.target_params):
            _copy_into(p, blob["params"][n], n)
            _copy_into(t, blob["target"][n], "target " + n)
            saved = blob["opt"].get(n)
            if p in opt and saved is None:  # saved before the first update
                for v in opt[p].values():
                    v.zero_()
            elif p in opt:
                for k, v in opt[p].items():
                    _copy_into(v, saved[k], f"optimiser {n}.{k}")
            elif saved is not None:  # no update yet here: the state is new
                opt[p] = {k: v.to(p.device if k != "step" or capturable else "cpu").clone()
                          for k, v in saved.items()}
    return blob.get("pipeline")


def restore_pipeline_state(ps, payload: Dict[str, Any]) -> None:
    """Copies a checkpoint's pipeline payload into ``ps`` in place (a
    captured block replays on these very tensors). The counters and the
    generators always restore; the ring, cast to the run's ``buffer_dtype``,
    with its fill counters only where it was saved (``checkpoint_buffer``):
    otherwise the fresh ring keeps its zero fill counters, so sampling never
    sees unwritten slots. The saved ring is global, in slot order; under a
    mesh each rank copies the slots it holds (``ps.layout``), so a ring saved
    at one world size restores at another."""
    for k in ("t_env", "episode", "last_target_episode"):
        getattr(ps, k).fill_(int(payload[k]))
    for k, g in ps.generators.items():
        g.set_state(payload["generators"][k])
    ring = payload.get("ring")
    if ring is not None:
        if set(ring) != set(ps.ring):
            raise KeyError(f"checkpoint ring planes {sorted(ring)} != {sorted(ps.ring)}")
        held = None if ps.layout is None else ps.layout.held_slots()
        with torch.no_grad():
            for k, buf in ps.ring.items():
                src = ring[k]
                if held is not None:
                    if src.shape[0] != ps.layout.size:
                        raise ValueError(f"checkpoint ring {k}: {src.shape[0]} episodes, the "
                                         f"run's ring holds {ps.layout.size}")
                    src = src[held]
                _copy_into(buf, src, "ring " + k)
        ps.buffer_index.fill_(int(payload["buffer_index"]))
        ps.episodes_in_buffer.fill_(int(payload["episodes_in_buffer"]))


def resume_warmup_blocks(args, ps) -> int:
    """Rollout-only blocks still needed after restoring a ring: a resume from
    mid-warm-up finishes filling the ring before it trains."""
    missing = int(args.batch_size) - int(ps.episodes_in_buffer)
    return max(0, -(-missing // int(args.batch_size_run)))


def find_checkpoint(checkpoint_path: str, load_step: int) -> Optional[Tuple[int, str]]:
    """(step, directory) of the newest checkpoint under ``checkpoint_path``,
    or of the one nearest ``load_step`` when it is not 0; only step
    directories that hold a non-empty state file count. None where
    ``checkpoint_path`` is not a directory."""
    if not os.path.isdir(checkpoint_path):
        return None

    def valid(name):
        f = join(checkpoint_path, name, STATE_FILE)
        return name.isdigit() and os.path.isfile(f) and os.path.getsize(f) > 0

    steps = [int(n) for n in os.listdir(checkpoint_path) if valid(n)]
    if not steps:
        raise FileNotFoundError(f"no checkpoint ({STATE_FILE}) under {checkpoint_path}")
    step = max(steps) if load_step == 0 else min(steps, key=lambda x: abs(x - load_step))
    return step, join(checkpoint_path, str(step))


def _model_path(args, t_env: int) -> str:
    return join(args.local_results_path, "models", args.unique_token, str(t_env))


def _host_ring(pstate, mesh) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
    """The whole ring on the host in global slot order (on rank 0; None on
    the others), and the device bytes its gather took on top of the ring
    (0 in one process: each plane one device-to-host copy). About 2.5 GB
    for the combat ring of 5000 episodes of 151 steps."""
    if mesh is None:
        return {k: v.cpu() for k, v in pstate.ring.items()}, 0
    return mesh.gather_ring(pstate.ring, pstate.layout)


def _save_on_main(mesh, path: str, learner, pstate=None, include_buffer: bool = False
                  ) -> Optional[Dict[str, Any]]:
    """``_save_checkpoint`` on rank 0 (or the only process), then a barrier,
    so no rank runs on before the checkpoint is on disk. With
    ``include_buffer`` every rank first joins the ring's gather to rank 0
    (``_host_ring``). None on the other ranks."""
    ring, gather_bytes = None, 0
    if pstate is not None and include_buffer:
        ring, gather_bytes = _host_ring(pstate, mesh)
    info = (_save_checkpoint(path, learner, pstate=pstate, include_buffer=ring is not None,
                             ring=ring) if _is_main() else None)
    if info is not None and ring is not None:
        info["ring_gather_bytes"] = gather_bytes
    if mesh is not None:
        mesh.barrier()
    return info


def _preempt_due(guard, mesh) -> bool:
    """The SIGTERM flag, agreed over the ranks: every rank stops at the
    same boundary."""
    return guard.requested if mesh is None else mesh.any(guard.requested)


def _save_due(args, t_env: int, model_save_time: int) -> bool:
    return bool(args.save_model) and (t_env - model_save_time >= args.save_model_interval
                                      or model_save_time == 0 or t_env > args.t_max)


# ------------------------------------------------------------------ eval
def evaluate_sequential(args, runner, logger: Logger, generator: torch.Generator
                        ) -> Dict[str, Any]:
    """Eval-only run (``refil_tpu/run.py:evaluate_sequential``): one greedy
    rollout of all of ``test_nepisode`` for each scenario under
    ``eval_all_scen`` (every env on that scenario), else one over randomly
    drawn scenarios; the stats each logged go to ``eval_path`` as JSON, keyed
    by scenario name under ``eval_all_scen``. With ``video_path`` or
    ``save_replay``, on an env that renders, the first rollout records:
    env 0's episode becomes the video (an animated GIF where imageio has no
    FFMPEG) and the whole recording ``replays/<token>.npz``. Only rank 0
    writes files. Returns the stats, each rollout's seconds, and the video
    and replay paths (None where not written)."""
    res: Dict[str, Any] = {}
    n_scen = len(runner.env.scenario_names) if args.eval_all_scen else 1
    n_test_eps = max(1, args.test_nepisode // runner.batch_size) * runner.batch_size
    want_record = bool(args.video_path or args.save_replay) and hasattr(runner.env,
                                                                         "render_state")
    seconds = []
    for i in range(n_scen):
        # only the stats this scenario's rollout logged
        before = {k: len(v) for k, v in logger.stats.items()}
        t0 = time.perf_counter()
        runner.run(test_mode=True, test_scen=True, index=i if args.eval_all_scen else None,
                   batch_size=n_test_eps, generator=generator, record=want_record and i == 0)
        seconds.append(time.perf_counter() - t0)
        curr = {k: v[-1][1] for k, v in logger.stats.items() if len(v) > before.get(k, 0)}
        if args.eval_all_scen:
            res[runner.env.scenario_names[i]] = curr
        else:
            res.update(curr)
    video = replay = None
    if want_record and _is_main():
        from .envs.combat import render as crender

        if args.video_path:
            path = args.video_path if args.video_path.endswith(".mp4") else (
                args.video_path + ".mp4")
            os.makedirs(dirname(abspath(path)), exist_ok=True)
            # the geometry-defined maps' terrain is drawn under the units
            core = getattr(runner.env, "core", runner.env)
            geo = None if core.trivial_pathing else (core.pathing_grid.cpu().numpy(),
                                                     core.terrain_height.cpu().numpy())
            frames = crender.frames_for_env(runner.last_recording, 0, runner.env.map_size,
                                            geometry=geo)
            video = crender.save_video(path, frames, fps=args.fps)
            logger.console_logger.info("Saved eval video to %s", video)
        if args.save_replay:
            replay = join(args.local_results_path, "replays", args.unique_token + ".npz")
            os.makedirs(dirname(abspath(replay)), exist_ok=True)
            crender.save_replay(replay, runner.last_recording)
            logger.console_logger.info("Saved replay to %s", replay)
    if args.eval_path and _is_main():
        path = args.eval_path if args.eval_path.endswith(".json") else args.eval_path + ".json"
        os.makedirs(dirname(abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f)
    logger.print_stats_summary()
    return {"eval": res, "eval_seconds": seconds, "eval_episodes": n_test_eps,
            "video": video, "replay": replay}


# ------------------------------------------------------------------ training
def run_sequential(args, logger: Logger, device: torch.device) -> Dict[str, Any]:
    """Loads ``checkpoint_path`` where given (and under ``evaluate`` returns
    ``evaluate_sequential``'s results), then trains with the fused loop or
    the classic one (see the module's docstring). Returns a summary: the
    loop, counts of blocks, updates and diagnostics, the last learner
    metrics, the env-steps/s of the training blocks (rollout + insert +
    updates, timed to a device sync; test runs, logging, checkpoints and the
    fused loop's graph captures excluded), the last value of every logged
    stat, the checkpoints written and loaded, whether a SIGTERM stopped the
    run, and for the fused loop its graphs and dispatches (each also with
    the seconds and env steps of its graph replays alone), its test
    rollouts (t_env, width, seconds) and its spans (``PhaseTimer.snapshot``:
    set-up's steps, the loop's, and each block's stages); for both, this
    rank's ring's bytes and episodes, and the bytes of the whole ring over
    the ranks."""
    timer = PhaseTimer()  # the run's spans, set-up's included
    with profiling.recording(timer):
        return _train(args, logger, device, timer)


def _train(args, logger: Logger, device: torch.device, timer: PhaseTimer) -> Dict[str, Any]:
    runner, learner, gens = build_training(args, logger, device)
    log = logger.console_logger
    mesh = runner.mesh = maybe_make_mesh(args, device, log)
    pipe_payload, restored = None, None
    if args.checkpoint_path:
        found = find_checkpoint(args.checkpoint_path, int(args.load_step))
        if found is None:
            log.info("Checkpoint directory %s doesn't exist", args.checkpoint_path)
            return {"loop": None, "t_env": 0, "device": str(device)}
        step, model_path = found
        log.info("Loading model from %s", model_path)
        t0 = time.perf_counter()
        pipe_payload = _load_checkpoint(model_path, learner)
        _sync(device)
        restored = {"path": model_path, "t_env": step,
                    "bytes": os.path.getsize(join(model_path, STATE_FILE)),
                    "seconds": time.perf_counter() - t0}
        runner.t_env = step
        if args.evaluate or args.save_replay:
            out = evaluate_sequential(args, runner, logger, gens["test"])
            return {**out, "loop": "evaluate", "restored": restored, "t_env": runner.t_env,
                    "episode_limit": runner.episode_limit, "device": str(device)}
    initial_params = [p.detach().clone() for p in learner.params]
    use_fused = bool(getattr(args, "use_fused_pipeline", True)) and not bool(
        getattr(args, "buffer_cpu_only", False))
    log.info("Beginning training for %s timesteps on %s (%s loop)",
             args.t_max, device, "fused" if use_fused else "classic")
    guard = PreemptionGuard()
    if bool(getattr(args, "handle_preemption", True)):
        guard.install()
    try:
        if use_fused:
            summary = _run_fused_loop(args, runner, learner, logger, device, gens, guard,
                                      timer, pipe_payload, mesh)
        else:
            summary = _run_classic_loop(args, runner, learner, logger, device, gens, guard,
                                        timer, mesh)
    finally:
        guard.restore()
    log.info("Finished Training")
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
        "restored": restored,
        "world_size": 1 if mesh is None else mesh.n_data,
        "device": str(device),
    }


def _log_due(args, runner, logger, state) -> None:
    """Logs the ``episode`` stat and the recent-stats table on the
    ``log_interval`` cadence (``state``: the loop's episode and last_log_T)."""
    if (runner.t_env - state["last_log_T"]) >= args.log_interval:
        logger.log_stat("episode", state["episode"], runner.t_env)
        logger.print_recent_stats()
        state["last_log_T"] = runner.t_env


def _run_classic_loop(args, runner, learner, logger, device, gens, guard, timer: PhaseTimer,
                      mesh=None) -> Dict[str, Any]:
    """The classic loop (``refil_tpu/run.py:411-503``). Its checkpoints hold
    the learner only, as the JAX package's do: a resume refills the ring.
    Under a data mesh each training rollout is sharded and gathered
    (``VectorRunner.run``), each rank's ring holds its chunk of the slots and
    its host sampler draws the global slots alike on every rank, and each
    update trains on this rank's shard of the sample."""
    log = logger.console_logger
    buffer_device = torch.device("cpu") if getattr(args, "buffer_cpu_only", False) else device
    buffer = None
    cadence = {"episode": 0, "last_log_T": 0}
    last_test_T = -args.test_interval - 1
    model_save_time = 0
    start_time = last_time = time.time()
    counts = {"blocks": 0, "test_blocks": 0, "updates": 0, "iterations": 0, "diag_calls": 0}
    train_seconds, train_steps = 0.0, 0
    last_metrics: Dict[str, float] = {}
    saves = []

    preempted = False
    while runner.t_env <= args.t_max:
        t_block = time.perf_counter()
        t_before = runner.t_env
        with timer.phase("rollout"):
            episode_batch = runner.run(test_mode=False)
        if buffer is None:
            buffer = ReplayBuffer(episode_batch, args.buffer_size, seed=args.seed,
                                  device=buffer_device,
                                  feature_dtype=getattr(args, "buffer_dtype", "float32"),
                                  mesh=mesh)
        buffer.insert_episode_batch(episode_batch)
        counts["blocks"] += 1

        metrics = None
        if buffer.can_sample(args.batch_size):
            with timer.phase("train"):
                samples = buffer.sample_many(args.training_iters, args.batch_size, device=device)
                metrics = learner.train_iters(samples, runner.t_env, cadence["episode"],
                                              mesh=mesh)
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
            for k, v in timer.stats().items():
                logger.log_stat(k, v, runner.t_env)
            if getattr(args, "test_gt_factors", False):
                last_sample = {k: v[-1] for k, v in samples.items()}
                diag = learner.gt_diagnostics(last_sample, mesh=mesh)
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
                runner.run(test_mode=True, generator=gens["test"])
                counts["test_blocks"] += 1

        if _save_due(args, runner.t_env, model_save_time):
            model_save_time = runner.t_env
            info = _save_on_main(mesh, _model_path(args, runner.t_env), learner)
            if info is not None:
                saves.append(info)
                log.info("Saved models to %s (%d bytes, %.3f s)", info["path"], info["bytes"],
                         info["seconds"])

        cadence["episode"] += args.batch_size_run
        _log_due(args, runner, logger, cadence)

        preempted = _preempt_due(guard, mesh)
        if preempted:
            path = _model_path(args, runner.t_env)
            info = _save_on_main(mesh, path, learner)
            saves += [info] if info is not None else []
            log.info("Preempted at t_env=%d: checkpoint written to %s", runner.t_env, path)
            break

    # this rank's ring (under a mesh 1/n of the world's), bytes and episodes
    ring_bytes = 0 if buffer is None else sum(v.numel() * v.element_size()
                                              for v in buffer.data.values())
    return {**counts, "episodes": cadence["episode"], "train_seconds": train_seconds,
            "train_steps": train_steps, "last_metrics": last_metrics, "saves": saves,
            "preempted": preempted, "ring_bytes": ring_bytes,
            "ring_bytes_world": ring_bytes * (1 if mesh is None else mesh.n_data),
            "ring_episodes": 0 if buffer is None else next(iter(buffer.data.values())).shape[0]}


def _run_fused_loop(args, runner, learner, logger, device, gens, guard, timer: PhaseTimer,
                    pipe_payload=None, mesh=None) -> Dict[str, Any]:
    """The fused loop (``refil_tpu/run.py:_run_fused_loop``): one dispatch
    of ``run_blocks`` between host-cadence boundaries (test, model save,
    t_max), each block accounted on the host from the stats fetched once per
    dispatch. ``pipe_payload`` (a checkpoint's) is restored into the fresh
    pipeline state before the first block. ``mesh``: the pipeline's.
    ``timer`` records the spans: each ``dispatch`` holds its ``blocks``
    (``run_blocks``: launches, the closing ``sync``), a ``clock`` anchor of
    the stamps (with ``trace_blocks``) and its ``account`` (the per-block
    loop); then ``test``, ``save`` and ``log``. The summary's ``spans`` is a
    snapshot of it as the loop returns."""
    log = logger.console_logger
    pipeline = FusedPipeline(runner, learner, args.buffer_size, args, mesh=mesh, timer=timer)
    ps = pipeline.init_state(gens["sample"], t_env=runner.t_env)
    warm = pipeline.warmup_blocks()
    if pipe_payload is not None:
        restore_pipeline_state(ps, pipe_payload)
        if "ring" in pipe_payload:
            warm = resume_warmup_blocks(args, ps)
        runner.t_env = int(ps.t_env)
        log.info("Restored pipeline state: t_env=%d episode=%d ring=%s", runner.t_env,
                 int(ps.episode), "restored" if "ring" in pipe_payload else "fresh")
    cadence = {"episode": int(ps.episode), "last_log_T": 0}
    blocks_done = 0
    last_test_T = -args.test_interval - 1
    model_save_time = 0
    start_time = last_time = time.time()
    counts = {"blocks": 0, "test_blocks": 0, "updates": 0, "iterations": 0, "diag_calls": 0}
    train_seconds, train_steps = 0.0, 0
    last_metrics: Dict[str, float] = {}
    dispatches, saves, tests = [], [], []

    # Between host-cadence boundaries (test, model save, t_max) the loop
    # runs as many blocks as fit in one dispatch. A block takes at most
    # batch_size_run * episode_limit env steps, so ``remaining // bound``
    # blocks never cross a boundary before the single-block loop would: the
    # logged series and the saves are the same as with one block a
    # dispatch. Sizes are powers of two, warm-up and train blocks never
    # share a dispatch.
    max_steps_per_block = args.batch_size_run * runner.episode_limit
    max_dispatch = int(getattr(args, "max_blocks_per_dispatch", 32))

    def n_blocks_to_boundary() -> int:
        nxt = [last_test_T + args.test_interval, args.t_max + 1]
        if args.save_model:
            nxt.append(model_save_time + args.save_model_interval if model_save_time
                       else args.save_model_interval)
        remaining = max(0, min(nxt) - runner.t_env)
        n = min(max(1, remaining // max_steps_per_block), max_dispatch)
        if blocks_done < warm:
            n = min(n, warm - blocks_done)
        return 1 << (int(n).bit_length() - 1)

    def save(include_buffer: bool) -> None:
        with timer.span("save"):
            info = _save_on_main(mesh, _model_path(args, runner.t_env), learner, pstate=ps,
                                 include_buffer=include_buffer)
        if info is not None:
            saves.append(info)
            log.info("Saved models to %s (%d bytes, %.3f s)", info["path"], info["bytes"],
                     info["seconds"])

    preempted = False
    while runner.t_env <= args.t_max:
        n_blocks = n_blocks_to_boundary()
        train = blocks_done >= warm
        t_before, setup_before = runner.t_env, pipeline.setup_seconds
        eager_before, replays_before = pipeline.eager_seconds, pipeline.replays()
        with timer.span("dispatch"):
            with timer.span("blocks") as ran:
                stats = pipeline.run_blocks(ps, n_blocks, train=train)
            if pipeline.trace_blocks:
                with timer.span("clock"):
                    pipeline.anchor_clock()
            with timer.span("account"):
                seconds = ran.seconds - (pipeline.setup_seconds - setup_before)
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
                    runner.account_block(
                        {"ep_returns": stats["ep_returns"][bi],
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
                # the replays alone: an eager block (the first of its kind)
                # leads its dispatch, so the replays are the dispatch's last
                eager = n_blocks - replays
                replay_seconds = seconds - (pipeline.eager_seconds - eager_before)
                replay_t0 = int(stats["t_env"][eager - 1]) if eager else t_before
                dispatches.append({"blocks": n_blocks, "train": train, "seconds": seconds,
                                   "env_steps": runner.t_env - t_before, "replays": replays,
                                   "replay_seconds": replay_seconds if replays else 0.0,
                                   "replay_env_steps": runner.t_env - replay_t0 if replays
                                   else 0})

        # periodic greedy test runs: all of test_nepisode as one wider rollout
        n_test_eps = max(1, args.test_nepisode // runner.batch_size) * runner.batch_size
        if (runner.t_env - last_test_T) / args.test_interval >= 1.0:
            log.info("t_env: %s / %s", runner.t_env, args.t_max)
            log.info("Estimated time left: %s. Time passed: %s",
                     time_left(last_time, last_test_T, runner.t_env, args.t_max),
                     time_str(time.time() - start_time))
            last_time = time.time()
            last_test_T = runner.t_env
            with timer.span("test") as tested:
                runner.run(test_mode=True, batch_size=n_test_eps, generator=gens["test"])
            tests.append({"t_env": runner.t_env, "episodes": n_test_eps,
                          "seconds": tested.seconds})
            counts["test_blocks"] += 1

        if _save_due(args, runner.t_env, model_save_time):
            model_save_time = runner.t_env
            save(bool(getattr(args, "checkpoint_buffer", False)))

        with timer.span("log"):
            _log_due(args, runner, logger, cadence)

        preempted = _preempt_due(guard, mesh)
        if preempted:
            save(bool(getattr(args, "preempt_save_buffer", True)))
            log.info("Preempted at t_env=%d: exact-resume checkpoint written to %s",
                     runner.t_env, _model_path(args, runner.t_env))
            break

    if pipeline.graphs:
        log.info("CUDA graphs: %s", {k: g.summary() for k, g in pipeline.graphs.items()})
    # this rank's ring (under a mesh 1/n of the world's), bytes and episodes
    ring_bytes = sum(v.numel() * v.element_size() for v in ps.ring.values())
    return {**counts, "episodes": cadence["episode"], "train_seconds": train_seconds,
            "train_steps": train_steps, "last_metrics": last_metrics, "dispatches": dispatches,
            "graphs": {k: g.summary() for k, g in pipeline.graphs.items()}, "saves": saves,
            "preempted": preempted, "tests": tests,
            "ring_bytes": ring_bytes, "ring_bytes_world": ring_bytes * pipeline.n_data,
            "ring_episodes": next(iter(ps.ring.values())).shape[0], "spans": timer.snapshot()}
