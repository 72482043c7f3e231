"""The multi-process correctness gate, the port's counterpart of
``__graft_entry__.py:_pipeline_metrics`` and
``assert_sharded_equals_unsharded``: a fused pipeline over a data mesh of
``n`` processes must train as one process does on the same seed and the same
global batch, metric for metric up to reduction order, with ``t_env`` exact
and the parameters bitwise equal on every rank.

    python -m refil_torch.parallel.gate 2                  # Group Matching, gloo
    python -m refil_torch.parallel.gate 2 --config combat  # tiny REFIL combat

Each rank is a subprocess (gloo on the CPU, on a free localhost port) with a
timeout of its own; ``run_cli_ranks`` starts the CLI the same way.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (alg, env, overrides) of each gate config, at narrow widths
CONFIGS = {
    "group_matching": ("refil_group_matching", "group_matching",
                       ["env_args.n_agents=6", "env_args.episode_limit=8",
                        "entity_last_action=True"]),
    "combat": ("refil", "entity_battle",
               ["scenario=3-8sz_symmetric", "env_args.episode_limit=10", "attn_embed_dim=16",
                "hypernet_embed=16", "mixing_embed_dim=8", "attn_n_heads=2",
                "rnn_hidden_dim=16"]),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pipeline_metrics(mesh, n_envs: int = 8, n_blocks: int = 3, seed: int = 42,
                     config: str = "group_matching"):
    """Warm-up and ``n_blocks`` fused train blocks of ``config`` with
    ``batch_size_run = batch_size = n_envs`` and a ring of ``2 n_envs``,
    over ``mesh`` (None: one process), on the CPU. Returns ([per train block: its
    metrics, ``t_env`` and the sum of its returns], the learner's
    parameters as one flat CPU tensor)."""
    from .. import config as tconfig
    from .. import run as trun
    from ..core.pipeline import FusedPipeline

    alg, env, overrides = CONFIGS[config]
    cfg = tconfig.load_config(alg=alg, env=env, overrides=overrides + [
        f"batch_size_run={n_envs}", f"batch_size={n_envs}", f"buffer_size={2 * n_envs}",
        f"seed={seed}", "use_cuda=False"])
    args = tconfig.config_to_args(tconfig.args_sanity_check(cfg))
    runner, learner, gens = trun.build_training(args, None, torch.device("cpu"))
    pipe = FusedPipeline(runner, learner, args.buffer_size, args, mesh=mesh)
    ps = pipe.init_state(gens["sample"])
    for _ in range(pipe.warmup_blocks()):
        pipe.block(ps, train=False)
    rows = []
    for _ in range(n_blocks):
        stats = pipe.block(ps, train=True)
        row = {k: float(v) for k, v in stats["metrics"].items()}
        row["t_env"] = int(stats["t_env"])
        row["return_sum"] = float(stats["ep_returns"].sum())
        rows.append(row)
    params = torch.cat([p.detach().cpu().reshape(-1) for p in learner.params])
    return rows, params


def _worker(rank: int, world: int, port: int, config: str, n_envs: int, n_blocks: int,
            seed: int, out: str) -> None:
    """One rank of the gate (``world`` 0: one process, no mesh); writes its
    rows and parameters to ``out``."""
    import torch.distributed as dist

    from .mesh import MeshContext

    torch.set_num_threads(1)
    mesh = None
    if world:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        mesh = MeshContext(torch.device("cpu"))
    try:
        rows, params = pipeline_metrics(mesh, n_envs, n_blocks, seed, config)
        torch.save({"rows": rows, "params": params}, out)
    finally:
        if world:
            dist.destroy_process_group()


def rank_env() -> Dict[str, str]:
    """A rank subprocess's environment: this checkout on the path, one
    OpenMP thread."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(commands: Sequence[List[str]], timeout: float) -> None:
    """Starts every command at once (one per rank) and waits for each within
    ``timeout`` seconds; kills all of them and raises where one fails or runs
    out of time, with the end of its output."""
    procs = []
    files = []
    for cmd in commands:
        f = tempfile.TemporaryFile()
        files.append(f)
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=rank_env(), stdout=f,
                                      stderr=subprocess.STDOUT))
    failed = None
    try:
        for i, p in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0 and failed is None:
                failed = (i, rc)
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for f in files:
            f.seek(0)
            tails.append(f.read()[-4000:].decode(errors="replace"))
            f.close()
    if failed is not None:
        i, rc = failed
        raise RuntimeError(f"rank {i} of {len(commands)} ended with {rc}:\n{tails[i]}")


def _worker_cmd(rank: int, world: int, port: int, config: str, n_envs: int, n_blocks: int,
                seed: int, out: str) -> List[str]:
    return [sys.executable, "-m", "refil_torch.parallel.gate", "--worker", str(rank),
            str(world), str(port), config, str(n_envs), str(n_blocks), str(seed), out]


def assert_sharded_equals_unsharded(world_size: int, n_blocks: int = 3,
                                    config: str = "group_matching", seed: int = 42,
                                    timeout: float = 120.0) -> Dict[str, Any]:
    """The gate: ``world_size`` gloo ranks against one process (all started
    at once), over ``n_blocks`` fused train blocks after the warm-up, each
    with ``max(8, world_size)`` envs. Every metric within rtol 2e-4, atol
    1e-6, ``t_env`` exact, every rank's parameters equal to rank 0's bit for
    bit. Returns both runs' rows."""
    n_envs, port = max(8, world_size), free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        single_out = os.path.join(tmp, "single.pt")
        run_ranks([_worker_cmd(r, world_size, port, config, n_envs, n_blocks, seed, outs[r])
                   for r in range(world_size)]
                  + [_worker_cmd(0, 0, 0, config, n_envs, n_blocks, seed, single_out)],
                  timeout)
        sharded = [torch.load(o, weights_only=True) for o in outs]
        single = torch.load(single_out, weights_only=True)
    for r, res in enumerate(sharded[1:], 1):
        if not torch.equal(res["params"], sharded[0]["params"]):
            raise AssertionError(f"rank {r}'s parameters differ from rank 0's")
    for b, (bs, bu) in enumerate(zip(sharded[0]["rows"], single["rows"])):
        if bs.keys() != bu.keys():
            raise AssertionError(f"block {b}: metrics {sorted(bs)} != {sorted(bu)}")
        for k in bs:
            if k == "t_env":
                if bs[k] != bu[k]:
                    raise AssertionError(f"block {b}: t_env {bs[k]} != {bu[k]}")
            else:
                np.testing.assert_allclose(bs[k], bu[k], rtol=2e-4, atol=1e-6,
                                           err_msg=f"block {b}: {k} sharded vs unsharded")
    return {"sharded": sharded[0]["rows"], "single": single["rows"]}


def cli_rank_commands(world: int, argv: Sequence[str]) -> List[List[str]]:
    """``python -m refil_torch.main argv`` for each of ``world`` ranks, with
    ``distributed=True`` and its rank, over a free localhost port (gloo
    under ``use_cuda=False``); for ``run_ranks``."""
    port = free_port()
    return [[sys.executable, "-m", "refil_torch.main", *argv, "distributed=True",
             f"num_processes={world}", f"process_id={r}",
             f"coordinator_address=127.0.0.1:{port}"] for r in range(world)]


def run_cli_ranks(world: int, argv: Sequence[str], timeout: float = 120.0) -> None:
    """The CLI as ``world`` ranks (``cli_rank_commands``), waited for."""
    run_ranks(cli_rank_commands(world, argv), timeout)


def main(argv: Sequence[str]) -> None:
    if argv and argv[0] == "--worker":
        rank, world, port, config, n_envs, n_blocks, seed, out = argv[1:]
        _worker(int(rank), int(world), int(port), config, int(n_envs), int(n_blocks),
                int(seed), out)
        return
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("world_size", type=int)
    p.add_argument("--config", choices=sorted(CONFIGS), default="group_matching")
    p.add_argument("--blocks", type=int, default=3)
    a = p.parse_args(argv)
    out = assert_sharded_equals_unsharded(a.world_size, a.blocks, a.config)
    print(f"sharded == unsharded over {a.blocks} blocks ({a.config}, {a.world_size} ranks): "
          f"t_env {[r['t_env'] for r in out['sharded']]}, "
          f"loss {[r['loss'] for r in out['sharded']]}")


if __name__ == "__main__":
    main(sys.argv[1:])
