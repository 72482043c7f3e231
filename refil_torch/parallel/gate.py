"""The multi-process correctness gate, the port's counterpart of
``__graft_entry__.py:_pipeline_metrics`` and
``assert_sharded_equals_unsharded``: a fused pipeline over a data mesh of
``n`` processes must train as one process does on the same seed and the same
global batch, metric for metric up to reduction order, with ``t_env`` exact
and the parameters bitwise equal on every rank; and each rank's replay ring
must hold exactly its slots of the one-process ring, bit for bit, in exactly
1/n of its bytes.

    python -m refil_torch.parallel.gate 2                  # Group Matching, gloo
    python -m refil_torch.parallel.gate 4                  # four ranks
    python -m refil_torch.parallel.gate 2 --config combat  # tiny REFIL combat
    python -m refil_torch.parallel.gate 2 buffer_dtype=bfloat16  # overrides

Each rank is a subprocess (gloo on the CPU, on a free localhost port) with a
timeout of its own; ``run_cli_ranks`` starts the CLI the same way.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence

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
                     config: str = "group_matching", overrides: Sequence[str] = ()):
    """Warm-up and ``n_blocks`` fused train blocks of ``config`` with
    ``batch_size_run = batch_size = n_envs`` and a ring of ``2 n_envs``,
    over ``mesh`` (None: one process), on the CPU, with ``overrides`` (CLI
    ``key=value``s). Returns ([per train block: its metrics, ``t_env`` and
    the sum of its returns], the learner's parameters as one flat CPU
    tensor, this process's ring and the global slots it holds)."""
    from .. import config as tconfig
    from .. import run as trun
    from ..core.pipeline import FusedPipeline

    alg, env, base = CONFIGS[config]
    cfg = tconfig.load_config(alg=alg, env=env, overrides=base + [
        f"batch_size_run={n_envs}", f"batch_size={n_envs}", f"buffer_size={2 * n_envs}",
        f"seed={seed}", "use_cuda=False", *overrides])
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
    held = torch.arange(pipe.buffer_size) if ps.layout is None else ps.layout.held_slots()
    return rows, params, {k: v.clone() for k, v in ps.ring.items()}, held


def _worker(rank: int, world: int, port: int, config: str, n_envs: int, n_blocks: int,
            seed: int, out: str, overrides: Sequence[str] = ()) -> None:
    """One rank of the gate (``world`` 0: one process, no mesh); writes its
    rows, parameters, ring and held slots to ``out``."""
    import torch.distributed as dist

    from .mesh import MeshContext

    torch.set_num_threads(1)
    mesh = None
    if world:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        mesh = MeshContext(torch.device("cpu"))
    try:
        rows, params, ring, held = pipeline_metrics(mesh, n_envs, n_blocks, seed, config,
                                                    overrides)
        torch.save({"rows": rows, "params": params, "ring": ring, "held": held}, out)
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
                seed: int, out: str, overrides: Sequence[str] = ()) -> List[str]:
    return [sys.executable, "-m", "refil_torch.parallel.gate", "--worker", str(rank),
            str(world), str(port), config, str(n_envs), str(n_blocks), str(seed), out,
            *overrides]


def ring_bytes(ring: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for v in ring.values())


def assert_ring_shard(ring: Dict[str, torch.Tensor], held: torch.Tensor,
                      whole: Dict[str, torch.Tensor], n: int, what: str) -> None:
    """``ring`` (one rank's of ``n``) holds exactly the slots ``held`` of the
    one-process ring ``whole``, bit for bit, in 1/n of its bytes."""
    if ring.keys() != whole.keys():
        raise AssertionError(f"{what}: ring planes {sorted(ring)} != {sorted(whole)}")
    if ring_bytes(ring) * n != ring_bytes(whole):
        raise AssertionError(f"{what}: ring of {ring_bytes(ring)} bytes is not 1/{n} of "
                             f"{ring_bytes(whole)}")
    for k, v in ring.items():
        want = whole[k][held]
        if v.dtype != want.dtype or not torch.equal(v.contiguous().view(torch.uint8),
                                                    want.contiguous().view(torch.uint8)):
            raise AssertionError(f"{what}: ring plane {k} differs from its slots of the "
                                 "one-process ring")


def assert_sharded_equals_unsharded(world_size: int, n_blocks: int = 3,
                                    config: str = "group_matching", seed: int = 42,
                                    timeout: float = 120.0, overrides: Sequence[str] = ()
                                    ) -> Dict[str, Any]:
    """The gate: ``world_size`` gloo ranks against one process (all started
    at once), over ``n_blocks`` fused train blocks after the warm-up, each
    with ``max(8, world_size)`` envs. Every metric within rtol 2e-4, atol
    1e-6, ``t_env`` exact, every rank's parameters equal to rank 0's bit for
    bit, and every rank's ring its slots of the one-process ring bit for
    bit, in 1/n of its bytes. Returns both runs' rows and ring bytes."""
    n_envs, port = max(8, world_size), free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        single_out = os.path.join(tmp, "single.pt")
        run_ranks([_worker_cmd(r, world_size, port, config, n_envs, n_blocks, seed, outs[r],
                               overrides) for r in range(world_size)]
                  + [_worker_cmd(0, 0, 0, config, n_envs, n_blocks, seed, single_out,
                                 overrides)], timeout)
        sharded = [torch.load(o, weights_only=True) for o in outs]
        single = torch.load(single_out, weights_only=True)
    for r, res in enumerate(sharded[1:], 1):
        if not torch.equal(res["params"], sharded[0]["params"]):
            raise AssertionError(f"rank {r}'s parameters differ from rank 0's")
    for r, res in enumerate(sharded):
        assert_ring_shard(res["ring"], res["held"], single["ring"], world_size, f"rank {r}")
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
    return {"sharded": sharded[0]["rows"], "single": single["rows"],
            "ring_bytes": [ring_bytes(res["ring"]) for res in sharded],
            "single_ring_bytes": ring_bytes(single["ring"])}


def exchange_ring(size: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A ring of ``size`` episodes whose planes the exchange must carry bit
    for bit: float32 with -0.0 and NaNs of several payloads, bfloat16 (a
    ``buffer_dtype=bfloat16`` ring's features), bool and int64."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((size, 5, 3)).astype(np.float32)
    f32[rng.random(f32.shape) < 0.2] = -0.0
    bits = f32.view(np.uint32)
    nan = rng.random(f32.shape) < 0.05
    bits[nan] = 0x7FC00000 | rng.integers(1, 1 << 22, size=int(nan.sum()), dtype=np.uint32)
    return {"f32": torch.from_numpy(f32),
            "bf16": torch.from_numpy(rng.standard_normal((size, 5, 2)).astype(np.float32)
                                     ).to(torch.bfloat16),
            "mask": torch.from_numpy(rng.random((size, 5, 1)) < 0.5),
            "actions": torch.from_numpy(rng.integers(0, 9, (size, 5, 4)))}


def _exchange_worker(rank: int, world: int, port: int, size: int, period: int,
                     out: str) -> None:
    """One rank of ``assert_exchange_exact``: this rank's part of
    ``exchange_ring`` by ``RingLayout(size, period)``, then one
    ``gather_sample`` of 3 draws of ``2 world`` slots; writes the shard."""
    import torch.distributed as dist

    from .mesh import MeshContext

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = MeshContext(torch.device("cpu"))
        layout = mesh.ring_layout(size, period)
        held = layout.held_slots()
        ring = {k: v[held].clone() for k, v in exchange_ring(size).items()}
        idx = torch.from_numpy(np.stack([np.random.default_rng(i).choice(size, 2 * world,
                                                                          replace=False)
                                         for i in range(3)]))
        shard = mesh.gather_sample(ring, idx, layout)
        torch.save({"idx": idx, "shard": {k: v.clone() for k, v in shard.items()},
                    "launches": dict(mesh.launches)}, out)
    finally:
        dist.destroy_process_group()


def assert_exchange_exact(world_size: int, size: int, period: int,
                          timeout: float = 60.0) -> Dict[str, Any]:
    """``world_size`` gloo ranks each hold their part of ``exchange_ring``
    (``RingLayout(size, period)``) and exchange one sample: each rank's
    shard must be its slice of the global sample, every plane's bytes
    equal, in one ``reduce_scatter``. Returns the ranks' launches."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        run_ranks([[sys.executable, "-m", "refil_torch.parallel.gate", "--exchange", str(r),
                    str(world_size), str(port), str(size), str(period), outs[r]]
                   for r in range(world_size)], timeout)
        res = [torch.load(o, weights_only=True) for o in outs]
    whole = exchange_ring(size)
    for r, rr in enumerate(res):
        b = rr["idx"].shape[1] // world_size
        want = {k: v[rr["idx"]][:, r * b:(r + 1) * b] for k, v in whole.items()}
        assert_ring_shard({k: v.reshape((-1,) + v.shape[2:]) for k, v in rr["shard"].items()},
                          torch.arange(want["f32"].shape[0] * b),
                          {k: v.reshape((-1,) + v.shape[2:]) for k, v in want.items()}, 1,
                          f"rank {r}'s exchanged shard")
    return {"launches": [rr["launches"] for rr in res]}


def cli_rank_commands(world: int, argv: Sequence[str], summary_dir: Optional[str] = None
                      ) -> List[List[str]]:
    """``python -m refil_torch.main argv`` for each of ``world`` ranks, with
    ``distributed=True`` and its rank, over a free localhost port (gloo
    under ``use_cuda=False``); for ``run_ranks``. With ``summary_dir`` each
    rank writes its run's summary to ``summary_dir/rank<r>.json``."""
    port = free_port()
    return [[*cli_command(None if summary_dir is None else
                          os.path.join(summary_dir, f"rank{r}.json")),
             *argv, "distributed=True", f"num_processes={world}", f"process_id={r}",
             f"coordinator_address=127.0.0.1:{port}"] for r in range(world)]


def cli_command(summary_json: Optional[str] = None) -> List[str]:
    """The CLI's command (before its arguments); with ``summary_json`` it
    also writes the run's summary there."""
    if summary_json is None:
        return [sys.executable, "-m", "refil_torch.main"]
    return [sys.executable, "-m", "refil_torch.parallel.gate", "--cli", summary_json]


def run_cli_ranks(world: int, argv: Sequence[str], timeout: float = 120.0) -> None:
    """The CLI as ``world`` ranks (``cli_rank_commands``), waited for."""
    run_ranks(cli_rank_commands(world, argv), timeout)


def main(argv: Sequence[str]) -> None:
    if argv and argv[0] == "--cli":
        from ..main import main as cli_main

        summary = cli_main(list(argv[2:]))
        with open(argv[1], "w") as f:
            json.dump(summary, f, default=str)
        return
    if argv and argv[0] == "--exchange":
        _exchange_worker(*(int(a) for a in argv[1:6]), argv[6])
        return
    if argv and argv[0] == "--worker":
        rank, world, port, config, n_envs, n_blocks, seed, out = argv[1:9]
        _worker(int(rank), int(world), int(port), config, int(n_envs), int(n_blocks),
                int(seed), out, argv[9:])
        return
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("world_size", type=int)
    p.add_argument("overrides", nargs="*", help="key=value overrides of the config")
    p.add_argument("--config", choices=sorted(CONFIGS), default="group_matching")
    p.add_argument("--blocks", type=int, default=3)
    a = p.parse_args(argv)
    out = assert_sharded_equals_unsharded(a.world_size, a.blocks, a.config,
                                          overrides=a.overrides)
    print(f"sharded == unsharded over {a.blocks} blocks ({a.config}, {a.world_size} ranks): "
          f"t_env {[r['t_env'] for r in out['sharded']]}, "
          f"loss {[r['loss'] for r in out['sharded']]}; each rank's ring its slots of the "
          f"one process's, {out['ring_bytes'][0]} of {out['single_ring_bytes']} bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
