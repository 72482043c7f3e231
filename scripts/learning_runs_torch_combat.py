"""Combat learning curves on the card (ROADMAP A6, stage 2): shipped configs
on ``sc2custom`` scenario sets through ``python -m refil_torch.main`` at the
reference's untouched r5 protocol (``config/algs/<config>.yaml`` and
``config/envs/sc2custom.yaml``: epsilon 1 -> 0.05 over 500k, buffer 5,000,
160-episode test blocks every 50k), only ``t_max`` and the seed set. Then
the test win-rate crossings (``test_battle_won_mean``): the first test point
at or above 0.5 and 0.9, beside the JAX reference runs' of the same config
and set (``REFERENCES``: ``results/r5_runs/<run>``, every seed there is).
The random streams differ from the reference's, so the crossings are
compared at test-block granularity, not point by point.

    python scripts/learning_runs_torch_combat.py [OUT]   # refil, 3-8sz_symmetric, seed 0
    python scripts/learning_runs_torch_combat.py OUT --config qmix_atten --t-max 3800000
    python scripts/learning_runs_torch_combat.py OUT --scenario 3-8MMM_symmetric --seed 1
    python scripts/learning_runs_torch_combat.py OUT --run refil:csz:0:3100000 \\
        --run qmix_atten:mmm:1:1600000 --parallel 2 --stop-at 0.9

A ``--run`` is ``CONFIG:SET:SEED[:T_MAX]`` (SET a scenario set or its short
name in ``SETS``; ``--t-max`` where T_MAX is absent); without one, the run is
``--config``/``--scenario``/``--seed``/``--t-max``. Each run is a process of
its own, at most ``--parallel`` at once (0: all). Where more than one card is
visible (``nvidia-smi``, within ``CUDA_VISIBLE_DEVICES``), each run is pinned
to the card that holds the fewest running runs when it starts; with one card,
they share it. ``--stop-at X`` sends a run SIGTERM once a test point reaches
X: the CLI's preemption handler ends it after its dispatch (its checkpoint,
written without the ring, is deleted), so its curve ends at the first point
at or above X; ``--wall-limit S`` ends every run so after S seconds (and
starts no more), so that a call's time limit never cuts one. Further
``key=value`` arguments go to every run's CLI.

A run is named ``<config>_<set>_s<seed>`` (``SETS``: sz, mmm, csz, as
``results/r5_runs`` names them) and writes its metrics, ``summary.json`` and
``run.log`` under ``OUT/<name>``; the default OUT is
``results/combat_curves``. Prints every card's index, name and power limit,
then one JSON line a run: its card and the runs that shared it (with the
seconds they overlapped), whether it was stopped, the crossings, the curve,
the whole run's env-steps/s (t_env over wall seconds, tests included), the
training env-steps/s and each test rollout's seconds. Exits non-zero if a
run failed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the scenario sets' short names in run names, as results/r5_runs has them
SETS = {"3-8sz_symmetric": "sz", "3-8MMM_symmetric": "mmm", "3-8csz_symmetric": "csz"}
# (config, scenario set) -> {seed: the JAX reference run of results/r5_runs}
REFERENCES = {
    ("refil", "3-8sz_symmetric"): {0: "refil_sz", 1: "refil_sz_s1"},
    ("qmix_atten", "3-8sz_symmetric"): {0: "qmix_atten_sz", 1: "qmix_atten_sz_s1"},
    ("refil", "3-8MMM_symmetric"): {0: "refil_mmm"},
    ("qmix_atten", "3-8MMM_symmetric"): {0: "qmix_atten_mmm"},
    ("refil", "3-8csz_symmetric"): {0: "refil_csz"},
    ("qmix_atten", "3-8csz_symmetric"): {0: "qmix_atten_csz"},
}
KEY = "test_battle_won_mean"
POLL_S = 5.0


def curve(results_dir, key=KEY):
    rows = []
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    return sorted({r["t"]: r["value"] for r in rows if r["key"] == key}.items())


def crossings(points):
    """First t at or above 0.5 and 0.9 (None where the curve never gets there)."""
    first = lambda thr: next((t for t, v in points if v >= thr), None)  # noqa: E731
    return {"ge_0.5": first(0.5), "ge_0.9": first(0.9),
            "best": max((v for _, v in points), default=None), "points": len(points)}


def run_name(config, scenario, seed):
    return f"{config}_{SETS.get(scenario, scenario)}_s{seed}"


def references(config, scenario):
    """{label: directory under the repo} of the reference runs of
    (config, scenario), one a seed; empty where the reference has none."""
    return {f"{run} (seed {seed})": os.path.join("results", "r5_runs", run)
            for seed, run in sorted(REFERENCES.get((config, scenario), {}).items())}


def run_plan(out, config, scenario, seed, t_max, overrides):
    """(run name, CLI argv, references) of one run."""
    name = run_name(config, scenario, seed)
    cli = [f"--config={config}", "--env-config=sc2custom", "with",
           f"scenario={scenario}", f"seed={seed}", f"t_max={t_max}",
           f"name={name}", f"local_results_path={os.path.join(out, name)}", *overrides]
    return name, cli, references(config, scenario)


def parse_run(spec, t_max):
    """``CONFIG:SET:SEED[:T_MAX]`` -> (config, scenario, seed, t_max)."""
    parts = spec.split(":")
    if len(parts) not in (3, 4):
        raise SystemExit(f"--run {spec!r}: want CONFIG:SET:SEED[:T_MAX]")
    scenario = {short: s for s, short in SETS.items()}.get(parts[1], parts[1])
    return parts[0], scenario, int(parts[2]), int(parts[3]) if len(parts) == 4 else t_max


def plans(args):
    """(run name, CLI argv, references) of every run the arguments ask for."""
    runs = ([parse_run(s, args.t_max) for s in args.run] if args.run
            else [(args.config, args.scenario, args.seed, args.t_max)])
    # a stopped run's preemption checkpoint needs no ring: it is deleted
    stops = args.stop_at is not None or args.wall_limit is not None
    extra = [*args.overrides, *(["preempt_save_buffer=False"] if stops else [])]
    out = [run_plan(args.out, *r, extra) for r in runs]
    names = [name for name, _, _ in out]
    if len(set(names)) != len(names):
        raise SystemExit(f"two runs share a name: {names}")
    return out


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(ROOT, "results", "combat_curves"))
    ap.add_argument("--config", default="refil")
    ap.add_argument("--scenario", default="3-8sz_symmetric")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--t-max", type=int, default=1_600_000)
    ap.add_argument("--run", action="append", default=[],
                    help="CONFIG:SET:SEED[:T_MAX], once a run")
    ap.add_argument("--parallel", type=int, default=0, help="runs at once (0: all)")
    ap.add_argument("--stop-at", type=float, default=None,
                    help="end a run once a test point reaches this win rate")
    ap.add_argument("--wall-limit", type=float, default=None,
                    help="seconds after which every running run is ended as --stop-at ends it")
    ap.add_argument("overrides", nargs="*", default=[],
                    help="further key=value overrides for the CLI")
    return ap.parse_args(argv)


def cards():
    """[(index, "name, power limit")] of the visible cards; empty where
    there is no nvidia-smi."""
    if not shutil.which("nvidia-smi"):
        return []
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    rows = [line.split(",", 1) for line in out.strip().splitlines()]
    found = [(i.strip(), rest.strip()) for i, rest in rows]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        keep = [v.strip() for v in visible.split(",") if v.strip()]
        found = [c for c in found if c[0] in keep]
    return found


def worker(out, cli):
    """One run, in this process; writes its summary next to its metrics."""
    sys.path.insert(0, ROOT)
    from refil_torch.main import main as cli_main

    t0 = time.perf_counter()
    summary = cli_main(cli)
    summary = {k: v for k, v in summary.items() if k not in ("dispatches",)}
    summary["wall_seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, default=str)


def pick_card(found, held):
    """The index of the card a starting run takes, ``held`` the cards of the
    running runs: of several, the first that the fewest hold (the run is
    pinned to it); the one card, shared; None without nvidia-smi."""
    if not found:
        return None
    return min((i for i, _ in found), key=held.count)


def overlaps(spans):
    """{name: {other: seconds}} of the runs whose spans on one card overlap."""
    shared = {n: {} for n in spans}
    for a, (ca, sa, ea) in spans.items():
        for b, (cb, sb, eb) in spans.items():
            seconds = min(ea, eb) - max(sa, sb)
            if a != b and ca == cb and seconds > 0:
                shared[a][b] = seconds
    return shared


def launch(root, runs, parallel, stop_at, found, wall_limit=None):
    """Runs every (name, cli, refs) as a worker process writing under
    ``root/name``, at most ``parallel`` at once, each on the least-held card;
    returns ({name: (card, start s, end s)}, {name: why it was stopped: the
    t_env of the test point that reached ``stop_at``, or "wall_limit"},
    [failed names]). Past ``wall_limit`` seconds no run starts and every
    running one is stopped."""
    pending, running, spans, stopped, failed = list(runs), {}, {}, {}, []
    parallel = parallel or len(runs)
    t0 = time.perf_counter()
    try:
        while pending or running:
            if wall_limit is not None and time.perf_counter() - t0 > wall_limit:
                pending = []
                for name, (proc, _, _) in running.items():
                    if name not in stopped:
                        proc.send_signal(signal.SIGTERM)
                        stopped[name] = "wall_limit"
            while pending and len(running) < parallel:
                name, cli, _ = pending.pop(0)
                out = os.path.join(root, name)
                os.makedirs(out, exist_ok=True)
                env = dict(os.environ)
                card = pick_card(found, [c for _, c, _ in running.values()])
                if len(found) > 1:
                    env["CUDA_VISIBLE_DEVICES"] = card
                log = open(os.path.join(out, "run.log"), "w")
                proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--worker", out, json.dumps(cli)],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
                running[name] = (proc, card, log)
                spans[name] = (card, time.perf_counter() - t0, None)
            time.sleep(POLL_S)
            for name, (proc, card, log) in list(running.items()):
                out = os.path.join(root, name)
                if proc.poll() is not None:
                    running.pop(name)
                    log.close()
                    spans[name] = (card, spans[name][1], time.perf_counter() - t0)
                    if proc.returncode != 0:
                        failed.append(name)
                    shutil.rmtree(os.path.join(out, "models"), ignore_errors=True)
                elif stop_at is not None and name not in stopped:
                    hit = next((t for t, v in curve(out) if v >= stop_at), None)
                    if hit is not None:
                        proc.send_signal(signal.SIGTERM)
                        stopped[name] = hit
    finally:
        for proc, _, _ in running.values():
            proc.kill()
    return spans, stopped, failed


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1], json.loads(argv[2]))
        return
    args = parse(argv)
    found = cards()
    names_power = dict(found)
    runs = plans(args)
    spans, stopped, failed = launch(args.out, runs, args.parallel, args.stop_at, found,
                                    args.wall_limit)
    for i, name_power in found:
        print(f"card {i}: {name_power}", flush=True)
    if not found:
        print("no nvidia-smi", flush=True)
    shared = overlaps(spans)
    for name, cli, refs in runs:
        if name not in spans:  # past the wall limit before it started
            failed.append(name)
            print(json.dumps({"run": name, "ok": False, "started": False}), flush=True)
            continue
        out = os.path.join(args.out, name)
        port = curve(out)
        summary = {}
        if os.path.exists(os.path.join(out, "summary.json")):
            with open(os.path.join(out, "summary.json")) as f:
                summary = json.load(f)
        tests = summary.get("tests") or []
        card, _, _ = spans[name]
        wall = summary.get("wall_seconds")
        row = {"run": name, "card_index": card, "card": names_power.get(card),
               "shared_with": shared[name], "stopped": stopped.get(name),
               "cli": cli, "ok": name not in failed, "port": crossings(port),
               "reference": {k: crossings(curve(os.path.join(ROOT, d)))
                             for k, d in refs.items()},
               "t_env": summary.get("t_env"), "wall_seconds": wall,
               "whole_run_env_steps_per_s": (summary["t_env"] / wall if wall else None),
               "train_env_steps_per_s": summary.get("env_steps_per_s"),
               "test_rollout_seconds": [t.get("seconds") for t in tests],
               "test_rollout_seconds_total": sum(t.get("seconds") or 0.0 for t in tests),
               "port_curve": port}
        print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit(f"runs failed: {failed} (see their run.log)")


if __name__ == "__main__":
    main(sys.argv[1:])
