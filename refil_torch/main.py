"""CLI entry point, the same command line as ``refil_tpu.main``:

    python -m refil_torch.main --config=refil_group_matching \\
        --env-config=group_matching with t_max=4000 seed=7

It runs on the CUDA card; ``with use_cuda=False`` runs on the CPU.
"""
from __future__ import annotations

import sys

from .config import load_config
from .run import run


def parse_cli(argv):
    alg = None
    env = None
    overrides = []
    in_with = False
    for tok in argv:
        if tok.startswith("--config="):
            alg = tok.split("=", 1)[1]
        elif tok.startswith("--env-config="):
            env = tok.split("=", 1)[1]
        elif tok == "with":
            in_with = True
        elif in_with:
            overrides.append(tok)
        else:
            raise SystemExit(f"Unrecognised argument {tok!r}")
    return alg, env, overrides


def main(argv=None):
    """Parses the CLI and runs; returns the run's summary."""
    alg, env, overrides = parse_cli(argv if argv is not None else sys.argv[1:])
    return run(load_config(alg=alg, env=env, overrides=overrides))


if __name__ == "__main__":
    main()
