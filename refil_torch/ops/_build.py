"""Builds the CUDA sources in ``refil_torch/csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes ``refil_torch/_build/lib<name>_<hash>.so``, a
shared library with a plain C interface that ``load`` opens with ``ctypes``
for its wrapper (``ops/entity_attn.py``, ``ops/gru_kernel.py``,
``ops/stamp.py``, ``ops/combat_env.py``). The hash covers the source, every header in ``csrc/`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. All sources build in parallel, one ``nvcc`` each. The build uses
only the sources in the repository; a failed build raises with nvcc's
output.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, NamedTuple

from ..utils.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: str  # the shared library
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    ptxas: str  # nvcc's -Xptxas -v report (registers, shared memory, spills)


_BUILT: Dict[str, Built] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> str:
    """The library's path, named by a hash of the source, every header in
    ``csrc/`` (any source may include any of them) and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        h.update(fname.encode())
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all() -> Dict[str, Built]:
    """Builds every ``csrc/*.cu`` not built yet, all ``nvcc`` runs at once."""
    names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if name in _BUILT:
            continue
        target = _target(name)
        log = target[:-3] + ".log"
        if os.path.isfile(target) and os.path.isfile(log):
            with open(log) as f:
                _BUILT[name] = Built(target, 0.0, f.read())
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       target, tmp, log, time.perf_counter())
    failed = []
    for name, (proc, target, tmp, log, t0) in procs.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{output}")
            continue
        with open(log, "w") as f:
            f.write(output)
        os.replace(tmp, target)  # atomic: a concurrent reader never sees half a file
        _BUILT[name] = Built(target, seconds, output)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return dict(_BUILT)


def library(name: str) -> str:
    """Path of the built shared library for ``csrc/<name>.cu``."""
    if name not in _BUILT:
        build_all()
    return _BUILT[name].path


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built where it is not yet and
    loaded: the span ``library.<name>`` of the run's recorder (the first
    library a process loads carries the build of every source)."""
    with span(f"library.{name}"):
        return ctypes.CDLL(library(name))
