"""Metrics logging: in-memory stats, console tables, a JSONL file and
optional TensorBoard. Port of ``refil_tpu/utils/logging.py``."""
from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Optional

import numpy as np


def get_logger() -> logging.Logger:
    logger = logging.getLogger("refil_torch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(levelname)s %(asctime)s] %(name)s %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class Logger:
    def __init__(self, console_logger: Optional[logging.Logger] = None):
        self.console_logger = console_logger or get_logger()
        self.stats = defaultdict(list)  # name -> [(t, value)]
        self._jsonl = None
        self._tb_writer = None

    def setup_tb(self, directory_name: str) -> None:
        """Writes every later stat to TensorBoard under ``directory_name``;
        warns and skips where ``torch.utils.tensorboard`` cannot be imported
        (it needs the ``tensorboard`` package)."""
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.console_logger.warning("tensorboard unavailable; skipping tb logging")
            return
        os.makedirs(directory_name, exist_ok=True)
        self._tb_writer = SummaryWriter(log_dir=directory_name)

    def setup_jsonl(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._jsonl = open(path, "a")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None

    def log_stat(self, key: str, value, t: int) -> None:
        value = float(value)
        self.stats[key].append((t, value))
        if self._tb_writer is not None:
            self._tb_writer.add_scalar(key, value, t)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"t": t, "key": key, "value": value}) + "\n")
            self._jsonl.flush()

    def print_recent_stats(self) -> None:
        """Console table of the latest stats (mean of the last 5 values)."""
        t_ep = self.stats["episode"][-1] if self.stats.get("episode") else (0, 0)
        log_str = "Recent Stats | t_env: {:>10} | Episode: {:>8}\n".format(t_ep[0], int(t_ep[1]))
        i = 0
        for k, v in sorted(self.stats.items()):
            if k == "episode":
                continue
            i += 1
            window = 5 if k != "epsilon" else 1
            item = "{:.4f}".format(sum(x[1] for x in v[-window:]) / len(v[-window:]))
            log_str += "{:<25}{:>8}".format(k + ":", item)
            log_str += "\n" if i % 4 == 0 else "\t"
        self.console_logger.info(log_str)

    def print_stats_summary(self) -> None:
        """Mean and std of every stat over the whole run."""
        for k, v in sorted(self.stats.items()):
            vals = [x[1] for x in v]
            self.console_logger.info("%s: mean %.4f, std %.4f", k, float(np.mean(vals)),
                                     float(np.std(vals)))
