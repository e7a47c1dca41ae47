"""Training logger (port of ``cat_tpu/utils/logger.py``): an append-only
``log.txt``, the scalar history as ``scalars.jsonl``, and TensorBoard when
tensorboardX happens to be installed.  The text and JSON lines are the JAX
package's."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class Logger:
    def __init__(self, log_dir: str, tensorboard_dir: Optional[str] = None,
                 mute: bool = False):
        """``mute`` (a rank other than the primary): print to this process's
        standard output, write no file."""
        self.log_dir = log_dir
        self.writer = None
        self.mute = mute
        self.log_file = self.scalar_file = None
        if mute:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.log_file = open(os.path.join(log_dir, "log.txt"), "a")
        self.scalar_file = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:  # optional
            from tensorboardX import SummaryWriter  # type: ignore

            self.writer = SummaryWriter(tensorboard_dir or log_dir)
        except ImportError:
            pass

    def plot(self, scalars: Dict[str, float], step: int) -> None:
        if self.mute:
            return
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self.scalar_file.write(json.dumps(record) + "\n")
        self.scalar_file.flush()
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, float(v), int(step))

    def print_info(self, message: str) -> None:
        print(message, flush=True)
        if self.mute:
            return
        self.log_file.write(message.rstrip("\n") + "\n")
        self.log_file.flush()

    def print_current_errors(self, epoch: int, i: int, errors: Dict[str, float],
                             t: float) -> None:
        msg = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        msg += " ".join(f"{k}: {float(v):.3f}" for k, v in errors.items())
        self.print_info(msg)

    def print_current_metrics(self, epoch: int, i: int, metrics: Dict[str, float],
                              t: float) -> None:
        msg = f"###(Evaluate epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        msg += " ".join(f"{k}: {float(v):.3f}" for k, v in metrics.items())
        self.print_info(msg)

    def close(self):
        if self.mute:
            return
        self.log_file.close()
        self.scalar_file.close()
        if self.writer is not None:
            self.writer.close()
