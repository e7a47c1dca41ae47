"""The training loop: epochs, print/eval/checkpoint cadence, LR
schedule (port of ``cat_tpu/train/trainer.py``, the same cadence).

Per iteration one step; every ``print_freq`` iterations the losses are
brought to the host (the only place the loop waits for the device) and
logged; 'latest' is evaluated and saved every ``save_latest_freq``
iterations and at ``iter_base`` (a startup probe that saves only a new
best); every ``save_epoch_freq`` epochs and at the last epoch the state is
saved under 'latest' and the epoch's number; the LR is set per epoch, and
``--lr_policy plateau`` follows the latest evaluation's primary metric.

The loop is task-agnostic.  It consumes
  * ``step_fn(state, device_batch, lr) -> (state, metrics)``,
  * ``evaluate_fn(state, step) -> (metrics, flags)``, where flags may hold
    is_best / is_best_A / is_best_B,
  * ``save_fn(state, tag)``, and ``copy_tag_fn(src, dst)``, which duplicates
    a saved tag's files so a state saved under several tags is serialised
    once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from cat_tpu_torch.data.loader import device_prefetch
from cat_tpu_torch.train.optim import PlateauLR, schedule_lr
from cat_tpu_torch.utils.logger import Logger


@dataclass
class TrainerConfig:
    log_dir: str = "logs"
    nepochs: int = 5
    nepochs_decay: int = 15
    epoch_base: int = 1
    iter_base: int = 1
    print_freq: int = 100
    save_latest_freq: int = 20000
    save_epoch_freq: int = 5
    lr: float = 2e-4
    lr_policy: str = "linear"
    lr_decay_iters: int = 50
    seed: int = 233


def _device_batch(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}


class Trainer:
    def __init__(
        self,
        step_fn: Callable,
        dataloader,
        cfg: TrainerConfig,
        evaluate_fn: Optional[Callable] = None,
        save_fn: Optional[Callable] = None,
        logger: Optional[Logger] = None,
        device: Optional[torch.device] = None,
        copy_tag_fn: Optional[Callable] = None,
    ):
        """``device``: the batches' tensors go there through
        ``data/loader.py::device_prefetch`` (the next batch's copy overlaps
        the running step); None leaves them where the loader puts them."""
        self.step_fn = step_fn
        self.dataloader = dataloader
        self.cfg = cfg
        self.evaluate_fn = evaluate_fn
        self.save_fn = save_fn
        self.logger = logger or Logger(cfg.log_dir)
        self.device = device
        self.copy_tag_fn = copy_tag_fn
        self.plateau = PlateauLR(cfg.lr) if cfg.lr_policy == "plateau" else None
        self._plateau_metric = 0.0

    def _save_tags(self, state, tags):
        """Save ``state`` under several tags with one serialisation: the
        first through ``save_fn``, the rest as file copies."""
        if self.save_fn is None:
            return
        ordered = list(dict.fromkeys(tags))
        self.save_fn(state, ordered[0])
        for tag in ordered[1:]:
            if self.copy_tag_fn is not None:
                self.copy_tag_fn(ordered[0], tag)
            else:
                self.save_fn(state, tag)

    def _evaluate(self, state, epoch: int, total_iter: int, message: str,
                  extra_tags=(), save: bool = True):
        if self.evaluate_fn is None:
            # no evaluators (a run without judge weights): still checkpoint
            # 'latest' at cadence
            self.logger.print_info(message)
            if save:
                self._save_tags(state, ["latest", *extra_tags])
            return {}
        start = time.time()
        metrics, flags = self.evaluate_fn(state, total_iter)
        primary = [v for k, v in metrics.items()
                   if k.startswith("metric/") and not k.endswith(("-mean", "-best"))]
        if primary:
            self._plateau_metric = float(primary[0])
        self.logger.print_current_metrics(epoch, total_iter, metrics, time.time() - start)
        self.logger.plot(metrics, total_iter)
        self.logger.print_info(message)
        best_tags = [t for t, f in (("best", "is_best"), ("best_A", "is_best_A"),
                                    ("best_B", "is_best_B")) if flags.get(f)]
        if not save:
            # the startup probe saves no cadence checkpoint, but a best it
            # registered must reach the disk
            if best_tags:
                self._save_tags(state, best_tags)
            return metrics
        tags = ["latest"]
        if best_tags:
            tags += [f"iter{total_iter}", *best_tags]
        self._save_tags(state, tags + list(extra_tags))
        return metrics

    def fit(self, state) -> Any:
        cfg = self.cfg
        start_epoch = cfg.epoch_base
        end_epoch = cfg.epoch_base + cfg.nepochs + cfg.nepochs_decay - 1
        total_iter = cfg.iter_base
        for epoch in range(start_epoch, end_epoch + 1):
            epoch_start = time.time()
            lr = schedule_lr(cfg.lr_policy, epoch - 1, cfg.lr, nepochs=cfg.nepochs,
                             nepochs_decay=cfg.nepochs_decay,
                             lr_decay_iters=cfg.lr_decay_iters, plateau=self.plateau)
            batch_iter = (_device_batch(b) for b in self.dataloader)
            if self.device is not None:
                batch_iter = device_prefetch(batch_iter, self.device)
            for batch in batch_iter:
                iter_start = time.time()
                state, metrics = self.step_fn(state, batch, lr)
                if total_iter % cfg.print_freq == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    self.logger.print_current_errors(epoch, total_iter, host,
                                                     time.time() - iter_start)
                    self.logger.plot(host, total_iter)
                if total_iter % cfg.save_latest_freq == 0 or total_iter == cfg.iter_base:
                    save = total_iter != cfg.iter_base or total_iter % cfg.save_latest_freq == 0
                    self._evaluate(
                        state, epoch, total_iter,
                        f"Saving the latest model (epoch {epoch}, total_steps {total_iter})"
                        if save else
                        f"Evaluated the initial model (epoch {epoch}, total_steps {total_iter})",
                        save=save,
                    )
                total_iter += 1
            self.logger.print_info("End of epoch %d / %d \t Time Taken: %.2f sec"
                                   % (epoch, end_epoch, time.time() - epoch_start))
            if epoch % cfg.save_epoch_freq == 0 or epoch == end_epoch:
                self._evaluate(state, epoch, total_iter,
                               f"Saving the model at the end of epoch {epoch}, iters {total_iter}",
                               extra_tags=(str(epoch),))
            if self.plateau is not None:
                new_lr = self.plateau.update(self._plateau_metric)
                if new_lr != lr:
                    self.logger.print_info(f"plateau: learning rate {lr:.3g} -> {new_lr:.3g} "
                                           f"(metric {self._plateau_metric:.4f})")
        return state
