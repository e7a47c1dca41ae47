"""The FID evaluator with best-checkpoint tracking (port of the FID half of
``cat_tpu/train/evaluation.py``).

Reference: pix2pix_model.evaluate_model:209-281, cycle_gan_model:310-365,
inception_distiller:204-281: sweep the eval loader, dump sample images,
compute FID against cached real statistics, track the best value and the
mean of the last three.  The mIoU evaluator waits for ROADMAP.md queue 1,
item 13b.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cat_tpu_torch.metrics.fid import get_fid
from cat_tpu_torch.utils.image import save_image, tensor2im


def write_eval_index(save_dir: str, title: str = "") -> Optional[str]:
    """index.html over an eval dump directory's category subdirectories
    (input/Sfake/Tfake/fake/real): one table row per sample, the categories
    side by side."""
    from cat_tpu_torch.utils.html import HTML

    cats = [c for c in ("input", "Sfake", "Tfake", "fake", "real")
            if os.path.isdir(os.path.join(save_dir, c))]
    if not cats:
        return None
    page = HTML(save_dir, title or os.path.basename(save_dir), img_prefix="")
    page.add_header(title or save_dir)
    names = sorted(set().union(*(os.listdir(os.path.join(save_dir, c)) for c in cats)))
    for name in names:
        row = [c for c in cats if os.path.exists(os.path.join(save_dir, c, name))]
        rel = [os.path.join(c, name) for c in row]
        page.add_images(rel, [f"{c}/{name}" for c in row], rel, width=256)
    return page.save()


class MetricTracker:
    """The best value and the mean of the last three (the reference keeps
    self.fids / self.mIoUs)."""

    def __init__(self, larger_is_better: bool = False):
        self.best = -1e9 if larger_is_better else 1e9
        self.larger = larger_is_better
        self.history = []

    def update(self, value: float) -> bool:
        self.history.append(value)
        if len(self.history) > 3:
            self.history.pop(0)
        improved = value > self.best if self.larger else value < self.best
        if improved:
            self.best = value
        return improved

    @property
    def mean(self) -> float:
        return sum(self.history) / len(self.history)


class FIDEvaluator:
    """Generator sweep over the eval loader, and FID against cached
    statistics; dumps the first ``dump_images`` samples.

    ``generate`` maps a [-1, 1] NCHW input batch on ``device`` to generated
    images; the dumps go to ``<log_dir>/eval/<step>/``.  ``inception_model``
    and ``real_stats`` may be None: the sweep still runs and dumps
    input/Sfake/Tfake(/real) images (the profile verb's contract, which holds
    without judge weights), and no metric is returned.  ``name`` names the
    metric (``metric/<name>``): CycleGAN's two directions are fid_B and
    fid_A."""

    def __init__(
        self,
        generate: Callable[[torch.Tensor], torch.Tensor],
        eval_loader,
        inception_model,
        real_stats: Optional[Dict[str, np.ndarray]],
        log_dir: str,
        eval_batch_size: int = 32,
        dump_images: int = 10,
        teacher_generate: Optional[Callable] = None,
        device=None,
        name: str = "fid",
    ):
        self.generate = generate
        self.eval_loader = eval_loader
        self.inception_model = inception_model
        self.real_stats = real_stats
        self.log_dir = log_dir
        self.eval_batch_size = eval_batch_size
        self.dump_images = dump_images
        self.teacher_generate = teacher_generate
        self.name = name
        self.device = torch.device("cpu" if device is None else device)
        self.tracker = MetricTracker(larger_is_better=False)

    def __call__(self, step) -> Tuple[Dict[str, float], Dict[str, bool]]:
        fakes = []
        dumped = 0
        save_dir = os.path.join(self.log_dir, "eval", str(step))
        for batch in self.eval_loader:
            inp = batch["A"].to(self.device)
            fake = self.generate(inp).float().cpu().numpy()
            fakes.append(fake)
            if dumped < self.dump_images:
                tfake = (self.teacher_generate(inp).float().cpu().numpy()
                         if self.teacher_generate else None)
                paths = batch.get("A_paths") or [str(i) for i in range(len(fake))]
                for j in range(len(fake)):
                    if dumped >= self.dump_images:
                        break
                    base = os.path.splitext(os.path.basename(paths[j]))[0]
                    save_image(tensor2im(batch["A"][j]),
                               os.path.join(save_dir, "input", f"{base}.png"))
                    save_image(tensor2im(fake[j]), os.path.join(
                        save_dir, "Sfake" if tfake is not None else "fake", f"{base}.png"))
                    if tfake is not None:
                        save_image(tensor2im(tfake[j]),
                                   os.path.join(save_dir, "Tfake", f"{base}.png"))
                    if "B" in batch:
                        # aligned ground truth (reference inception_distiller.py:238-243)
                        save_image(tensor2im(batch["B"][j]),
                                   os.path.join(save_dir, "real", f"{base}.png"))
                    dumped += 1
        if dumped:
            write_eval_index(save_dir, f"{self.name} eval @ step {step}")
        if self.inception_model is None or self.real_stats is None:
            return {}, {}
        fid = get_fid(np.concatenate(fakes, axis=0), self.inception_model, self.real_stats,
                      batch_size=self.eval_batch_size)
        improved = self.tracker.update(fid)
        metrics = {f"metric/{self.name}": fid, f"metric/{self.name}-mean": self.tracker.mean,
                   f"metric/{self.name}-best": self.tracker.best}
        return metrics, {"is_best": improved}


def combine_evaluators(**named) -> Callable:
    """Merge evaluators into the Trainer's ``evaluate_fn(state, step)``;
    a keyword's suffix names its best flag (``""``: is_best, ``"A"``:
    is_best_A), and a value may be a list of evaluators sharing one flag."""

    def evaluate(state, step):
        metrics: Dict[str, float] = {}
        flags: Dict[str, bool] = {}
        for suffix, evs in named.items():
            if not isinstance(evs, (list, tuple)):
                evs = [evs]
            for ev in evs:
                m, f = ev(step)
                metrics.update(m)
                if f.get("is_best"):
                    flags[f"is_best_{suffix}" if suffix else "is_best"] = True
        return metrics, flags

    return evaluate
