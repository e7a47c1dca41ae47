"""The FID and mIoU evaluators with best-checkpoint tracking (port of
``cat_tpu/train/evaluation.py``).

Reference: pix2pix_model.evaluate_model:209-281, cycle_gan_model:310-365,
inception_distiller:204-281, spade_model.evaluate_model:217-288: sweep the
eval loader, dump sample images, compute FID against cached real statistics
or the Cityscapes mIoU of the generated photos, track the best value and the
mean of the last three.  The evaluators run on CUDA unless their caller
passes ``device="cpu"``.

Over several ranks (``process_shard=(rank, world)``) each rank sweeps every
world-th val batch on its own (the step's collectives held off), the
primary alone dumps images, and the FID moments and mIoU confusion
matrices are merged over the ranks (``parallel/multihost.py``); the matrix
square root runs on the primary, which sends the FID to the others.  Every
rank calls an evaluator at the same step (the trainer's cadence).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cat_tpu_torch import resolve_device
from cat_tpu_torch.metrics.fid import get_fid
from cat_tpu_torch.parallel import collectives, multihost
from cat_tpu_torch.utils.image import save_image, tensor2im, tensor2label


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


def _generator_input(batch: Dict, input_key: Optional[str], device: torch.device):
    """What ``generate`` takes from an eval batch: ``batch[input_key]`` on
    the device, or with ``input_key`` None (SPADE's raw label and instance
    maps) the batch with its tensors on the device."""
    if input_key:
        return batch[input_key].to(device)
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def _my_batches(loader, process_shard: Optional[Tuple[int, int]]):
    """The eval batches this rank sweeps: every world-th, from its rank on
    (all of them on one process)."""
    for bi, batch in enumerate(loader):
        if process_shard is None or bi % process_shard[1] == process_shard[0]:
            yield batch


def _split(process_shard: Optional[Tuple[int, int]]) -> bool:
    return process_shard is not None and process_shard[1] > 1


def _sample_names(batch: Dict, n: int):
    paths = batch.get("A_paths") or batch.get("path") or [str(i) for i in range(n)]
    return [os.path.splitext(os.path.basename(p))[0] for p in paths]


class FIDEvaluator:
    """Generator sweep over the eval loader, and FID against cached
    statistics; dumps the first ``dump_images`` samples.

    ``generate`` maps an input batch on ``device`` (``batch[input_key]``, a
    [-1, 1] NCHW image batch; with ``input_key`` None the whole batch, as
    SPADE's label and instance maps) to generated images; the dumps go to
    ``<log_dir>/eval/<step>/``.  ``inception_model`` and ``real_stats`` may
    be None: the sweep still runs and dumps input/Sfake/Tfake(/real) images
    (the profile verb's contract, which holds without judge weights), and no
    metric is returned.  ``name`` names the metric (``metric/<name>``):
    CycleGAN's two directions are fid_B and fid_A.  ``log_dir`` None dumps
    nothing (a rank other than the primary); ``process_shard`` as in the
    module's docstring."""

    def __init__(
        self,
        generate: Callable,
        eval_loader,
        inception_model,
        real_stats: Optional[Dict[str, np.ndarray]],
        log_dir: Optional[str],
        eval_batch_size: int = 32,
        dump_images: int = 10,
        teacher_generate: Optional[Callable] = None,
        device=None,
        name: str = "fid",
        input_key: Optional[str] = "A",
        process_shard: Optional[Tuple[int, int]] = None,
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
        self.input_key = input_key
        self.process_shard = process_shard
        self.device = resolve_device(device)
        self.tracker = MetricTracker(larger_is_better=False)

    def __call__(self, step) -> Tuple[Dict[str, float], Dict[str, bool]]:
        with collectives.local():
            fakes = self._sweep(step)
        if self.inception_model is None or self.real_stats is None:
            return {}, {}
        fakes = np.concatenate(fakes, axis=0) if fakes else np.zeros((0,), np.float32)
        if _split(self.process_shard):
            fid = get_fid(fakes, self.inception_model, self.real_stats,
                          batch_size=self.eval_batch_size,
                          moments_reduce=multihost.reduce_moments,
                          distance=multihost.is_primary())
            fid = multihost.broadcast_value(fid)
        else:
            fid = get_fid(fakes, self.inception_model, self.real_stats,
                          batch_size=self.eval_batch_size)
        improved = self.tracker.update(fid)
        metrics = {f"metric/{self.name}": fid, f"metric/{self.name}-mean": self.tracker.mean,
                   f"metric/{self.name}-best": self.tracker.best}
        return metrics, {"is_best": improved}

    def _sweep(self, step) -> list:
        """This rank's generated images, batch by batch, with the dumps."""
        fakes = []
        dumped = 0
        dump = self.dump_images if self.log_dir is not None else 0
        save_dir = os.path.join(self.log_dir or "", "eval", str(step))
        key = self.input_key
        for batch in _my_batches(self.eval_loader, self.process_shard):
            inp = _generator_input(batch, key, self.device)
            fake = self.generate(inp).float().cpu().numpy()
            fakes.append(fake)
            if dumped < dump:
                tfake = (self.teacher_generate(inp).float().cpu().numpy()
                         if self.teacher_generate else None)
                for j, base in enumerate(_sample_names(batch, len(fake))):
                    if dumped >= dump:
                        break
                    if key:
                        save_image(tensor2im(batch[key][j]),
                                   os.path.join(save_dir, "input", f"{base}.png"))
                    elif "label" in batch:
                        save_image(tensor2label(batch["label"][j]),
                                   os.path.join(save_dir, "input", f"{base}.png"))
                    save_image(tensor2im(fake[j]), os.path.join(
                        save_dir, "Sfake" if tfake is not None else "fake", f"{base}.png"))
                    if tfake is not None:
                        save_image(tensor2im(tfake[j]),
                                   os.path.join(save_dir, "Tfake", f"{base}.png"))
                    if key and "B" in batch:
                        # aligned ground truth (reference inception_distiller.py:238-243)
                        save_image(tensor2im(batch["B"][j]),
                                   os.path.join(save_dir, "real", f"{base}.png"))
                    dumped += 1
        if dumped:
            write_eval_index(save_dir, f"{self.name} eval @ step {step}")
        return fakes


class MIoUEvaluator:
    """Cityscapes mIoU of generated street photos (reference
    metric/mIoU_score.py:209-247, and the SegList table pairing :66-108).

    ``table_path`` rows are ``<name> <label_path> <photo_path>``; a sample
    is scored against the label of the row whose name is its file's stem, or
    whose photo path ends in it, read under ``data_dir``; a sample without
    such a row (or whose label file is missing) is left out.  Labels are
    trainId maps at the judge's resolution.  ``input_key`` as in
    ``FIDEvaluator`` (None for SPADE's raw batches), and ``process_shard``
    as in the module's docstring."""

    def __init__(
        self,
        generate: Callable,
        eval_loader,
        drn_model,
        table_path: str,
        data_dir: str = "",
        batch_size: int = 2,
        name: str = "mIoU",
        input_key: Optional[str] = "A",
        device=None,
        process_shard: Optional[Tuple[int, int]] = None,
    ):
        self.generate = generate
        self.eval_loader = eval_loader
        self.drn_model = drn_model
        self.batch_size = batch_size
        self.name = name
        self.data_dir = data_dir
        self.input_key = input_key
        self.process_shard = process_shard
        self.device = resolve_device(device)
        self.tracker = MetricTracker(larger_is_better=True)
        self.table = []
        with open(table_path) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) >= 3:
                    self.table.append(parts)

    def _label_for(self, sample_name: str) -> Optional[str]:
        for item in self.table:
            if item[0] == sample_name or item[2][: -len(".png")].endswith(sample_name):
                return os.path.join(self.data_dir, item[1])
        return None

    def __call__(self, step) -> Tuple[Dict[str, float], Dict[str, bool]]:
        from PIL import Image

        from cat_tpu_torch.metrics.drn import get_miou
        from cat_tpu_torch.metrics.miou import mean_iou

        fakes, labels = [], []
        with collectives.local():
            for batch in _my_batches(self.eval_loader, self.process_shard):
                fake = self.generate(_generator_input(batch, self.input_key, self.device))
                for j, name in enumerate(_sample_names(batch, fake.shape[0])):
                    label_path = self._label_for(name)
                    if label_path is None or not os.path.exists(label_path):
                        continue
                    fakes.append(fake[j].float())
                    labels.append(np.asarray(Image.open(label_path)))
        hist_reduce = multihost.reduce_hist if _split(self.process_shard) else None
        if not fakes:
            if hist_reduce is None:
                return {}, {}
            # a rank whose share was empty still joins the merge
            n = self.drn_model.classes
            miou = round(mean_iou(hist_reduce(np.zeros((n, n), np.int64))), 2)
        else:
            miou = get_miou(torch.stack(fakes), labels, self.drn_model, batch_size=self.batch_size,
                            target_hw=labels[0].shape[:2], hist_reduce=hist_reduce)
        improved = self.tracker.update(miou)
        metrics = {f"metric/{self.name}": miou, f"metric/{self.name}-mean": self.tracker.mean,
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
