"""The distill verb end to end (port of the inception half of
``cat_tpu/entry.py``'s distill verb).

``distill_main`` parses the JAX package's distill flags, builds the loader,
restores the teacher, shrinks it to the student architecture
(``--target_flops``), carries a pretrained generator's weights into the
student (``--restore_pretrained_G_path``), restores D, the adaptors and the
full train state where asked, and hands a step, save and copy function to
the ``Trainer``.  It runs on CUDA unless the caller passes ``device="cpu"``.

Evaluation (FID, mIoU) is not ported yet (ROADMAP.md queue 1, item 13): as
the JAX package does when the judge files are absent, the verb warns and
trains without it; it raises when they are present.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from cat_tpu_torch import cli, resolve_device
from cat_tpu_torch.compress.profiling import profile_generator
from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
from cat_tpu_torch.core.config import config_to_json
from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict
from cat_tpu_torch.train.trainer import Trainer
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from cat_tpu_torch.utils.logger import Logger


def _packed(opt, family_default: bool) -> bool:
    """--packed_blocks tri-state: None keeps the family default (ON for the
    inception family)."""
    v = getattr(opt, "packed_blocks", None)
    return family_default if v is None else bool(v)


def _ema_decay(opt) -> float:
    """Effective student-G EMA decay.  --moving_average_decay_adjust
    rescales the per-step decay for the batch size as d**(B/B_base), so the
    averaging horizon stays constant in epochs."""
    d = getattr(opt, "moving_average_decay", 0.0)
    if d > 0 and getattr(opt, "moving_average_decay_adjust", False):
        base = max(int(getattr(opt, "moving_average_decay_base_batch", 32)), 1)
        d = float(d) ** (float(opt.batch_size) / base)
    return float(d)


def _maybe_restore_state(opt, state, dist):
    """--restore_state_path: resume the full train state (parameters, Adam
    moments, step, RNG) that every save writes as <tag>_state.pth, or the
    JAX package's <tag>_state.msgpack (all but its RNG); pair it with
    --epoch_base/--iter_base to continue the schedule.  --restore_O_path is
    subsumed by the full-state restore."""
    p = getattr(opt, "restore_state_path", None)
    if p:
        sd = ckpt.load_pytree(p)
        if p.endswith(".msgpack"):
            sd = jax_import.distill_state_dict(sd, dist.student_cfg, dist.disc_cfg,
                                               adaptors=bool(state.adaptors))
            print("WARNING: the dropout RNG of a JAX package train state does not carry "
                  "over; it stays seeded from --seed.")
        load_train_state_dict(state, sd)
        print(f"restored full train state from {p}")
    if getattr(opt, "restore_O_path", None):
        print("WARNING: --restore_O_path is subsumed by --restore_state_path "
              "(full-state checkpoints carry optimizer moments); ignored.")
    return state


def _check_no_evaluation(opt) -> None:
    """Evaluation is not ported yet: warn and train without it when its
    files are absent, as the JAX package does; raise when they exist."""
    have_judge = bool(opt.inception_path) and os.path.exists(opt.inception_path)
    have_stats = bool(opt.real_stat_path) and os.path.exists(opt.real_stat_path)
    miou = ("cityscapes" in opt.dataroot and opt.direction == "BtoA" and bool(opt.drn_path)
            and os.path.exists(opt.drn_path) and os.path.exists(opt.table_path))
    if (have_judge and have_stats) or miou:
        raise NotImplementedError("evaluation (FID / mIoU) is not ported yet: ROADMAP.md "
                                  "queue 1, item 13, Evaluation")
    if not have_judge:
        print(f"WARNING: inception weights not found at {opt.inception_path!r}; "
              "FID evaluation disabled.")
    if opt.real_stat_path and not have_stats:
        print(f"WARNING: real stats not found at {opt.real_stat_path!r}; FID disabled.")


def _make_train_loader(opt, spec, device: torch.device):
    """Host DataLoader, or the device-resident bank with --on_device_data
    (unaligned resize_and_crop without --serial_batches; other modes fall
    back to the host loader, as in the JAX package)."""
    if opt.on_device_data:
        if (opt.dataset_mode == "unaligned" and spec.preprocess == "resize_and_crop"
                and not spec.grayscale and not opt.serial_batches):
            from cat_tpu_torch.data.device_data import DeviceData, DeviceDataLoader

            dd, n = DeviceData.from_unaligned(opt.dataroot, opt.phase, spec.load_size,
                                              spec.crop_size, no_flip=spec.no_flip,
                                              max_size=opt.max_dataset_size, device=device)
            return DeviceDataLoader(dd, opt.batch_size, max(n // opt.batch_size, 1),
                                    seed=opt.seed)
        print("WARNING: --on_device_data supports unaligned resize_and_crop without "
              "--serial_batches; using the host loader instead.")
    from cat_tpu_torch.data.datasets import create_dataloader

    return create_dataloader(
        opt.dataset_mode, opt.dataroot, opt.batch_size, spec, phase=opt.phase,
        direction=opt.direction, serial_batches=opt.serial_batches,
        max_size=opt.max_dataset_size, seed=opt.seed, load_in_memory=opt.load_in_memory,
        num_workers=opt.num_threads, worker_mode=opt.data_backend,
    )


def shrink_preamble(opt, teacher_cfg, teacher_sd, logger) -> Tuple[Any, Optional[Dict], float]:
    """FLOPs-targeted pruning of the teacher into the student architecture.
    Returns (student config, student state_dict or None, pruning seconds):
    the student is re-initialised unless --prune_init sliced keeps the
    surviving teacher weights."""
    bounds = PruneBounds(
        cin_lb=max(opt.prune_cin_lb, 1),
        cin_ub=opt.prune_cin_ub if opt.prune_cin_ub > 0 else None,
        ft_cin_lb=max(opt.prune_ft_cin_lb, 1),
    )
    t0 = time.time()
    res = shrink_generator(teacher_cfg, teacher_sd, opt.target_flops, opt.crop_size,
                           opt.crop_size, bounds)
    dt = time.time() - t0
    logger.print_info(
        f"scale threshold: {res.threshold:.6g}, searched flops: {res.searched_macs:,}, "
        f"target flops: {opt.target_flops:g}, flops diff: "
        f"{res.searched_macs - opt.target_flops:g} (pruning took {dt * 1e3:.1f} ms)"
    )
    prof = profile_generator(res.config, opt.crop_size, opt.crop_size)
    logger.print_info(
        f"netG student FLOPs: {prof.macs:,}; down sampling: "
        f"{prof.sections['down_sampling']:,}; features: {prof.sections['features']:,}; "
        f"up sampling: {prof.sections['up_sampling']:,}."
    )
    student_sd = res.state_dict if opt.prune_init == "sliced" else None
    return res.config, student_sd, dt


def _load_net(path: str, convert, what: str) -> Dict[str, torch.Tensor]:
    """A network's state_dict from a ``.pth`` of this package, or from a
    JAX package ``.msgpack`` through ``convert(params)``."""
    tree = ckpt.load_pytree(path)
    sd = convert(tree["params"]) if path.endswith(".msgpack") else tree
    print(f"restored {what} from {path}")
    return sd


@dataclass
class DistillRun:
    """What ``setup_distill`` builds; ``distill_main`` returns it with the
    state after training."""

    trainer: Optional[Trainer]
    state: Any
    distiller: Any
    teacher_params: Dict[str, torch.Tensor]
    student_cfg: Any
    loader: Any
    logger: Logger

    def close(self) -> None:
        close = getattr(self.loader, "close", None)
        if close is not None:
            close()
        self.logger.close()


def setup_distill(opt, device=None, loader=None) -> DistillRun:
    cli.check_ported(opt)
    return setup_distill_inception(opt, device, loader)


def setup_distill_inception(opt, device=None, loader=None) -> DistillRun:
    """``loader``: the training batches; None builds them from the flags
    (any iterable of dicts of NCHW tensors with ``len`` steps per epoch
    will do, e.g. a ``data/device_data.py::DeviceDataLoader``)."""
    from cat_tpu_torch.compress.transfer import transfer_generator_state_dict
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller

    device = resolve_device(device)
    cli.set_seed(opt.seed)
    _check_no_evaluation(opt)
    if loader is None:
        loader = _make_train_loader(opt, cli.transform_spec(opt), device)
    logger = Logger(opt.log_dir, opt.tensorboard_dir)
    save_dir = os.path.join(opt.log_dir, "checkpoints")

    teacher_norm = cli.norm_config(opt, opt.norm_affine)
    teacher_cfg, teacher_sd = cli.load_generator_checkpoint(opt.restore_teacher_G_path,
                                                            teacher_norm)
    t_prof = profile_generator(teacher_cfg, opt.crop_size, opt.crop_size)
    logger.print_info(f"netG teacher FLOPs: {t_prof.macs:,}; params: {t_prof.params:,}")

    # shrink -> student architecture
    if opt.target_flops > 0:
        student_cfg, student_sd, _ = shrink_preamble(opt, teacher_cfg, teacher_sd, logger)
    else:
        student_cfg, student_sd = cli.generator_config(opt, opt.student_ngf), None

    # magnitude weight transfer from a wide pretrained generator into the
    # student, a shrink-pruned one included (the shipped student recipes
    # pass --restore_pretrained_G_path with --target_flops); --prune_init
    # sliced takes precedence
    if opt.restore_pretrained_G_path and student_sd is None:
        p_cfg, p_sd = cli.load_generator_checkpoint(opt.restore_pretrained_G_path, teacher_norm)
        student_sd = transfer_generator_state_dict(p_sd, p_cfg, student_cfg)
        logger.print_info("Pretrained weights transferred into the student.")

    if opt.restore_student_G_path:  # prune_continue-style restore
        student_cfg, student_sd = cli.load_generator_checkpoint(opt.restore_student_G_path,
                                                                teacher_norm)

    # taps: the encoder output and every third block (features 2/5/8 of 9)
    mapping = ("encode",) + tuple(f"block{i}" for i in range(2, teacher_cfg.n_blocks, 3))
    hp = DistillHParams(
        dataset_mode=opt.dataset_mode,
        gan_mode=opt.gan_mode,
        recon_loss_type=opt.recon_loss_type,
        distill_loss_type=opt.distill_G_loss_type,
        lambda_gan=opt.lambda_gan,
        lambda_recon=opt.lambda_recon,
        lambda_distill=opt.lambda_distill,
        beta1=opt.beta1,
        init_type=opt.init_type,
        init_gain=opt.init_gain,
        mapping_layers=mapping,
        compute_dtype=opt.compute_dtype,
        teacher_compute_dtype=opt.teacher_compute_dtype or "",
        fused_norms=opt.fused_norms,
        packed_blocks=_packed(opt, True),
        remat=bool(opt.remat),
        ema_decay=_ema_decay(opt),
    )
    d_in = (teacher_cfg.input_nc + teacher_cfg.output_nc
            if opt.dataset_mode == "aligned" else teacher_cfg.output_nc)
    disc_cfg = cli.discriminator_config(opt, d_in)
    dist = InceptionDistiller(teacher_cfg, student_cfg, disc_cfg=disc_cfg, hp=hp, device=device)
    disc_sd = None
    if opt.restore_D_path:
        # warm-start D from a teacher-training checkpoint (weights only,
        # fresh optimiser), as the shipped student recipes do
        disc_sd = _load_net(opt.restore_D_path,
                            lambda p: jax_import.nlayer_discriminator_state_dict(p, disc_cfg),
                            "D")
    state, teacher_params = dist.init_state(teacher_sd, student_sd, disc_sd, seed=opt.seed)
    if opt.restore_A_path:
        a_sd = _load_net(opt.restore_A_path, jax_import.adaptor_state_dict, "adaptors")
        if not state.adaptors:
            print("WARNING: --restore_A_path: adaptors are used only by "
                  "--distill_G_loss_type mse; ignored.")
        else:
            with torch.no_grad():
                for k, v in state.adaptors.items():
                    v.copy_(a_sd[k])
    state = _maybe_restore_state(opt, state, dist)
    with open(os.path.join(opt.log_dir, "student_config.json"), "w") as f:
        f.write(config_to_json(student_cfg))
    if opt.prune_only:
        logger.print_info("prune_only: student architecture emitted; exiting.")
        return DistillRun(None, state, dist, teacher_params, student_cfg, loader, logger)

    def save_fn(state, tag):
        # net_G holds what evaluation and deployment use: the EMA weights
        # with --moving_average_decay (the raw weights then go to net_G_raw),
        # else the trained weights
        eval_params = dist.student_eval_params(state)
        ckpt.save_net(save_dir, tag, "G", eval_params, student_cfg)
        if eval_params is not state.g.params:
            ckpt.save_net(save_dir, tag, "G_raw", state.g.params, student_cfg)
        else:
            ckpt.remove_stale(save_dir, tag, "net_G_raw.pth")
            ckpt.remove_stale(save_dir, tag, "net_G_raw.json")
        ckpt.save_net(save_dir, tag, "D", state.d.params, disc_cfg)
        if state.adaptors:
            ckpt.save_net(save_dir, tag, "A", state.adaptors)
        if opt.save_full_state:
            ckpt.save_train_state(save_dir, tag, train_state_dict(state))
        else:
            ckpt.remove_stale(save_dir, tag, "state.pth")

    def step_fn(state, batch, lr):
        return dist.train_step(state, teacher_params, batch, lr)

    trainer = Trainer(step_fn, loader, cli.trainer_config(opt), None, save_fn, logger,
                      device=device, copy_tag_fn=lambda s, d: ckpt.copy_tag(save_dir, s, d))
    return DistillRun(trainer, state, dist, teacher_params, student_cfg, loader, logger)


def distill_main(argv: Optional[List[str]] = None, device=None) -> DistillRun:
    """``python -m cat_tpu_torch distill <flags>``: the JAX package's distill
    flags; runs on CUDA unless ``device`` says otherwise (the tests pass
    ``device="cpu"``)."""
    parser = cli.distill_parser()
    opt = parser.parse_args(argv)
    cli.check_ported(opt)
    device = resolve_device(device)
    cli.print_options(opt, parser)
    run = setup_distill(opt, device)
    try:
        if run.trainer is not None:
            run.state = run.trainer.fit(run.state)
    finally:
        run.close()
    return run
