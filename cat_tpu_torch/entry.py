"""The verbs end to end (port of ``cat_tpu/entry.py``: train, distill,
profile, export and get_real_stat; and of ``tools/kid_score.py``).

``train_main`` trains a pix2pix, CycleGAN or GauGAN (SPADE) teacher from
the JAX package's train flags (``train/pix2pix.py``, ``train/cyclegan.py``,
``train/spade_model.py``), with FID (and, on Cityscapes, mIoU) at the
trainer's cadence where their files are given, and writes the checkpoints
the distill verb restores (``G``/``D``, or ``G_A``, ``G_B``, ``D_A``,
``D_B``).

``distill_main`` parses the JAX package's distill flags, builds the loader,
restores the teacher, shrinks it to the student architecture
(``--target_flops``), carries a pretrained generator's weights into the
student (``--restore_pretrained_G_path``), restores D, the adaptors and the
full train state where asked, and hands a step, save, copy and evaluate
function to the ``Trainer``.  With the judge's weights (``--inception_path``)
and the real statistics (``--real_stat_path``) present, it evaluates FID at
the trainer's cadence and tags the best checkpoints; without them it warns
and trains without FID, as the JAX package does.  On Cityscapes photos
(a dataroot naming cityscapes, BtoA) it also evaluates mIoU with the DRN
judge (``--drn_path``, ``--table_path``, ``--cityscapes_path``), and warns
and goes without where their files are absent.  ``--distiller spade``
distils a GauGAN teacher (``setup_distill_spade``): the SPADE shrink, the
SPADE transfer, the teacher's D, the Cityscapes loader, FID and mIoU.

``profile_main`` times the shrink, counts the student's MACs and parameters,
times its forward at batch 1 and sweeps the val set with every image
dumped (``profile_distill_spade`` under ``--distiller spade``);
``export_main`` writes the student as a ``torch.export`` program;
``real_stat_main`` writes the judge's statistics of a folder;
``kid_score_main`` scores two folders.  Every verb runs on CUDA unless the
caller passes ``device="cpu"``.

The train and distill verbs also run data-parallel, one process a device
(``parallel/``): ``--n_devices k`` spawns k ranks on this host, and
``--multihost 1`` / ``--num_processes`` join a group of processes started
elsewhere.  ``--n_spatial S`` splits image height over S ranks as well
(k·S ranks on this host, ``parallel/spatial.py``; both families: the
SPADE verbs keep the label maps whole on every rank and cut the photos).
Every rank builds the same state from the same seed and files (then takes
rank 0's tensors), decodes its slice of every global batch (and of each
image its rows), and computes with the others the single-device step of
the global batch; the primary alone writes options, logs, checkpoints and
dumps.  The other verbs run in one process, as in the JAX package.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cat_tpu_torch import cli, import_stdlib_profile, resolve_device
from cat_tpu_torch.compress.profiling import profile_generator
from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
from cat_tpu_torch.core.config import config_to_json
from cat_tpu_torch.parallel import collectives, mesh, multihost
from cat_tpu_torch.train.common import load_train_state_dict, student_eval_params, train_state_dict
from cat_tpu_torch.train.trainer import Trainer
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from cat_tpu_torch.utils.logger import Logger


def _packed(opt, family_default: bool) -> bool:
    """--packed_blocks tri-state: None keeps the family default (ON for both
    families)."""
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


def _maybe_restore_state(opt, state, convert):
    """--restore_state_path: resume the full train state (parameters,
    running statistics, Adam moments, step, pools, RNG) that every save
    writes as <tag>_state.pth, or the JAX package's <tag>_state.msgpack
    through ``convert(tree)`` (all but its RNG); pair it with
    --epoch_base/--iter_base to continue the schedule.  --restore_O_path is
    subsumed by the full-state restore."""
    p = getattr(opt, "restore_state_path", None)
    if p:
        sd = ckpt.load_pytree(p)
        if p.endswith(".msgpack"):
            sd = convert(sd)
            print("WARNING: the RNG of a JAX package train state does not carry over; it "
                  "stays seeded from --seed.")
        load_train_state_dict(state, sd)
        print(f"restored full train state from {p}")
    if getattr(opt, "restore_O_path", None):
        print("WARNING: --restore_O_path is subsumed by --restore_state_path "
              "(full-state checkpoints carry optimizer moments); ignored.")
    return state


def init_parallel(opt, device=None) -> Tuple[bool, Optional[Tuple[int, int]], torch.device]:
    """Join the process group the flags ask for (--multihost, or
    --num_processes above 1, with --coordinator_address and --process_id or
    a launcher's environment), or take the one a caller brought up; one
    process otherwise.  Idempotent: the mains call it before the options
    are written, the setups again.  Returns ``(primary, process_shard,
    device)``: ``process_shard = (rank, world)`` for the loader and the
    evaluators, None for a world of one; ``device`` is ``cuda:<local
    rank>`` in a group unless the caller named one."""
    nproc = opt.num_processes
    if opt.multihost or nproc > 1:
        multihost.initialize(opt.coordinator_address, nproc if nproc > 0 else None,
                             opt.process_id if opt.process_id >= 0 else None, device=device)
    collectives.set_layout(opt.n_spatial)
    rank, world = multihost.process_shard()
    if device is None and collectives.active():
        device = torch.device("cuda", multihost.local_rank(rank))
    return rank == 0, (rank, world) if world > 1 else None, resolve_device(device)


def _replicate(state, *nets) -> None:
    """Every rank's replica from rank 0's tensors: the networks' parameters
    and buffers, the adaptors and the EMA weights (built alike from one
    seed and the same files, they should already agree)."""
    tensors = collectives.module_tensors(*nets)
    seen = {id(t) for t in tensors}
    extra = [*state.adaptors.values(),
             *(t for tree in state.extra.values() for t in tree.values())]
    collectives.broadcast_(tensors + [t for t in extra if id(t) not in seen])


def _verb_rank(device, main, argv: List[str]) -> None:
    """A spawned rank of --n_devices: the verb ``main`` on ``device`` in
    the group the spawn brought up."""
    main(argv, device)


def _spawned(opt, main, argv: Optional[List[str]], device) -> bool:
    """--n_devices k (0: every card, divided by --n_spatial S) and S, with
    k·S above 1 and no group yet: run the verb on k·S spawned ranks of this
    host and return True once they all have (a failing rank raises); False
    leaves the verb to this process."""
    if opt.n_spatial > 1 and (opt.multihost or opt.num_processes > 1):
        # the JAX package's refusal (cat_tpu/entry.py:103-109)
        raise SystemExit("--n_spatial > 1 is not supported together with --multihost")
    if (opt.n_devices == 1 and opt.n_spatial == 1) or collectives.active():
        return False
    if opt.multihost or opt.num_processes > 1:
        raise ValueError("--n_devices spawns the ranks of one host; with --multihost or "
                         "--num_processes start one process per card instead")
    n = mesh.n_ranks(opt.n_devices, device, opt.n_spatial)
    if n == 1:
        return False
    mesh.spawn(_verb_rank, n, args=(main, sys.argv[1:] if argv is None else list(argv)),
               device=device)
    return True


def make_miou_evaluator(opt, generate, eval_loader, device, input_key: Optional[str] = "A",
                        process_shard=None):
    """The mIoU evaluator of generated Cityscapes photos, where the JAX
    package makes one (a dataroot naming cityscapes, direction BtoA;
    reference distillers/inception_distiller.py:262-279), or None; warns, as
    it does, when the DRN weights or the table file are absent."""
    if "cityscapes" not in opt.dataroot or opt.direction != "BtoA":
        return None
    return _miou_judge(opt, generate, eval_loader, device, input_key, process_shard)


def _miou_judge(opt, generate, eval_loader, device, input_key, process_shard=None):
    if not (opt.drn_path and os.path.exists(opt.drn_path)):
        print(f"WARNING: DRN weights not found at {opt.drn_path!r}; mIoU disabled.")
        return None
    if not os.path.exists(opt.table_path):
        print(f"WARNING: table file not found at {opt.table_path!r}; mIoU disabled.")
        return None
    from cat_tpu_torch.metrics.drn import load_drnseg
    from cat_tpu_torch.train.evaluation import MIoUEvaluator

    return MIoUEvaluator(generate, eval_loader, load_drnseg(opt.drn_path, device=device),
                         opt.table_path, data_dir=opt.cityscapes_path,
                         batch_size=opt.eval_batch_size, input_key=input_key, device=device,
                         process_shard=process_shard)


def _real_stats(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    if path and os.path.exists(path):
        npz = np.load(path)
        return {"mu": npz["mu"], "sigma": npz["sigma"]}
    if path:
        print(f"WARNING: real stats not found at {path!r}; FID disabled.")
    return None


def _train_shards(process_shard):
    """(the loader's data shard, its height shard) of this rank: its index
    on the data axis of the world's ``(data, spatial)`` grid, and on the
    spatial axis; None for an axis of one rank."""
    if process_shard is None:
        return None, None
    _, d, n_data = collectives.axis("data")
    _, s, n_spatial = collectives.axis("spatial")
    return ((d, n_data) if n_data > 1 else None), ((s, n_spatial) if n_spatial > 1 else None)


def _make_train_loader(opt, spec, device: torch.device, process_shard=None):
    """Host DataLoader (this rank's slices and rows under ``process_shard``),
    or the device-resident bank with --on_device_data (unaligned
    resize_and_crop without --serial_batches, on one process or on the
    spawned ranks of one host, each keeping its slice and rows; otherwise
    the host loader, as in the JAX package)."""
    if opt.dataset_mode == "cityscapes":
        # the JAX package's generic loader has no cityscapes mode: only the
        # SPADE family's own loaders (--model spade, --distiller spade) read it
        raise NotImplementedError(f"dataset mode [{opt.dataset_mode}] not implemented")
    data_shard, height_shard = _train_shards(process_shard)
    if opt.on_device_data:
        if (opt.dataset_mode == "unaligned" and spec.preprocess == "resize_and_crop"
                and not spec.grayscale and not opt.serial_batches
                and not (opt.multihost or opt.num_processes > 1)):
            from cat_tpu_torch.data.device_data import DeviceData, DeviceDataLoader

            dd, n = DeviceData.from_unaligned(opt.dataroot, opt.phase, spec.load_size,
                                              spec.crop_size, no_flip=spec.no_flip,
                                              max_size=opt.max_dataset_size, device=device)
            return DeviceDataLoader(dd, opt.batch_size, max(n // opt.batch_size, 1),
                                    seed=opt.seed, process_shard=data_shard,
                                    height_shard=height_shard)
        print("WARNING: --on_device_data supports unaligned resize_and_crop without "
              "--serial_batches, on the ranks of one host; using the host loader instead.")
    from cat_tpu_torch.data.datasets import create_dataloader

    return create_dataloader(
        opt.dataset_mode, opt.dataroot, opt.batch_size, spec, phase=opt.phase,
        direction=opt.direction, serial_batches=opt.serial_batches,
        max_size=opt.max_dataset_size, seed=opt.seed, load_in_memory=opt.load_in_memory,
        num_workers=opt.num_threads, worker_mode=opt.data_backend, process_shard=data_shard,
        height_shard=height_shard,
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
    JAX package ``.msgpack`` through ``convert(tree)`` (the file's whole
    tree: ``params`` and the running statistics)."""
    tree = ckpt.load_pytree(path)
    sd = convert(tree) if path.endswith(".msgpack") else tree
    print(f"restored {what} from {path}")
    return sd


def _write_student_config(opt, student_cfg, primary: bool) -> None:
    """student_config.json, by the primary, once every rank holds the same
    student architecture."""
    text = config_to_json(student_cfg)
    collectives.check_same(text, "the student config")
    if primary:
        with open(os.path.join(opt.log_dir, "student_config.json"), "w") as f:
            f.write(text)


def _trainer(opt, step_fn, loader, evaluate_fn, save_fn, logger, device, save_dir,
             primary: bool) -> Trainer:
    """The verb's trainer; only the primary saves and copies checkpoints."""
    return Trainer(step_fn, loader, cli.trainer_config(opt), evaluate_fn,
                   save_fn if primary else None, logger, device=device,
                   copy_tag_fn=(lambda s, d: ckpt.copy_tag(save_dir, s, d)) if primary else None)


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
    if opt.distiller == "spade":
        return setup_distill_spade(opt, device, loader)
    return setup_distill_inception(opt, device, loader)


def setup_distill_inception(opt, device=None, loader=None) -> DistillRun:
    """``loader``: the training batches; None builds them from the flags
    (any iterable of dicts of NCHW tensors with ``len`` steps per epoch
    will do, e.g. a ``data/device_data.py::DeviceDataLoader``)."""
    from cat_tpu_torch.compress.transfer import transfer_generator_state_dict
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller

    from cat_tpu_torch.data.datasets import create_eval_dataloader
    from cat_tpu_torch.train.evaluation import FIDEvaluator, combine_evaluators

    primary, pshard, device = init_parallel(opt, device)
    cli.set_seed(opt.seed)
    spec = cli.transform_spec(opt)
    if loader is None:
        loader = _make_train_loader(opt, spec, device, pshard)
    logger = Logger(opt.log_dir, opt.tensorboard_dir, mute=not primary)
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
                            lambda t: jax_import.discriminator_net_state_dict(t, disc_cfg), "D")
    state, teacher_params = dist.init_state(teacher_sd, student_sd, disc_sd, seed=opt.seed)
    if opt.restore_A_path:
        a_sd = _load_net(opt.restore_A_path, lambda t: jax_import.adaptor_state_dict(t["params"]),
                         "adaptors")
        if not state.adaptors:
            print("WARNING: --restore_A_path: adaptors are used only by "
                  "--distill_G_loss_type mse; ignored.")
        else:
            with torch.no_grad():
                for k, v in state.adaptors.items():
                    v.copy_(a_sd[k])
    state = _maybe_restore_state(opt, state, lambda t: jax_import.distill_state_dict(
        t, dist.student_cfg, dist.disc_cfg, adaptors=bool(state.adaptors)))
    _write_student_config(opt, student_cfg, primary)
    _replicate(state, dist.netG_teacher, dist.netG_student, dist.netD, dist.netA)
    if opt.prune_only:
        logger.print_info("prune_only: student architecture emitted; exiting.")
        return DistillRun(None, state, dist, teacher_params, student_cfg, loader, logger)

    # FID (and mIoU of Cityscapes photos) of the student's eval weights over
    # the val set, at the trainer's cadence; the evaluators read the newest
    # state from the box
    judge = cli.make_fid_judge(opt, device)
    stats = _real_stats(opt.real_stat_path)
    state_box = [state]
    eval_loader = create_eval_dataloader(opt.dataset_mode, opt.dataroot, opt.eval_batch_size,
                                         spec, opt.direction)
    evs = []
    if judge is not None and stats is not None:
        evs.append(FIDEvaluator(
            lambda x: dist.generate_student(state_box[0], x), eval_loader, judge, stats,
            opt.log_dir if primary else None, opt.eval_batch_size,
            teacher_generate=lambda x: dist.generate_teacher(teacher_params, x),
            device=device, process_shard=pshard))
    miou = make_miou_evaluator(opt, lambda x: dist.generate_student(state_box[0], x),
                               eval_loader, device, process_shard=pshard)
    if miou is not None:
        evs.append(miou)
    evaluate_fn = combine_evaluators(**{"": evs}) if evs else None

    def save_fn(state, tag):
        ckpt.save_net(save_dir, tag, "D", {**state.d.params, **state.d.stats}, disc_cfg)
        if state.adaptors:
            ckpt.save_net(save_dir, tag, "A", state.adaptors)
        _save_student(opt, save_dir, tag, state, student_cfg)

    def step_fn(state, batch, lr):
        state, metrics = dist.train_step(state, teacher_params, batch, lr)
        state_box[0] = state
        return state, metrics

    trainer = _trainer(opt, step_fn, loader, evaluate_fn, save_fn, logger, device, save_dir,
                       primary)
    return DistillRun(trainer, state, dist, teacher_params, student_cfg, loader, logger)


def _save_student(opt, save_dir: str, tag, state, student_cfg) -> None:
    """A distilled student's checkpoint: net_G holds what evaluation and
    deployment use, the EMA weights with --moving_average_decay (the raw
    weights then go to net_G_raw), else the trained weights; state.pth with
    --save_full_state."""
    eval_params = student_eval_params(state)
    ckpt.save_net(save_dir, tag, "G", {**eval_params, **state.g.stats}, student_cfg)
    if eval_params is not state.g.params:
        ckpt.save_net(save_dir, tag, "G_raw", {**state.g.params, **state.g.stats}, student_cfg)
    else:
        ckpt.remove_stale(save_dir, tag, "net_G_raw.pth")
        ckpt.remove_stale(save_dir, tag, "net_G_raw.json")
    if opt.save_full_state:
        ckpt.save_train_state(save_dir, tag, train_state_dict(state))
    else:
        ckpt.remove_stale(save_dir, tag, "state.pth")


def load_spade_checkpoint(path: str, opt=None) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(config, state_dict) of a SPADE generator checkpoint: this package's
    ``.pth`` with its ``.json``, the JAX package's ``.msgpack`` with its
    ``.json``, or a reference ``.pth``, whose architecture is recovered from
    its shapes with ``opt``'s upsampling, crop, aspect ratio and teacher
    norm (``utils/spade_import.py``)."""
    import cat_tpu_torch.core.spade_config  # noqa: F401  (registers the config types)

    cfg = ckpt.read_config(path)
    if path.endswith(".pth"):
        if cfg is not None:
            return cfg, ckpt.load_pytree(path)
        from cat_tpu_torch.utils.spade_import import load_torch_spade_generator

        kwargs = {}
        if opt is not None:
            kwargs = dict(num_upsampling_layers=opt.num_upsampling_layers,
                          crop_size=opt.crop_size, aspect_ratio=opt.aspect_ratio,
                          param_free_norm=cli.parse_param_free_norm(opt.teacher_norm_G),
                          spectral="spectral" in opt.teacher_norm_G)
        return load_torch_spade_generator(path, **kwargs)
    if cfg is None:
        raise FileNotFoundError(f"{path}: no .json config beside it")
    return cfg, jax_import.spade_net_state_dict(ckpt.load_pytree(path), cfg)


def _spade_bounds(opt) -> PruneBounds:
    return PruneBounds(cin_lb=max(opt.prune_cin_lb, 1),
                       cin_ub=opt.prune_cin_ub if opt.prune_cin_ub > 0 else None)


def setup_distill_spade(opt, device=None, loader=None) -> DistillRun:
    """GauGAN distillation (reference distillers/spade_distiller.py; the JAX
    package's ``setup_distill_spade``): the teacher, the shrink to
    --target_flops (the student initialised afresh), the magnitude transfer
    from --restore_pretrained_G_path into the shrunk student, D from
    --restore_D_path (weights and spectral ``u``, a fresh optimiser),
    ``student_config.json``, the Cityscapes loader, FID and mIoU at the
    trainer's cadence where their files exist, and the G (and, under EMA,
    G_raw) and state checkpoints.  ``loader`` as in
    ``setup_distill_inception``."""
    from cat_tpu_torch.compress.spade import profile_spade_generator, shrink_spade_generator
    from cat_tpu_torch.compress.transfer import transfer_spade_generator_params
    from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig
    from cat_tpu_torch.data.cityscapes import create_cityscapes_dataloader
    from cat_tpu_torch.distill.spade_distiller import (SPADEDistillHParams, SPADEDistiller,
                                                       remat_policy)

    if opt.remat:
        remat_policy(opt.remat_policy)  # an unsupported name fails before any checkpoint is read
    primary, pshard, device = init_parallel(opt, device)
    cli.set_seed(opt.seed)
    logger = Logger(opt.log_dir, opt.tensorboard_dir, mute=not primary)
    save_dir = os.path.join(opt.log_dir, "checkpoints")

    teacher_cfg, teacher_sd = load_spade_checkpoint(opt.restore_teacher_G_path, opt)
    h_lat = int(opt.crop_size / opt.aspect_ratio)
    t_prof = profile_spade_generator(teacher_cfg, h_lat, opt.crop_size)
    logger.print_info(f"netG teacher FLOPs: {t_prof.macs:,}; params: {t_prof.params:,}")
    if opt.target_flops > 0:
        t0 = time.time()
        res = shrink_spade_generator(teacher_cfg, teacher_sd, opt.target_flops, h_lat,
                                     opt.crop_size, _spade_bounds(opt))
        logger.print_info(
            f"scale threshold: {res.threshold:.6g}, searched flops: {res.searched_macs:,}, "
            f"target flops: {opt.target_flops:g} (pruning took {(time.time() - t0) * 1e3:.1f} ms)")
        student_cfg = res.config  # initialised afresh (the reference's semantics)
    else:
        student_cfg = cli.spade_generator_config(opt, opt.student_ngf, opt.student_norm_G)

    hp = SPADEDistillHParams(
        gan_mode=opt.gan_mode, distill_loss_type=opt.distill_G_loss_type,
        lambda_gan=opt.lambda_gan, lambda_distill=opt.lambda_distill,
        lambda_feat=opt.lambda_feat, lambda_vgg=opt.lambda_vgg, no_TTUR=opt.no_TTUR,
        beta1=opt.beta1 if opt.no_TTUR else 0.0, beta2=opt.beta2 if opt.no_TTUR else 0.9,
        compute_dtype=opt.compute_dtype, vgg_compute_dtype=opt.vgg_compute_dtype,
        init_type=opt.init_type, init_gain=opt.init_gain, remat=bool(opt.remat),
        remat_policy=opt.remat_policy or "", packed_blocks=_packed(opt, True),
        ema_decay=_ema_decay(opt), teacher_compute_dtype=opt.teacher_compute_dtype or "")
    # D follows the flags as on the teacher-training path, so that the
    # teacher's D (--restore_D_path) loads
    d_cfg = MultiscaleDiscriminatorConfig(input_nc=teacher_cfg.semantic_nc + teacher_cfg.output_nc,
                                          ndf=opt.ndf, n_layers=opt.n_layers_D, num_D=opt.num_D,
                                          norm_D=opt.norm_D)
    dist = SPADEDistiller(teacher_cfg, student_cfg, d_cfg, hp, vgg=cli.make_vgg(opt, device),
                          input_nc=opt.input_nc, contain_dontcare=opt.contain_dontcare_label,
                          device=device)
    # the magnitude transfer from the wide pretrained G, after the shrink,
    # so that it warm-starts the student that trains
    student_sd = None
    if opt.restore_pretrained_G_path:
        p_cfg, p_sd = load_spade_checkpoint(opt.restore_pretrained_G_path, opt)
        student_sd = transfer_spade_generator_params(p_sd, p_cfg, student_cfg)
        logger.print_info("Pretrained weights transferred into the SPADE student.")
    disc_sd = None
    if opt.restore_D_path:
        # the teacher's D: weights and spectral u, a fresh optimiser
        disc_sd = _load_net(opt.restore_D_path,
                            lambda t: jax_import.spade_net_state_dict(t, d_cfg), "D")
    state, teacher_params = dist.init_state(teacher_sd, student_sd, disc_sd, seed=opt.seed)
    state = _maybe_restore_state(opt, state, lambda t: jax_import.spade_distill_state_dict(
        t, student_cfg, d_cfg))
    _write_student_config(opt, student_cfg, primary)
    _replicate(state, dist.netG_teacher, dist.netG_student, dist.netD, dist.netA)
    if opt.prune_only:
        logger.print_info("prune_only: student architecture emitted; exiting.")
        return DistillRun(None, state, dist, teacher_params, student_cfg, loader, logger)

    if loader is None:
        data_shard, height_shard = _train_shards(pshard)
        loader = create_cityscapes_dataloader(
            opt.dataroot, opt.batch_size, phase=opt.phase, seed=opt.seed,
            load_size=opt.load_size, crop_size=opt.crop_size, aspect_ratio=opt.aspect_ratio,
            no_instance=opt.no_instance, pairing_check=not opt.no_pairing_check,
            max_size=opt.max_dataset_size, num_workers=opt.num_threads,
            worker_mode=opt.data_backend, process_shard=data_shard, height_shard=height_shard)
    state_box = [state]
    evaluate_fn = _spade_evaluators(
        opt, lambda b: dist.generate_student_raw(state_box[0], b), device,
        teacher_generate=lambda b: dist.generate_teacher_raw(teacher_params, b),
        primary=primary, process_shard=pshard)

    def save_fn(state, tag):
        _save_student(opt, save_dir, tag, state, student_cfg)

    def step_fn(state, batch, lr):
        state, metrics = dist.train_step(state, teacher_params, batch, lr)
        state_box[0] = state
        return state, metrics

    trainer = _trainer(opt, step_fn, loader, evaluate_fn, save_fn, logger, device, save_dir,
                       primary)
    return DistillRun(trainer, state, dist, teacher_params, student_cfg, loader, logger)


def distill_main(argv: Optional[List[str]] = None, device=None) -> Optional[DistillRun]:
    """``python -m cat_tpu_torch distill <flags>``: the JAX package's distill
    flags, with the SPADE distiller's defaults (``cli.SPADE_DISTILL_DEFAULTS``)
    under --distiller spade; runs on CUDA unless ``device`` says otherwise
    (the tests pass ``device="cpu"``).  Under --n_devices k the ranks run in
    spawned processes and this returns None."""
    parser = cli.distill_parser()
    opt = parser.parse_args(argv)
    cli.apply_distill_defaults(opt, parser)
    if _spawned(opt, distill_main, argv, device):
        return None
    primary, _, device = init_parallel(opt, device)
    cli.print_options(opt, parser, write=primary)
    run = setup_distill(opt, device)
    try:
        if run.trainer is not None:
            run.state = run.trainer.fit(run.state)
    finally:
        run.close()
    return run


# ---------------------------------------------------------------------------
# train verb (teacher training: pix2pix, CycleGAN and GauGAN)
# ---------------------------------------------------------------------------


@dataclass
class TrainRun:
    """What ``setup_train`` builds; ``train_main`` returns it with the
    state after training."""

    trainer: Trainer
    state: Any
    task: Any
    gen_cfg: Any
    disc_cfg: Any
    loader: Any
    logger: Logger

    close = DistillRun.close


def setup_train(opt, device=None, loader=None) -> TrainRun:
    """The train verb's task, state, evaluators and checkpoints (the JAX
    package's ``setup_train``; ``setup_train_spade`` for ``--model
    spade``).  ``loader`` as in ``setup_distill_inception``."""
    from cat_tpu_torch.data.datasets import create_eval_dataloader
    from cat_tpu_torch.train.evaluation import FIDEvaluator, combine_evaluators

    if opt.model == "spade":
        return setup_train_spade(opt, device, loader)
    primary, pshard, device = init_parallel(opt, device)
    cli.set_seed(opt.seed)
    spec = cli.transform_spec(opt)
    if loader is None:
        loader = _make_train_loader(opt, spec, device, pshard)
    logger = Logger(opt.log_dir, opt.tensorboard_dir, mute=not primary)
    save_dir = os.path.join(opt.log_dir, "checkpoints")
    gen_cfg = cli.generator_config(opt, opt.ngf)
    judge = cli.make_fid_judge(opt, device)
    state_box = []

    if opt.model == "pix2pix":
        from cat_tpu_torch.train.pix2pix import Pix2PixHParams, Pix2PixTask

        hp = Pix2PixHParams(
            gan_mode=opt.gan_mode, recon_loss_type=opt.recon_loss_type,
            lambda_gan=opt.lambda_gan, lambda_recon=opt.lambda_recon, beta1=opt.beta1,
            init_type=opt.init_type, init_gain=opt.init_gain, packed_blocks=_packed(opt, True),
            remat=bool(opt.remat))
        d_cfg = cli.discriminator_config(opt, opt.input_nc + opt.output_nc)
        task = Pix2PixTask(gen_cfg, d_cfg, hp, device)
        g_sd = None
        if opt.restore_G_path:
            g_sd = _load_net(opt.restore_G_path, lambda t: jax_import.generator_state_dict(
                t["params"], gen_cfg, t.get("batch_stats")), "G")
        state = task.init_state(opt.seed, g_sd)
        state = _maybe_restore_state(opt, state, lambda t: jax_import.train_state_dict(
            t, "pix2pix", gen_cfg, d_cfg))
        stats = _real_stats(opt.real_stat_path)
        eval_loader = create_eval_dataloader(opt.dataset_mode, opt.dataroot,
                                             opt.eval_batch_size, spec, opt.direction)
        evs = []
        if judge is not None and stats is not None:
            evs.append(FIDEvaluator(lambda x: task.generate(state_box[0], x), eval_loader,
                                    judge, stats, opt.log_dir if primary else None,
                                    opt.eval_batch_size, device=device, process_shard=pshard))
        miou = make_miou_evaluator(opt, lambda x: task.generate(state_box[0], x), eval_loader,
                                   device, process_shard=pshard)
        if miou is not None:
            evs.append(miou)
        evaluators = {"": evs} if evs else {}
        nets = {"G": (task.netG, gen_cfg), "D": (task.netD, d_cfg)}
    elif opt.model == "cycle_gan":
        from cat_tpu_torch.train.cyclegan import CycleGANHParams, CycleGANTask

        hp = CycleGANHParams(
            gan_mode=opt.gan_mode, lambda_A=opt.lambda_A, lambda_B=opt.lambda_B,
            lambda_identity=opt.lambda_identity, pool_size=opt.pool_size, beta1=opt.beta1,
            init_type=opt.init_type, init_gain=opt.init_gain, packed_blocks=_packed(opt, True),
            remat=bool(opt.remat))
        d_cfg = cli.discriminator_config(opt, opt.output_nc)
        task = CycleGANTask(gen_cfg, d_cfg, hp, device)
        if opt.restore_G_path:
            print("WARNING: --restore_G_path is read by pix2pix only, as in the JAX package; "
                  "ignored.")
        state = task.init_state(opt.crop_size, opt.crop_size, opt.seed)
        state = _maybe_restore_state(opt, state, lambda t: jax_import.train_state_dict(
            t, "cycle_gan", gen_cfg, d_cfg))
        # G_A's FID against B's statistics flags best_A, G_B's against A's best_B
        evaluators = {}
        for name, stat_path in (("A", opt.real_stat_B_path), ("B", opt.real_stat_A_path)):
            stats = _real_stats(stat_path)
            if judge is None or stats is None:
                continue
            direction = "AtoB" if name == "A" else "BtoA"
            eval_loader = create_eval_dataloader("unaligned", opt.dataroot,
                                                 opt.eval_batch_size, spec, direction)
            evaluators[name] = FIDEvaluator(
                lambda x, d=direction: task.generate(state_box[0], x, d), eval_loader, judge,
                stats, opt.log_dir if primary else None, opt.eval_batch_size, device=device,
                name=f"fid_{'B' if name == 'A' else 'A'}", process_shard=pshard)
        nets = {f"{kind}_{n}": (net[n], cfg) for kind, net, cfg in
                (("G", task.netG, gen_cfg), ("D", task.netD, d_cfg)) for n in "AB"}
    else:
        raise NotImplementedError(f"model [{opt.model}]")
    _replicate(state, task.netG, task.netD)
    state_box.append(state)

    def save_fn(state, tag):
        for name, (net, cfg) in nets.items():
            ckpt.save_net(save_dir, tag, name, net.state_dict(), cfg)
        if opt.save_full_state:
            ckpt.save_train_state(save_dir, tag, train_state_dict(state))
        else:
            ckpt.remove_stale(save_dir, tag, "state.pth")

    def step_fn(state, batch, lr):
        state, metrics = task.train_step(state, batch, lr)
        state_box[0] = state
        return state, metrics

    trainer = _trainer(opt, step_fn, loader,
                       combine_evaluators(**evaluators) if evaluators else None, save_fn, logger,
                       device, save_dir, primary)
    return TrainRun(trainer, state, task, gen_cfg, d_cfg, loader, logger)


def _spade_evaluators(opt, generate, device, teacher_generate=None, primary=True,
                      process_shard=None):
    """FID and mIoU over the Cityscapes val split for SPADE training and
    distillation (reference spade_model.evaluate_model:217-288,
    spade_distiller.py:96-172), each where its files exist; the combined
    evaluate function, or None.  ``teacher_generate``: the teacher's images
    are dumped beside the student's (by the primary)."""
    from cat_tpu_torch.data.cityscapes import create_cityscapes_dataloader
    from cat_tpu_torch.train.evaluation import FIDEvaluator, combine_evaluators

    judge = None if opt.no_fid else cli.make_fid_judge(opt, device)
    stats = _real_stats(opt.real_stat_path)
    want_miou = (opt.drn_path and os.path.exists(opt.drn_path)
                 and os.path.exists(opt.table_path))
    if not ((judge is not None and stats is not None) or want_miou):
        return None
    eval_loader = create_cityscapes_dataloader(
        opt.dataroot, opt.eval_batch_size, phase="val", shuffle=False, drop_last=False,
        load_size=opt.load_size, crop_size=opt.crop_size, aspect_ratio=opt.aspect_ratio,
        no_instance=opt.no_instance, pairing_check=not opt.no_pairing_check,
        num_workers=opt.num_threads)
    evs = []
    if judge is not None and stats is not None:
        evs.append(FIDEvaluator(generate, eval_loader, judge, stats,
                                opt.log_dir if primary else None, opt.eval_batch_size,
                                teacher_generate=teacher_generate, device=device,
                                input_key=None, process_shard=process_shard))
    if want_miou:
        evs.append(_miou_judge(opt, generate, eval_loader, device, None, process_shard))
    return combine_evaluators(**{"": evs})


def setup_train_spade(opt, device=None, loader=None) -> TrainRun:
    """GauGAN teacher training (reference models/spade_model.py; the JAX
    package's ``setup_train_spade``): the Cityscapes loader (shuffled unless
    --serial_batches), ``SPADETask`` with TTUR, FID and mIoU at the
    trainer's cadence where their files exist, and the G, D and state
    checkpoints."""
    from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig
    from cat_tpu_torch.data.cityscapes import create_cityscapes_dataloader
    from cat_tpu_torch.train.spade_model import SPADEHParams, SPADETask

    primary, pshard, device = init_parallel(opt, device)
    cli.set_seed(opt.seed)
    logger = Logger(opt.log_dir, opt.tensorboard_dir, mute=not primary)
    save_dir = os.path.join(opt.log_dir, "checkpoints")
    gen_cfg = cli.spade_generator_config(opt, opt.ngf, opt.norm_G)
    d_cfg = MultiscaleDiscriminatorConfig(input_nc=gen_cfg.semantic_nc + gen_cfg.output_nc,
                                          ndf=opt.ndf, n_layers=opt.n_layers_D, num_D=opt.num_D,
                                          norm_D=opt.norm_D)
    hp = SPADEHParams(
        gan_mode=opt.gan_mode, lambda_gan=opt.lambda_gan, lambda_feat=opt.lambda_feat,
        lambda_vgg=opt.lambda_vgg, no_TTUR=opt.no_TTUR,
        beta1=opt.beta1 if opt.no_TTUR else 0.0, beta2=opt.beta2 if opt.no_TTUR else 0.9,
        compute_dtype=opt.compute_dtype, vgg_compute_dtype=opt.vgg_compute_dtype,
        init_type=opt.init_type, init_gain=opt.init_gain, remat=bool(opt.remat),
        packed_blocks=_packed(opt, True))
    task = SPADETask(gen_cfg, d_cfg, hp, vgg=cli.make_vgg(opt, device), input_nc=opt.input_nc,
                     contain_dontcare=opt.contain_dontcare_label, device=device)
    g_sd = None
    if opt.restore_G_path:
        g_sd = _load_net(opt.restore_G_path,
                         lambda t: jax_import.spade_net_state_dict(t, gen_cfg), "G")
    state = task.init_state(opt.seed, g_sd)
    state = _maybe_restore_state(opt, state, lambda t: jax_import.train_state_dict(
        t, "spade", gen_cfg, d_cfg))
    _replicate(state, task.netG, task.netD)
    if loader is None:
        data_shard, height_shard = _train_shards(pshard)
        loader = create_cityscapes_dataloader(
            opt.dataroot, opt.batch_size, phase=opt.phase, shuffle=not opt.serial_batches,
            seed=opt.seed, load_size=opt.load_size, crop_size=opt.crop_size,
            aspect_ratio=opt.aspect_ratio, no_instance=opt.no_instance,
            pairing_check=not opt.no_pairing_check, max_size=opt.max_dataset_size,
            load_in_memory=opt.load_in_memory, num_workers=opt.num_threads,
            worker_mode=opt.data_backend, process_shard=data_shard, height_shard=height_shard)
    state_box = [state]
    evaluate_fn = _spade_evaluators(opt, lambda b: task.generate_raw(state_box[0], b), device,
                                    primary=primary, process_shard=pshard)

    def save_fn(state, tag):
        ckpt.save_net(save_dir, tag, "G", task.netG.state_dict(), gen_cfg)
        ckpt.save_net(save_dir, tag, "D", task.netD.state_dict(), d_cfg)
        if opt.save_full_state:
            ckpt.save_train_state(save_dir, tag, train_state_dict(state))
        else:
            ckpt.remove_stale(save_dir, tag, "state.pth")

    def step_fn(state, batch, lr):
        state, metrics = task.train_step(state, batch, lr)
        state_box[0] = state
        return state, metrics

    trainer = _trainer(opt, step_fn, loader, evaluate_fn, save_fn, logger, device, save_dir,
                       primary)
    return TrainRun(trainer, state, task, gen_cfg, d_cfg, loader, logger)


def train_main(argv: Optional[List[str]] = None, device=None) -> Optional[TrainRun]:
    """``python -m cat_tpu_torch train <flags>``: the JAX package's train
    flags, with its per-model defaults (``cli.TRAIN_MODEL_DEFAULTS``); runs
    on CUDA unless ``device`` says otherwise.  Under --n_devices k the ranks
    run in spawned processes and this returns None."""
    parser = cli.train_parser()
    opt = parser.parse_args(argv)
    cli.apply_train_defaults(opt, parser)
    if _spawned(opt, train_main, argv, device):
        return None
    primary, _, device = init_parallel(opt, device)
    cli.print_options(opt, parser, write=primary)
    run = setup_train(opt, device)
    try:
        run.state = run.trainer.fit(run.state)
    finally:
        run.close()
    return run


# ---------------------------------------------------------------------------
# profile verb (reference profiler.py:38-164)
# ---------------------------------------------------------------------------


def _generator_fn(cfg, state_dict, opt, device):
    """A frozen generator on ``device`` as a function of NCHW batches."""
    from cat_tpu_torch.models.generator import InceptionGenerator

    net = InceptionGenerator(cfg, packed_blocks=_packed(opt, True))
    net.load_state_dict(state_dict)
    net = net.requires_grad_(False).to(device).eval()

    @torch.no_grad()
    def generate(x):
        return net(x)

    return net, generate


def counted_flops(net, x: torch.Tensor) -> int:
    """FLOPs of ``net(x)`` as ``torch.utils.flop_counter`` counts them (2 per
    multiply-add of the convolutions): the port's cross-check of the
    analytic MACs, where the JAX package asks XLA's cost analysis."""
    import_stdlib_profile()  # the flop counter reaches TorchDynamo
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(x)
    return int(counter.get_total_flops())


def _profile_eval_sweep(opt, logger, device, gen_s, gen_t) -> Dict[str, float]:
    """The profile verb's final evaluation (reference profiler.py:154-164,
    ``evaluate(0, 0, save_image=True)``): sweep the val set, dump every
    input/Sfake/Tfake image to <results_dir>/eval/latest/ (the KID tool's
    input), and report FID (and mIoU of Cityscapes photos, BtoA)."""
    from cat_tpu_torch.data.datasets import create_eval_dataloader
    from cat_tpu_torch.train.evaluation import FIDEvaluator

    judge = cli.make_fid_judge(opt, device) if not opt.no_fid else None
    stats = _real_stats(opt.real_stat_path)
    eval_loader = create_eval_dataloader(opt.dataset_mode, opt.dataroot, opt.eval_batch_size,
                                         cli.transform_spec(opt), opt.direction,
                                         max_size=opt.num_test)
    results_dir = opt.results_dir or opt.log_dir
    ev = FIDEvaluator(gen_s, eval_loader, judge, stats, results_dir, opt.eval_batch_size,
                      dump_images=10 ** 9, teacher_generate=gen_t, device=device)
    metrics, _ = ev("latest")
    miou = None if opt.no_mIoU else make_miou_evaluator(opt, gen_s, eval_loader, device)
    if miou is not None:
        metrics.update(miou("latest")[0])
    dump_dir = os.path.join(results_dir, "eval", "latest")
    logger.print_info("evaluation: "
                      + (", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()) or "(no judges)")
                      + f"; images dumped to {dump_dir}")
    return metrics


def profile_distill(opt, device=None) -> Dict[str, Any]:
    """Shrink latency, MACs and parameters with a FLOP-counter cross-check,
    the student's forward latency at batch 1, and the full evaluation sweep
    (reference profiler.py:38-164); ``profile_distill_spade`` under
    --distiller spade."""
    if opt.distiller == "spade":
        return profile_distill_spade(opt, device)
    device = resolve_device(device)
    logger = Logger(opt.log_dir)
    try:
        teacher_norm = cli.norm_config(opt, opt.norm_affine)
        teacher_cfg, teacher_sd = cli.load_generator_checkpoint(opt.restore_teacher_G_path,
                                                                teacher_norm)
        bounds = PruneBounds(
            cin_lb=max(opt.prune_cin_lb, 1),
            cin_ub=opt.prune_cin_ub if opt.prune_cin_ub > 0 else None,
            ft_cin_lb=max(opt.prune_ft_cin_lb, 1),
        )

        # 5 warm-up and 10 timed shrinks (reference profiler.py:139-149)
        for _ in range(5):
            shrink_generator(teacher_cfg, teacher_sd, opt.target_flops, opt.crop_size,
                             opt.crop_size, bounds)
        times = []
        for _ in range(10):
            t0 = time.time()
            res = shrink_generator(teacher_cfg, teacher_sd, opt.target_flops, opt.crop_size,
                                   opt.crop_size, bounds)
            times.append(time.time() - t0)
        prune_mean = sum(times) / len(times)
        logger.print_info(f"mean pruning time over 10 runs: {prune_mean * 1e3:.3f} ms")

        # the student: a shipped checkpoint if given, else the shrink's result
        if opt.pretrained_student_G_path:
            student_cfg, student_sd = cli.load_generator_checkpoint(
                opt.pretrained_student_G_path, teacher_norm)
        else:
            student_cfg, student_sd = res.config, res.state_dict

        prof = profile_generator(student_cfg, opt.crop_size, opt.crop_size)
        logger.print_info(f"student MACs: {prof.macs:,}; params: {prof.params:,} "
                          f"(analytic, reference model_profiling formulas)")
        student, gen_s = _generator_fn(student_cfg, student_sd, opt, device)
        x = torch.zeros((1, student_cfg.input_nc, opt.crop_size, opt.crop_size), device=device)
        flops = counted_flops(student, x)
        logger.print_info(f"torch FLOP counter: {flops:,} flops (~{flops // 2:,} MACs) vs "
                          f"analytic {prof.macs:,} MACs")

        # forward latency (reference TestOptions --times, test_options.py:108-111)
        gen_s(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        reps = max(opt.times, 1)
        t0 = time.time()
        for _ in range(reps):
            gen_s(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        latency_ms = (time.time() - t0) / reps * 1e3
        logger.print_info(f"student forward latency: {latency_ms:.3f} ms/image "
                          f"(batch 1, {reps} reps)")

        _, gen_t = _generator_fn(teacher_cfg, teacher_sd, opt, device)
        metrics = _profile_eval_sweep(opt, logger, device, gen_s, gen_t)
    finally:
        logger.close()
    return {
        "latency_ms": latency_ms,
        "pruning_seconds_mean": prune_mean,
        "student_macs": prof.macs,
        "student_params": prof.params,
        "counted_flops": flops,
        "student_config": student_cfg,
        "student_state_dict": student_sd,
        "teacher_cfg": teacher_cfg,
        "metrics": metrics,
    }


def profile_distill_spade(opt, device=None) -> Dict[str, Any]:
    """The profile verb for the SPADE distiller (the JAX package's
    ``profile_distill_spade``; reference profiler.py, whose
    load_pretrained_spade_student is :83-89): 5 + 10 timed shrinks, the
    student's MACs and parameters, its forward latency at batch 1, and the
    evaluation sweep over the Cityscapes val split with the student's and the
    teacher's images dumped, FID and mIoU where their files exist."""
    from cat_tpu_torch.compress.spade import profile_spade_generator, shrink_spade_generator
    from cat_tpu_torch.data.cityscapes import create_cityscapes_dataloader
    from cat_tpu_torch.distill.spade_distiller import SPADEDistillHParams, SPADEDistiller
    from cat_tpu_torch.train.evaluation import FIDEvaluator

    device = resolve_device(device)
    logger = Logger(opt.log_dir)
    try:
        teacher_cfg, teacher_sd = load_spade_checkpoint(opt.restore_teacher_G_path, opt)
        h_lat = int(opt.crop_size / opt.aspect_ratio)
        t_prof = profile_spade_generator(teacher_cfg, h_lat, opt.crop_size)
        logger.print_info(f"netG teacher FLOPs: {t_prof.macs:,}; params: {t_prof.params:,}")

        prune_mean, res = float("nan"), None
        if opt.target_flops > 0:
            # 5 warm-up and 10 timed shrinks (reference profiler.py:139-149)
            args = (teacher_cfg, teacher_sd, opt.target_flops, h_lat, opt.crop_size,
                    _spade_bounds(opt))
            for _ in range(5):
                shrink_spade_generator(*args)
            times = []
            for _ in range(10):
                t0 = time.time()
                res = shrink_spade_generator(*args)
                times.append(time.time() - t0)
            prune_mean = sum(times) / len(times)
            logger.print_info(f"mean pruning time over 10 runs: {prune_mean * 1e3:.3f} ms")

        if opt.pretrained_student_G_path:
            student_cfg, student_sd = load_spade_checkpoint(opt.pretrained_student_G_path, opt)
        elif res is not None:
            student_cfg, student_sd = res.config, None
        else:
            raise SystemExit("profile (spade): need --pretrained_student_G_path or "
                             "--target_flops")
        s_prof = profile_spade_generator(student_cfg, h_lat, opt.crop_size)
        logger.print_info(f"netG student FLOPs: {s_prof.macs:,}; params: {s_prof.params:,}")

        # no VGG: evaluation only
        hp = SPADEDistillHParams(gan_mode=opt.gan_mode,
                                 distill_loss_type=opt.distill_G_loss_type, lambda_vgg=0.0,
                                 packed_blocks=_packed(opt, True))
        dist = SPADEDistiller(teacher_cfg, student_cfg, hp=hp, input_nc=opt.input_nc,
                              contain_dontcare=opt.contain_dontcare_label, device=device)
        state, teacher_params = dist.init_state(teacher_sd, student_sd, seed=opt.seed)

        # forward latency on a blank semantic map
        sem = torch.zeros((1, student_cfg.semantic_nc, h_lat, opt.crop_size), device=device)
        dist.generate_student(state, sem)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        reps = max(opt.times, 1)
        t0 = time.time()
        for _ in range(reps):
            dist.generate_student(state, sem)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        latency_ms = (time.time() - t0) / reps * 1e3
        logger.print_info(f"student forward latency: {latency_ms:.3f} ms/image "
                          f"(batch 1, {reps} reps)")

        # the evaluation sweep, every image dumped (reference profiler.py:154-164)
        judge = cli.make_fid_judge(opt, device) if not opt.no_fid else None
        stats = _real_stats(opt.real_stat_path)
        eval_loader = create_cityscapes_dataloader(
            opt.dataroot, opt.eval_batch_size, phase="val", shuffle=False, drop_last=False,
            load_size=opt.load_size, crop_size=opt.crop_size, aspect_ratio=opt.aspect_ratio,
            no_instance=opt.no_instance, pairing_check=not opt.no_pairing_check,
            max_size=opt.num_test, num_workers=opt.num_threads)
        results_dir = opt.results_dir or opt.log_dir
        gen_s = lambda b: dist.generate_student_raw(state, b)  # noqa: E731
        ev = FIDEvaluator(gen_s, eval_loader, judge, stats, results_dir, opt.eval_batch_size,
                          dump_images=10 ** 9,
                          teacher_generate=lambda b: dist.generate_teacher_raw(teacher_params, b),
                          device=device, input_key=None)
        metrics, _ = ev("latest")
        if not opt.no_mIoU and opt.drn_path and os.path.exists(opt.drn_path) \
                and os.path.exists(opt.table_path):
            metrics.update(_miou_judge(opt, gen_s, eval_loader, device, None)("latest")[0])
        dump_dir = os.path.join(results_dir, "eval", "latest")
        logger.print_info("evaluation: "
                          + (", ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
                             or "(no judges)") + f"; images dumped to {dump_dir}")
    finally:
        logger.close()
    return {
        "latency_ms": latency_ms,
        "pruning_seconds_mean": prune_mean,
        "student_macs": s_prof.macs,
        "student_params": s_prof.params,
        "student_config": student_cfg,
        "teacher_cfg": teacher_cfg,
        "metrics": metrics,
    }


def profile_main(argv: Optional[List[str]] = None, device=None) -> Dict[str, Any]:
    """``python -m cat_tpu_torch profile <flags>``: the JAX package's
    profile flags (distill's and the evaluation verb's)."""
    parser = cli.profile_parser()
    opt = parser.parse_args(argv)
    device = resolve_device(device)
    cli.print_options(opt, parser)
    return profile_distill(opt, device)


# ---------------------------------------------------------------------------
# export verb (the JAX package's export_main)
# ---------------------------------------------------------------------------


def export_main(argv: Optional[List[str]] = None, device=None) -> str:
    """``python -m cat_tpu_torch export <flags>``: write the student's
    forward as a ``torch.export`` program with a symbolic batch
    (``export.py``); returns its path.  The student is
    --pretrained_student_G_path (this package's ``.pth`` or the JAX
    package's ``.msgpack``, each with its ``.json``), else the shrink of
    --restore_teacher_G_path to --target_flops: an inception student keeps
    the teacher's weights, a SPADE student (--distiller spade) is
    initialised afresh from --seed with a ``torch.Generator``, which cannot
    replay the JAX package's ``jax.random`` draws.  --export_format
    stablehlo (the recipes' value) writes the ``.pt2``, at --export_path or
    <log_dir>/student.pt2, since torch has no StableHLO writer; tflite
    raises.  Exports on CUDA, with CUDA weights, unless ``device`` says
    otherwise."""
    from cat_tpu_torch.export import export_program

    parser = cli.export_parser()
    opt = parser.parse_args(argv)
    if opt.export_format == "tflite":
        raise NotImplementedError("--export_format tflite: no TFLite converter is installed for "
                                  "torch; --export_format stablehlo writes a torch.export "
                                  "program (.pt2)")
    device = resolve_device(device)
    cli.print_options(opt, parser)
    bounds = PruneBounds(cin_lb=max(opt.prune_cin_lb, 1))
    if opt.distiller == "spade":
        if opt.pretrained_student_G_path:
            student_cfg, student_sd = load_spade_checkpoint(opt.pretrained_student_G_path, opt)
        else:
            from cat_tpu_torch.compress.spade import shrink_spade_generator
            from cat_tpu_torch.models.spade import SPADEGenerator

            teacher_cfg, teacher_sd = load_spade_checkpoint(opt.restore_teacher_G_path, opt)
            student_cfg = shrink_spade_generator(
                teacher_cfg, teacher_sd, opt.target_flops, int(opt.crop_size / opt.aspect_ratio),
                opt.crop_size, bounds).config
            student_sd = SPADEGenerator(
                student_cfg, generator=torch.Generator().manual_seed(opt.seed)).state_dict()
    else:
        teacher_norm = cli.norm_config(opt, opt.norm_affine)
        if opt.pretrained_student_G_path:
            student_cfg, student_sd = cli.load_generator_checkpoint(
                opt.pretrained_student_G_path, teacher_norm)
        else:
            teacher_cfg, teacher_sd = cli.load_generator_checkpoint(opt.restore_teacher_G_path,
                                                                    teacher_norm)
            res = shrink_generator(teacher_cfg, teacher_sd, opt.target_flops, opt.crop_size,
                                   opt.crop_size, bounds)
            student_cfg, student_sd = res.config, res.state_dict
    path = opt.export_path or os.path.join(opt.log_dir, "student.pt2")
    print("--export_format stablehlo: torch has no StableHLO writer; writing a torch.export "
          "program (.pt2) with a symbolic batch")
    out = export_program(student_cfg, student_sd, opt.crop_size, opt.crop_size, path,
                         device=device)
    print(f"exported student to {out}")
    return out


# ---------------------------------------------------------------------------
# get_real_stat and KID
# ---------------------------------------------------------------------------


def real_stat_main(argv: Optional[List[str]] = None, device=None) -> Dict[str, np.ndarray]:
    """``python -m cat_tpu_torch get_real_stat <flags>``: cache the judge's
    {mu, sigma} of a real-image set (reference get_real_stat.py:24-48)."""
    from cat_tpu_torch.data.datasets import create_dataloader
    from cat_tpu_torch.metrics.fid import compute_real_stats

    opt = cli.real_stat_parser().parse_args(argv)
    device = resolve_device(device)
    judge = cli.make_fid_judge(opt, device)
    if judge is None:
        raise SystemExit("inception weights are required for real stats")
    loader = create_dataloader("single", opt.dataroot, opt.batch_size_stat,
                               cli.transform_spec(opt), phase=opt.phase, serial_batches=True,
                               drop_last=False)
    images = torch.cat([b["A"] for b in loader]).numpy()
    stats = compute_real_stats(images, judge, opt.batch_size_stat)
    os.makedirs(os.path.dirname(opt.output_path) or ".", exist_ok=True)
    np.savez(opt.output_path, mu=stats["mu"], sigma=stats["sigma"])
    print(f"saved real statistics ({images.shape[0]} images) to {opt.output_path}")
    return stats


def _load_dir(path: str, size=None) -> np.ndarray:
    """Every image of a folder as uint8 NCHW, bicubic-resized to ``size``
    (w, h) when given."""
    from PIL import Image

    from cat_tpu_torch.data.datasets import make_dataset

    ims = []
    for p in make_dataset(path):
        with Image.open(p) as img:
            img = img.convert("RGB")
            if size:
                img = img.resize(size, Image.BICUBIC)
            ims.append(np.asarray(img, dtype=np.uint8).transpose(2, 0, 1))
    if not ims:
        raise SystemExit(f"no images found in {path!r}")
    return np.stack(ims)


def kid_score_main(argv: Optional[List[str]] = None, device=None):
    """``python -m cat_tpu_torch kid_score --real <dir> --fake <dir>``: KID
    between two folders, mean +/- std over random subsets (the JAX
    package's ``tools/kid_score.py``); the fakes are resized to the reals'
    size.  Returns (mean, std), or (mean, std, variance estimates) with
    --ret_var."""
    from cat_tpu_torch.metrics.fid import get_activations
    from cat_tpu_torch.metrics.inception import load_inception
    from cat_tpu_torch.metrics.kid import kid_score

    args = cli.kid_parser().parse_args(argv)
    device = resolve_device(device)
    model = load_inception(args.inception_path, device=device)
    real = _load_dir(args.real)
    fake = _load_dir(args.fake, size=(real.shape[3], real.shape[2]))
    act_r = get_activations(real, model, args.batch_size)
    act_f = get_activations(fake, model, args.batch_size)
    if args.ret_var:
        mean, std, var_ests = kid_score(act_f, act_r, args.n_subsets, args.subset_size,
                                        ret_var=True)
        print(f"KID: {mean:.6f} +/- {std:.6f} (U-stat var estimate: {var_ests.mean():.6g}, "
              f"+/-sqrt: {np.sqrt(max(var_ests.mean(), 0.0)):.6f})")
        return mean, std, var_ests
    mean, std = kid_score(act_f, act_r, args.n_subsets, args.subset_size)
    print(f"KID: {mean:.6f} +/- {std:.6f}")
    return mean, std
