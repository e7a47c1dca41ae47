"""The port's export (``cat_tpu_torch/export.py`` and the export verb) on the
CPU at toy size, for both families: the loaded ``.pt2`` at batch 2 and 3
against the port's eval-mode generator and against the JAX package's
StableHLO artifact on the same weights (carried with the checkpoint
converters, NCHW <-> NHWC), and the verb with the flags of each shipped
``scripts/*/*/export_inception_student_*.sh`` recipe over seeded
checkpoints."""

import glob
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.core import config as jcfg
from cat_tpu.core import spade_config as jsc
from cat_tpu.export import export_stablehlo, load_stablehlo
from cat_tpu.models.generator import InceptionGenerator as JGen
from cat_tpu.models.spade import SPADEGenerator as JSPADE
from cat_tpu.utils import checkpoint as jckpt
from cat_tpu_torch import entry
from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
from cat_tpu_torch.compress.spade import shrink_spade_generator
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.core.spade_config import SPADEGeneratorConfig
from cat_tpu_torch.export import _forward_fn, export_program, load_program
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.models.spade import SPADEGenerator
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32  # the inception toys' crop
H, W = 32, 64  # the SPADE toys' map: crop 64 at aspect 2


def to_port(cfg):
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def _spread(variables, seed):
    """Norm scales and running statistics moved away from their start."""
    rs = np.random.RandomState(seed)

    def f(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.asarray(rs.uniform(0.5, 1.5, x.shape), jnp.float32)
        return jnp.asarray(rs.randn(*x.shape) * 0.1, jnp.float32) if name == "mean" else x

    return jax.tree_util.tree_map_with_path(f, variables)


def _jax_world(family):
    """(JAX config, JAX variables, port config, port state_dict, per-sample
    NHWC input shape) of a toy generator: an inception generator (3 blocks,
    kernels 1, 3, 5, affine instance norm) or a SPADE generator (spectral
    blocks, kernels 1 and 3, 3 labels + dontcare + edges)."""
    if family == "inception":
        cfg = jcfg.InceptionGeneratorConfig.make(
            ngf=8, channels_reduction_factor=2, kernel_sizes=(1, 3, 5), n_blocks=3,
            norm=jcfg.NormConfig(kind="instance", affine=True, track_running_stats=False))
        v = _spread(fast_init(JGen(cfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=1), 1)
        return cfg, v, to_port(cfg), jax_import.generator_state_dict(v["params"], cfg), \
            (SIZE, SIZE, 3)
    cfg = jsc.SPADEGeneratorConfig.make(semantic_nc=5, ngf=4, channels_reduction_factor=4,
                                        kernel_sizes=(1, 3), num_upsampling_layers="normal",
                                        crop_size=W, aspect_ratio=2.0, spectral=True)
    v = _spread(fast_init(JSPADE(cfg), jnp.zeros((1, H, W, 5)), seed=2), 2)
    return cfg, v, to_port(cfg), jax_import.spade_generator_state_dict(
        v["params"], to_port(cfg), v), (H, W, 5)


@pytest.mark.parametrize("family", ["inception", "spade"])
def test_exported_program_matches_eager_and_the_jax_artifact(rng, tmp_path, family):
    """The ``.pt2`` at batch 2 and 3 gives the port's eval-mode generator's
    output (rtol 1e-5; the program's blocks are packed, spectral kernels
    folded) and the JAX package's StableHLO artifact's on the same weights
    (rtol 1e-4, atol 1e-5 of the output's largest value); its input shape is
    ``_forward_fn``'s."""
    jc, jv, pc, sd, shape = _jax_world(family)
    module, want_shape = _forward_fn(pc, sd)
    assert not module.training
    assert want_shape == ((3, None, None) if family == "inception" else (5, H, W))
    path = export_program(pc, sd, shape[0], shape[1], str(tmp_path / "student.pt2"), device="cpu")
    program = load_program(path)
    jpath = export_stablehlo(jc, jv, shape[0], shape[1], str(tmp_path / "student.stablehlo"))
    exported = load_stablehlo(jpath)
    net = (InceptionGenerator(pc) if family == "inception" else SPADEGenerator(pc)).eval()
    net.load_state_dict(sd)
    for b in (2, 3):
        x = rng.rand(b, *shape).astype(np.float32)
        if family == "spade":
            x = (x > 0.6).astype(np.float32)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        with torch.no_grad():
            got, eager = program(xt).numpy(), net(xt).numpy()
        want = np.asarray(exported.call(jnp.asarray(x))).transpose(0, 3, 1, 2)
        assert got.shape == want.shape == (b, 3, shape[0], shape[1])
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=f"batch {b}, eager")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"batch {b}, JAX")


# ---------------------------------------------------------------------------
# The verb, with the shipped recipes' flags
# ---------------------------------------------------------------------------


RECIPES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "scripts", "*", "*", "export_inception_student_*.sh")))


def recipe_flags(script):
    """The flags a shipped export script passes to ``export.py``."""
    with open(os.path.join(REPO, script)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.startswith("python export.py"))
    return shlex.split(line)[2:]


def _set(flags, name, value):
    flags = list(flags)
    if name in flags:
        flags[flags.index(name) + 1] = value
    else:
        flags += [name, value]
    return flags


def _seeded_student(flags, root):
    """A seeded student checkpoint (``.pth`` + ``.json``) whose config
    follows the recipe's flags, and that config."""
    if "spade" in flags:
        cfg = SPADEGeneratorConfig.make(semantic_nc=37, ngf=2, channels_reduction_factor=8,
                                        kernel_sizes=(1, 3), num_upsampling_layers="more",
                                        crop_size=512, aspect_ratio=2.0)
        net = SPADEGenerator(cfg, "normal", 0.2, generator=torch.Generator().manual_seed(5))
    else:
        kind = flags[flags.index("--norm") + 1] if "--norm" in flags else "instance"
        norm = tcfg.NormConfig(kind=kind, affine="--norm_affine" in flags,
                               track_running_stats="--norm_track_running_stats" in flags)
        cfg = tcfg.InceptionGeneratorConfig.make(ngf=4, channels_reduction_factor=2,
                                                 kernel_sizes=(1, 3), n_blocks=2, norm=norm)
        net = InceptionGenerator(cfg, "normal", 0.2, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(6))
    return cfg, ckpt.save_net(str(root), "best", "G", net.state_dict(), cfg)


@pytest.mark.parametrize("script", RECIPES)
def test_export_verb_runs_each_shipped_recipe(tmp_path, capsys, script):
    """``export_main`` with the recipe's flags (``--export_format
    stablehlo`` as shipped), its paths pointing at a seeded student
    checkpoint: it says that it writes a ``.pt2``, writes it at
    <log_dir>/student.pt2, and the reloaded program takes the input shape
    ``_forward_fn`` gives (the recipe's crop; the SPADE map at crop /
    aspect) and matches the eval-mode student at batch 2 (rtol 1e-4, atol
    1e-5 of its largest value)."""
    assert len(RECIPES) == 6
    flags = recipe_flags(script)
    assert flags[flags.index("--export_format") + 1] == "stablehlo"
    cfg, path = _seeded_student(flags, tmp_path / "ckpt")
    for name, value in (("--dataroot", str(tmp_path / "data")),
                        ("--log_dir", str(tmp_path / "log")),
                        ("--restore_teacher_G_path", str(tmp_path / "absent.pth")),
                        ("--pretrained_student_G_path", path)):
        flags = _set(flags, name, value)
    out = entry.export_main(flags, device="cpu")
    said = capsys.readouterr().out
    assert out == str(tmp_path / "log" / "student.pt2") and os.path.exists(out)
    assert f"exported student to {out}" in said and "torch.export program (.pt2)" in said
    c, h, w = (37, 256, 512) if "spade" in flags else (3, 256, 256)
    x = torch.rand(2, c, h, w, generator=torch.Generator().manual_seed(7))
    if c == 37:
        x = (x > 0.9).float()
    sd, _ = ckpt.load_net(str(tmp_path / "ckpt"), "best", "G")
    net = (SPADEGenerator(cfg) if c == 37 else InceptionGenerator(cfg)).eval()
    net.load_state_dict(sd)
    with torch.no_grad():
        got, want = load_program(out)(x), net(x)
    assert got.shape == (2, 3, h, w)
    # the program's blocks are packed, the eager student's are not
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("family", ["inception", "spade"])
def test_export_verb_shrinks_the_teacher_and_reads_jax_checkpoints(tmp_path, family):
    """Without --pretrained_student_G_path the verb shrinks the teacher to
    --target_flops: the inception student keeps the teacher's sliced weights,
    the SPADE student is initialised afresh from --seed; the teacher is a
    JAX package ``.msgpack`` + ``.json``; --export_path is written as given.
    The program follows ``_forward_fn``'s input shape at batch 2 and 3."""
    jc, jv, pc, sd, shape = _jax_world(family)
    teacher = jckpt.save_net(str(tmp_path / "jax"), "best", "G", jv, jc)
    flags = ["--dataroot", str(tmp_path), "--log_dir", str(tmp_path / "log"),
             "--restore_teacher_G_path", teacher, "--seed", "11",
             "--export_path", str(tmp_path / "out" / "g.stablehlo")]
    if family == "inception":
        flags += ["--crop_size", str(SIZE), "--norm_affine", "--target_flops", "6e6"]
        res = shrink_generator(pc, sd, 6e6, SIZE, SIZE, PruneBounds(cin_lb=1))
        net = InceptionGenerator(res.config)
        net.load_state_dict(res.state_dict)
    else:
        flags += ["--distiller", "spade", "--crop_size", str(W), "--aspect_ratio", "2",
                  "--num_upsampling_layers", "normal", "--target_flops", "6e6"]
        res = shrink_spade_generator(pc, sd, 6e6, H, W, PruneBounds(cin_lb=1))
        net = SPADEGenerator(res.config, generator=torch.Generator().manual_seed(11))
    assert entry.export_main(flags, device="cpu") == str(tmp_path / "out" / "g.stablehlo")
    program = load_program(str(tmp_path / "out" / "g.stablehlo"))
    net.eval()
    for b in (2, 3):
        x = torch.rand(b, shape[2], shape[0], shape[1], generator=torch.Generator().manual_seed(b))
        with torch.no_grad():
            torch.testing.assert_close(program(x), net(x), rtol=1e-5, atol=1e-6)


def test_export_verb_refuses_tflite(tmp_path):
    """--export_format tflite raises (no converter is installed), before any
    checkpoint is read; the JAX package's verb would print "exported
    student to None"."""
    with pytest.raises(NotImplementedError, match="tflite"):
        entry.export_main(["--dataroot", str(tmp_path), "--log_dir", str(tmp_path / "log"),
                           "--restore_teacher_G_path", str(tmp_path / "absent.pth"),
                           "--export_format", "tflite"], device="cpu")
    assert not os.path.exists(tmp_path / "log")
