"""Spatial parallelism for the SPADE (GauGAN) family in the port
(``--n_spatial`` with ``train --model spade`` and ``distill --distiller
spade``) over gloo processes on the CPU, at tiny sizes (64 x 32, batch 2,
ngf 2-16, a 1-row latent, so that at S = 2 the second rank owns no rows of
it), inputs and weights made with numpy from a seed:

  * the primitives of ``parallel/spatial.py`` that the family adds, at S = 2
    and S = 3 in float64 against the unsplit op: forward, input gradient and
    second-order gradient (rtol 1e-5 of the reference's largest value) of
    the nearest resize (up, down, by non-integer factors, from a 1-row
    height that leaves ranks empty), VGG's 2x2 max pool (an odd ⌈h/S⌉),
    the multiscale D's 3x3/2 average pool without the padding in its
    divisor, the depthwise and the D's 4x4/2 halo convs; the conv over the
    whole-map semantics (no exchange) and D's input rows;
  * the SPADE teacher step and the SPADE distill step (KA on head_0,
    G_middle_1 and up_1, VGG, the spectral multiscale D) at S = 2 against
    the JAX package's single-device step, its weights carried over (losses
    at ``tests/test_sharding.py``'s rtol 2e-4 / atol 1e-5, parameters within
    Adam's 2.5·lr at each net's TTUR rate, statistics and ``u``); D's ``u``
    equal on both ranks; the head_0 Grams of the rank that owns no latent
    row have no columns;
  * the distiller with ``mse`` adaptors, under wgangp (the penalty's weights
    fixed) and under ``--remat 1`` at S = 2, and the KA distiller on a
    2 x 2 grid, against the port's one process;
  * the Cityscapes loader's per-rank batches: the photos' rows, the label
    and instance maps whole.

One spawn per world (2, 3 and 4 ranks, started together, ``TIMEOUT`` s
each) runs every case of that world while the test process computes the
port's one-process references; the JAX steps run in the tests.  Rank
workers import nothing of JAX.  About 60 s on one worker of this CPU.
"""

import os
import threading
import traceback

import numpy as np
import pytest
import torch

from cat_tpu_torch.parallel import mesh

torch.set_num_threads(1)

H, W = 32, 64  # tests/test_torch_spade.py's: crop 64 at aspect 2, a 1 x 2 latent
LR = 2e-4
RTOL, ATOL = 2e-4, 1e-5  # tests/test_sharding.py's spatial test
TIMEOUT = 240  # each world's spawn; three run at once beside the test process
ALPHA = np.array([0.3, 0.8], np.float32)  # the mixed penalty's weights, batch 2
WORLDS = {2: 2, 3: 3, 4: 2}  # ranks -> spatial ranks (4: a 2 x 2 grid)


def shard(x, rank, n_spatial, world):
    """Rank ``rank``'s part of a whole NCHW batch: its data index's rows
    and its spatial index's height rows."""
    from cat_tpu_torch.parallel.spatial import rows

    d, s = divmod(rank, n_spatial)
    b = x.shape[0] // (world // n_spatial)
    start, stop = rows(x.shape[2], s, n_spatial)
    return x[d * b:(d + 1) * b, :, start:stop]


def local_batch(batch, rank, n_spatial, world):
    """The rank's part of a raw SPADE batch: its data index's rows of every
    field, the photo's height rows only (the label maps stay whole)."""
    n_data = world // n_spatial
    d = rank // n_spatial
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // n_data
        out[k] = (shard(v, rank, n_spatial, world) if k == "image"
                  else v[d * b:(d + 1) * b])
    return out


# ---------------------------------------------------------------------------
# the cases, run by each rank
# ---------------------------------------------------------------------------


def _resize(out_h, out_w):
    from cat_tpu_torch.parallel import spatial

    return (lambda t, h: spatial.nearest_resize(t, out_h, out_w, h),
            lambda t: spatial.nearest_resize_plain(t, out_h, out_w))


def _layers():
    """name -> (input height, split op of (x, h), whole op of x)."""
    import torch.nn.functional as F

    from cat_tpu_torch.parallel import spatial

    g = torch.Generator().manual_seed(2)
    dw = torch.randn(3, 1, 5, 5, generator=g, dtype=torch.float64)
    d4 = torch.randn(4, 3, 4, 4, generator=g, dtype=torch.float64)
    return {
        "resize_up_2x": (7, *_resize(14, 12)),
        "resize_up_latent_1_row": (1, *_resize(2, 12)),
        "resize_up_by_3_halves": (6, *_resize(9, 9)),
        "resize_down_13_to_5": (13, *_resize(5, 3)),
        "resize_down_to_1_row": (9, *_resize(1, 6)),
        "max_pool_2x2_h6": (6, lambda t, h: spatial.max_pool2d(t, 2, 2, h),
                            lambda t: F.max_pool2d(t, 2, 2)),
        "max_pool_2x2_h9": (9, lambda t, h: spatial.max_pool2d(t, 2, 2, h),
                            lambda t: F.max_pool2d(t, 2, 2)),
        "avg_pool_excl_pad_h13": (13, lambda t, h: spatial.avg_pool2d(t, 3, 2, 1, h),
                                  lambda t: F.avg_pool2d(t, 3, 2, 1, count_include_pad=False)),
        "avg_pool_excl_pad_h2": (2, lambda t, h: spatial.avg_pool2d(t, 3, 2, 1, h),
                                 lambda t: F.avg_pool2d(t, 3, 2, 1, count_include_pad=False)),
        "depthwise_k5_groups": (11, lambda t, h: spatial.conv2d_fn(t, dw, None, 1, 2, 3, h),
                                lambda t: F.conv2d(t, dw, None, 1, 2, 1, 3)),
        "d_conv_k4_s2_p2": (13, lambda t, h: spatial.conv2d_fn(t, d4, None, 2, 2, 1, h),
                            lambda t: F.conv2d(t, d4, None, 2, 2)),
    }


def layers_case(inp, rank):
    """Each primitive on this rank's rows against the whole-height op (run
    here with the collectives off), float64: output, the input gradient of
    Σ y²·w and the gradient of Σ (that gradient)²; the worst absolute gap
    and the reference's largest value.  Also the conv over a tensor held
    whole (``whole=True``) and D's input rows (``d_input``)."""
    import torch.nn.functional as F

    from cat_tpu_torch.parallel import collectives, spatial
    from cat_tpu_torch.train.spade_model import d_input

    _, s, n = collectives.axis("spatial")
    out = {}
    for name, (h, split, whole) in _layers().items():
        x = torch.from_numpy(inp[name]["x"])
        xr = x.clone().requires_grad_(True)
        with collectives.local():
            yr = whole(xr)
            w = torch.from_numpy(inp[name]["w"][:, :yr.shape[1], :yr.shape[2], :yr.shape[3]])
            g1r, = torch.autograd.grad((yr.square() * w).sum(), xr, create_graph=True)
            g2r, = torch.autograd.grad(g1r.square().sum(), xr)
        xl = shard(x, s, n, n).clone().requires_grad_(True)
        yl = split(xl, h)
        g1, = torch.autograd.grad((yl.square() * shard(w, s, n, n)).sum(), xl, create_graph=True)
        g2, = torch.autograd.grad(g1.square().sum(), xl)
        out[name] = {}
        for what, got, want in (("y", yl, yr), ("dx", g1, g1r), ("ddx", g2, g2r)):
            want = shard(want, s, n, n).detach()
            assert got.shape == want.shape, (name, what, got.shape, want.shape)
            out[name][what] = (float((got.detach() - want).abs().max()) if want.numel() else 0.0,
                               float(want.abs().max()) if want.numel() else 0.0)
    sem, img = torch.from_numpy(inp["sem"]), torch.from_numpy(inp["img"])
    wk = torch.from_numpy(inp["w_sem"])
    with collectives.local():
        want = F.conv2d(sem, wk, None, 1, 1)
    got = spatial.conv2d_fn(sem, wk, None, 1, 1, whole=True)
    out["whole_conv"] = float((got - shard(want, s, n, n)).abs().max()) if got.numel() else 0.0
    out["d_input"] = bool(torch.equal(d_input(sem, shard(img, s, n, n)),
                                      shard(torch.cat([sem, img], 1), s, n, n)))
    return out


def _vgg(vgg_sd):
    from cat_tpu_torch.models import vgg as tvgg

    if vgg_sd is None:
        return None
    vgg = tvgg.VGG19Features()
    vgg.load_state_dict(vgg_sd)
    return vgg


def _cfg(text):
    from cat_tpu_torch.core import config as tcfg

    return tcfg.config_from_json(text)


def task_case(inp, rank, n_spatial=2, world=2):
    """One SPADE teacher step from carried weights on this rank's part of
    the batch."""
    from cat_tpu_torch.train import spade_model as tsm

    task = tsm.SPADETask(_cfg(inp["gen"]), _cfg(inp["disc"]), tsm.SPADEHParams(),
                         vgg=_vgg(inp["vgg"]), input_nc=3, contain_dontcare=True, device="cpu")
    state = task.init_state(0, inp["G"])
    task.netD.load_state_dict(inp["D"])
    state, m = task.train_step(state, local_batch(inp["batch"], rank, n_spatial, world), LR)
    return {"metrics": {k: float(v) for k, v in m.items()}, "G": task.netG.state_dict(),
            "D": task.netD.state_dict()}


def distill_case(inp, rank=0, n_spatial=1, world=1):
    """One SPADE distill step from the carried state (``inp["state"]``) or
    from seeds, on this process's part of the batch (the whole batch
    without a group); the Gram operands' shapes; the state after it."""
    from cat_tpu_torch.distill import ka as tka
    from cat_tpu_torch.distill import spade_distiller as tsd
    from cat_tpu_torch.models import losses as tlosses
    from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict

    dist = tsd.SPADEDistiller(_cfg(inp["teacher_cfg"]), _cfg(inp["student_cfg"]),
                              _cfg(inp["disc_cfg"]), tsd.SPADEDistillHParams(**inp["hp"]),
                              vgg=_vgg(inp["vgg"]), input_nc=3, contain_dontcare=True,
                              device="cpu")
    state, tparams = dist.init_state(inp["teacher"], seed=5)
    if inp.get("state") is not None:
        load_train_state_dict(state, inp["state"])
    shapes, gram, mixing = [], tka.gram, tlosses.mixing_weights
    tka.gram = lambda x: shapes.append(tuple(x.shape)) or gram(x)
    tlosses.mixing_weights = lambda n, generator, like: torch.from_numpy(ALPHA).reshape(
        n, 1, 1, 1).to(like)
    try:
        state, m = dist.train_step(state, tparams, local_batch(inp["batch"], rank, n_spatial,
                                                               world), LR)
    finally:
        tka.gram, tlosses.mixing_weights = gram, mixing
    return {"metrics": {k: float(v) for k, v in m.items()}, "state": train_state_dict(state),
            "gram_shapes": shapes}


PORT_CASES = ("mse", "wgangp", "remat")

CASES = {
    2: {"layers": layers_case, "task": task_case,
        "distill": lambda i, r: distill_case(i, r, 2, 2),
        **{c: (lambda i, r: distill_case(i, r, 2, 2)) for c in PORT_CASES}},
    3: {"layers": layers_case},
    4: {"grid": lambda i, r: distill_case(i, r, 2, 4)},
}


def _rank_main(device, root, world):
    """A rank of a world: the spatial layout, then every case of
    ``root/in.pt`` for that world, each one's result (or its traceback) to
    ``root/out<world>_<rank>.pt``."""
    import torch.distributed as dist

    from cat_tpu_torch.parallel import collectives

    torch.set_num_threads(1)
    collectives.set_layout(WORLDS[world])
    rank = dist.get_rank()
    inputs = torch.load(os.path.join(root, "in.pt"), weights_only=False)
    out = {}
    for name, fn in CASES[world].items():
        try:
            out[name] = fn(inputs[name], rank)
        except Exception:  # reported by the case's test
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(root, f"out{world}_{rank}.pt"))


# ---------------------------------------------------------------------------
# the inputs (the JAX package's weights, carried) and the spawns
# ---------------------------------------------------------------------------


def _raw_batch(rs, n=2):
    from tests.test_torch_spade import _labels

    label, inst = _labels(rs, n)
    image = rs.uniform(-1, 1, (n, 3, H, W)).astype(np.float32)
    return {"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
            "image": torch.from_numpy(image)}


def _port_distill_inputs(rs, hp, batch_size=2):
    """A seeded port-only distiller (teacher ngf 16 with spread running
    statistics, student ngf 8, kernels 1 and 3, spectral multiscale D) and
    a batch, for the cases held to the port's one process."""
    from cat_tpu_torch.core import config as tcfg
    from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig, SPADEGeneratorConfig
    from cat_tpu_torch.models.spade import SPADEGenerator

    kw = dict(semantic_nc=5, channels_reduction_factor=8, kernel_sizes=(1, 3),
              num_upsampling_layers="normal", crop_size=W, aspect_ratio=2.0)
    tc, sc = SPADEGeneratorConfig.make(ngf=16, **kw), SPADEGeneratorConfig.make(ngf=8, **kw)
    dc = MultiscaleDiscriminatorConfig(input_nc=8, ndf=8, n_layers=3, num_D=2)
    teacher = SPADEGenerator(tc, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for k, v in teacher.named_buffers():
            if k.endswith("running_var"):
                v.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif k.endswith("running_mean"):
                v.copy_(torch.from_numpy((rs.randn(*v.shape) * 0.1).astype(np.float32)))
    return {"teacher_cfg": tcfg.config_to_json(tc), "student_cfg": tcfg.config_to_json(sc),
            "disc_cfg": tcfg.config_to_json(dc), "hp": hp, "vgg": None,
            "teacher": teacher.state_dict(), "state": None,
            "batch": _raw_batch(rs, batch_size)}


def _inputs(tmp_path):
    """Every case's inputs, and the JAX objects its test steps from."""
    import jax.numpy as jnp

    from cat_tpu_torch.core import config as tcfg
    from cat_tpu_torch.models import vgg as tvgg
    from cat_tpu_torch.train.common import train_state_dict
    from cat_tpu_torch.utils import jax_import
    from tests.test_torch_spade import _jax_task, nhwc, to_port
    from tests.test_torch_spade_distill import _worlds

    rs = np.random.RandomState(23)
    inp, ref = {}, {}
    inp["layers"] = {name: {"x": rs.randn(2, 3, h, 6), "w": rs.randn(2, 4, 3 * h, 18)}
                     for name, (h, _, _) in _layers().items()}
    inp["layers"].update(sem=rs.randn(2, 5, 7, 6), img=rs.randn(2, 3, 7, 6),
                         w_sem=rs.randn(4, 5, 3, 3))
    vgg_sd = tvgg.random_vgg19_state_dict(seed=4)

    def jbatch(b):
        return {"label": jnp.asarray(b["label"].numpy()),
                "instance": jnp.asarray(b["instance"].numpy()),
                "image": jnp.asarray(nhwc(b["image"]))}

    # the teacher step: the JAX task's weights carried
    jtask, jstate = _jax_task(vgg_sd)
    gcfg, dcfg = to_port(jtask.gen_cfg), to_port(jtask.disc_cfg)
    batch = _raw_batch(rs)
    inp["task"] = {"gen": tcfg.config_to_json(gcfg), "disc": tcfg.config_to_json(dcfg),
                   "vgg": vgg_sd, "batch": batch,
                   "G": jax_import.spade_generator_state_dict(jstate.g.params, gcfg,
                                                              jstate.g.stats),
                   "D": jax_import.multiscale_discriminator_state_dict(jstate.d.params, dcfg,
                                                                       jstate.d.stats)}
    ref["task"] = (jtask, jstate, jbatch(batch), gcfg, dcfg)

    # the KA distill step: the JAX distiller's state carried
    jdist, jstate, tv, dist, state, _ = _worlds(tmp_path, vgg_sd, distill_loss_type="ka",
                                                lambda_vgg=10.0)
    batch = _raw_batch(rs)
    inp["distill"] = {"teacher_cfg": tcfg.config_to_json(dist.teacher_cfg),
                      "student_cfg": tcfg.config_to_json(dist.student_cfg),
                      "disc_cfg": tcfg.config_to_json(dist.disc_cfg),
                      "hp": {"distill_loss_type": "ka", "lambda_vgg": 10.0}, "vgg": vgg_sd,
                      "teacher": dist.netG_teacher.state_dict(),
                      "state": train_state_dict(state), "batch": batch}
    ref["distill"] = (jdist, jstate, tv, jbatch(batch), dist)

    # held to the port's one process
    for name, hp in (("mse", {"distill_loss_type": "mse"}), ("wgangp", {"gan_mode": "wgangp"}),
                     ("remat", {"remat": True})):
        inp[name] = _port_distill_inputs(rs, hp)
    inp["grid"] = _port_distill_inputs(rs, {}, batch_size=4)
    return inp, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, every world's ranks' results, the port's one-process
    results (computed meanwhile) and the JAX references' objects."""
    root = tmp_path_factory.mktemp("spatial_spade")
    inp, ref = _inputs(root)
    torch.save(inp, root / "in.pt")
    failures = []

    def run(world):
        try:
            mesh.spawn(_rank_main, world, args=(str(root), world), device="cpu",
                       timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test process
            failures.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    one = {name: distill_case(inp[name]) for name in (*PORT_CASES, "grid")}
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    outs = {w: [torch.load(root / f"out{w}_{r}.pt", weights_only=False) for r in range(w)]
            for w in WORLDS}
    return {"inp": inp, "ref": ref, "outs": outs, "one": one, "root": root}


def _ok(ranks, world, case):
    for r, out in enumerate(ranks["outs"][world]):
        assert "error" not in out[case], f"world {world} rank {r}:\n{out[case]['error']}"
    return [out[case] for out in ranks["outs"][world]]


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = (x.detach() if isinstance(x, torch.Tensor) else x for x in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _params_close(got, want, lr, what):
    """Within Adam's 2.5·lr after one step (tests/test_torch_teacher.py's
    bound at each net's TTUR rate)."""
    assert got.keys() == want.keys(), what
    worst = max(float((got[k].detach().float() - want[k].detach().float()).abs().max())
                for k in want)
    assert worst <= 2.5 * lr, (what, worst)


def _same_u(outs, net):
    """D's spectral ``u`` alike on every rank: the power iteration reads the
    replicated weights alone."""
    for out in outs[1:]:
        for k, v in outs[0][net].items():
            if k.endswith("weight_u"):
                assert torch.equal(out[net][k], v), k


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("layer", list(_layers()))
def test_split_height_primitive_matches_the_unsplit_op(ranks, world, layer):
    """Forward, input gradient and second-order gradient on every rank
    within 1e-5 of the reference's largest value, empty shards included."""
    for r, out in enumerate(_ok(ranks, world, "layers")):
        for what, (gap, scale) in out[layer].items():
            assert gap <= 1e-5 * scale, (f"S={world} rank {r} {what}", gap, scale)


@pytest.mark.parametrize("world", [2, 3])
def test_whole_map_semantics_give_each_rank_its_rows(ranks, world):
    """The conv over the semantics that every rank holds whole cuts its
    window from them (no exchange) and equals its rows of the whole conv;
    D's input is the rank's rows of the semantics beside its photo rows."""
    for r, out in enumerate(_ok(ranks, world, "layers")):
        assert out["whole_conv"] <= 1e-12, (r, out["whole_conv"])
        assert out["d_input"], r


def test_spade_task_step_at_two_spatial_ranks_matches_the_jax_step(ranks):
    """The GauGAN teacher step (syncbatch G with a 1-row latent, VGG, the
    spectral multiscale D, hinge) from the JAX task's weights: every loss on
    both ranks, G's and D's parameters, G's running statistics and D's
    ``u`` against the JAX single-device step; D's ``u`` alike on both
    ranks."""
    from cat_tpu_torch.utils import jax_import

    outs = _ok(ranks, 2, "task")
    jtask, jstate, jbatch, gcfg, dcfg = ranks["ref"]["task"]
    jstate, jm = jtask.train_step(jstate, jbatch, LR)
    want = {"G": jax_import.spade_generator_state_dict(jstate.g.params, gcfg, jstate.g.stats),
            "D": jax_import.multiscale_discriminator_state_dict(jstate.d.params, dcfg,
                                                                jstate.d.stats)}
    stats = ("running_mean", "running_var", "weight_u", "weight_v")
    for r, out in enumerate(outs):
        assert out["metrics"].keys() == jm.keys()
        for k in jm:
            _close(out["metrics"][k], jm[k], f"rank {r} {k}")
        for net, lr in (("G", LR / 2), ("D", 2 * LR)):
            assert out[net].keys() == want[net].keys()
            names = [k for k in want[net] if not k.endswith(stats)]
            _params_close({k: out[net][k] for k in names}, {k: want[net][k] for k in names}, lr,
                          f"rank {r} {net}")
            # weight_v is informational (the carry derives it from the new kernel)
            for k in want[net]:
                if k.endswith(stats[:3]):
                    _close(out[net][k], want[net][k], f"rank {r} {net} {k}", rtol=1e-4,
                           atol=1e-6)
    _same_u(outs, "D")


def test_spade_distill_step_at_two_spatial_ranks_matches_the_jax_step(ranks):
    """The KA distiller with VGG from the JAX distiller's state: every loss
    and distill part on both ranks, the student's, D's and the adaptors'
    parameters, the statistics and ``u`` against the JAX single-device step;
    six Grams a rank, the 1-row head_0's with no columns on the rank that
    owns no latent row (a zero partial Gram, no launch) and its rows on the
    other; D's ``u`` alike on both ranks."""
    from tests.test_torch_spade_distill import _carried

    outs = _ok(ranks, 2, "distill")
    jdist, jstate, tv, jbatch, dist = ranks["ref"]["distill"]
    jstate, jm = jdist.train_step(jstate, tv, jbatch, LR)
    want = _carried(jstate, dist, ranks["root"])
    mult_g, mult_d = dist.lr_mults
    for r, out in enumerate(outs):
        assert out["metrics"].keys() == jm.keys()
        for k in jm:
            _close(out["metrics"][k], jm[k], f"rank {r} {k}")
        got = out["state"]
        for net, lr in (("g", LR * mult_g), ("d", LR * mult_d)):
            _params_close(got[net]["params"], want[net]["params"], lr, f"rank {r} {net}")
            for k, v in got[net]["stats"].items():
                if not k.endswith("weight_v"):
                    _close(v, want[net]["stats"][k], f"rank {r} {net} {k}", rtol=1e-4, atol=1e-6)
        _params_close(got["adaptors"], want["adaptors"], LR * mult_g, f"rank {r} adaptors")
        shapes = out["gram_shapes"]
        assert len(shapes) == 6 and {b for b, _ in shapes} == {2}, shapes
        # head_0 (teacher, student) first: one latent row, rank 0's alone
        assert all((f == 0) == (r == 1) for _, f in shapes[:2]), (r, shapes)
        assert all(f > 0 for _, f in shapes[2:]), (r, shapes)
    for k, v in outs[0]["state"]["d"]["stats"].items():
        if k.endswith("weight_u"):
            assert torch.equal(outs[1]["state"]["d"]["stats"][k], v), k


@pytest.mark.parametrize("case", [*PORT_CASES, "grid"])
def test_spade_distill_step_split_equals_one_process(ranks, case):
    """``mse`` adaptors, wgangp (fixed penalty weights) and ``--remat 1`` at
    S = 2, and the KA distiller on a 2 x 2 grid (one row and half the
    height a rank): every rank's losses at rtol 1e-4 and its parameters
    (adaptors included) within Adam's one-step bound of the port's one
    process; D's ``u`` alike on every rank."""
    world = 4 if case == "grid" else 2
    want = ranks["one"][case]
    outs = _ok(ranks, world, case)
    for r, out in enumerate(outs):
        assert out["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            _close(out["metrics"][k], v, f"{case} rank {r} {k}", rtol=1e-4, atol=1e-5)
        for net, lr in (("g", LR / 2), ("d", 2 * LR)):
            _params_close(out["state"][net]["params"], want["state"][net]["params"], lr,
                          f"{case} rank {r} {net}")
        _params_close(out["state"]["adaptors"], want["state"]["adaptors"], LR / 2,
                      f"{case} rank {r} adaptors")
        for k, v in outs[0]["state"]["d"]["stats"].items():
            if k.endswith("weight_u"):
                assert torch.equal(out["state"]["d"]["stats"][k], v), (case, r, k)


def test_cityscapes_loader_cuts_the_photo_rows_and_keeps_the_label_maps_whole(tmp_path):
    """Each rank's (data, height) part of every batch: its rows of the
    photos, the label and instance maps of its data rows whole (every rank
    makes the semantics from them)."""
    from cat_tpu_torch.data.cityscapes import create_cityscapes_dataloader
    from tests.test_torch_spade import write_cityscapes

    root = write_cityscapes(str(tmp_path), n_train=4, size=(64, 32))
    kw = dict(load_size=64, crop_size=64, aspect_ratio=2.0, seed=5, num_workers=2)
    whole = list(create_cityscapes_dataloader(root, 4, **kw))
    for world, n_spatial in ((2, 2), (3, 3), (4, 2)):
        n_data = world // n_spatial
        for r in range(world):
            d, s = divmod(r, n_spatial)
            got = list(create_cityscapes_dataloader(
                root, 4, process_shard=(d, n_data) if n_data > 1 else None,
                height_shard=(s, n_spatial), **kw))
            assert len(got) == len(whole) == 1
            for g, w in zip(got, whole):
                want = local_batch({k: w[k] for k in ("label", "instance", "image")}, r,
                                   n_spatial, world)
                for k, v in want.items():
                    assert torch.equal(g[k], v), (world, r, k)
                assert g["label"].shape[1:] == (H, W)
