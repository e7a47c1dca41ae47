"""Spatial parallelism in the port (``--n_spatial``: image height split over
ranks, ``cat_tpu_torch/parallel/spatial.py``) over gloo processes on the
CPU, at tiny sizes (ngf 4-8, 3 blocks, 32 px), inputs and weights made with
numpy from a seed:

  * every geometry of the halo table (the stem's and head's reflect-3 7x7,
    the blocks' reflect pads for kernels 3 and 5 and the packed depthwise
    stage, the generator's stride-2 down- and transposed upsampling, the
    NLayer D's stride-2 and stride-1 4x4 convs) at S = 2 and at S = 3
    (uneven shards, a middle shard with two neighbours) against the
    unsplit op in float64: forward, input gradient and the second-order
    gradient through the halo (rtol 1e-5);
  * instance norm (plain, and the split fused norm's plain passes), batch
    norm (tracked and untracked) and KA at S = 2 and at D x S = 2 x 2
    against one process; KA also against ``cat_tpu.distill.ka.ka`` on the
    whole batch (rtol 1e-5);
  * the inception distill step (syncbatch, lsgan, KA on the encoder and
    block 1) and the pix2pix step (instance norm with lsgan; tracked batch
    norm with wgangp, the penalty's weights fixed on both sides) at S = 2
    against the JAX package's single-device step (losses at
    ``tests/test_sharding.py``'s rtol 2e-4 / atol 1e-5, parameters within
    Adam's 2.5·lr·steps);
  * the CycleGAN step at S = 2 (dropout, a batch-norm D, wgangp, a pool of
    3) and the distill step at 2 x 2 against the port's one process;
  * the loader's and the device bank's per-rank rows.

One spawn per world (2, 3 and 4 ranks, started together, ``TIMEOUT`` s
each) runs every case of that world; the references run in the test
process meanwhile.  Rank workers import nothing of JAX.
"""

import os
import threading
import traceback

import numpy as np
import pytest
import torch

from cat_tpu_torch.parallel import mesh

torch.set_num_threads(1)

SIZE = 32
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
    n_data = world // n_spatial
    b = x.shape[0] // n_data
    start, stop = rows(x.shape[2], s, n_spatial)
    return x[d * b:(d + 1) * b, :, start:stop]


def _port_cfg(text):
    from cat_tpu_torch.core import config as tcfg

    return tcfg.config_from_json(text)


# ---------------------------------------------------------------------------
# the cases, run by each rank
# ---------------------------------------------------------------------------

# (height, kind, build): every row of the halo table
GEOMETRIES = {
    "stem_head_reflect3_k7": (20, "pad", lambda: (3, "reflect", torch.nn.Conv2d(3, 4, 7))),
    "block_reflect1_k3": (13, "pad", lambda: (1, "reflect", torch.nn.Conv2d(4, 4, 3))),
    "block_reflect2_k5": (13, "pad", lambda: (2, "reflect", torch.nn.Conv2d(4, 4, 5))),
    "packed_dw_reflect2_k5": (13, "pad", lambda: (2, "reflect",
                                                   torch.nn.Conv2d(4, 4, 5, groups=4))),
    "down_k3_s2_p1": (20, "conv", lambda: torch.nn.Conv2d(3, 4, 3, 2, 1)),
    "up_convT_k3_s2_p1_op1": (9, "convT", None),
    "nlayer_k4_s2_p1": (20, "conv", lambda: torch.nn.Conv2d(3, 4, 4, 2, 1)),
    "nlayer_k4_s1_p1": (17, "conv", lambda: torch.nn.Conv2d(3, 4, 4, 1, 1)),
}


def _case_halo(inp, rank):
    """Each geometry on this rank's rows against the whole-height op (run
    here with the collectives off), float64: output, the input gradient of
    Σ y²·w and the gradient of Σ (that gradient)², both over the global
    tensors; the worst absolute gap and the reference's largest value."""
    import torch.nn.functional as F

    from cat_tpu_torch.ops import nn as onn
    from cat_tpu_torch.parallel import collectives

    _, s, n = collectives.axis("spatial")
    out = {}
    for name, (h, kind, build) in GEOMETRIES.items():
        torch.manual_seed(1)
        if kind == "convT":
            mod = onn.ConvTranspose2d(3, 4).double()
        else:
            spec = build()
            mod = (spec[-1] if kind == "pad" else spec).double()
        x = torch.from_numpy(inp[name]["x"])

        def op(t, split):
            if kind == "pad":
                pad, mode = spec[0], spec[1]
                if split:
                    return mod(onn.spatial_pad(t, pad, mode, h))
                return mod(F.pad(t, (pad,) * 4, mode=mode))
            if kind == "conv":
                return onn.conv2d(mod, t, h) if split else mod(t)
            return mod(t, h) if split else torch.nn.ConvTranspose2d.forward(mod, t)

        xr = x.clone().requires_grad_(True)
        with collectives.local():
            yr = op(xr, False)
            w = torch.from_numpy(inp[name]["w"][:, :, :yr.shape[2], :yr.shape[3]])
            g1r, = torch.autograd.grad((yr.square() * w).sum(), xr, create_graph=True)
            g2r, = torch.autograd.grad(g1r.square().sum(), xr)
        xl = shard(x, s, n, n).clone().requires_grad_(True)
        yl = op(xl, True)
        g1, = torch.autograd.grad((yl.square() * shard(w, s, n, n)).sum(), xl,
                                  create_graph=True)
        g2, = torch.autograd.grad(g1.square().sum(), xl)
        out[name] = {}
        for what, got, want in (("y", yl, yr), ("dx", g1, g1r), ("ddx", g2, g2r)):
            want = shard(want, s, n, n)
            assert got.shape == want.shape, (name, what, got.shape, want.shape)
            out[name][what] = (float((got - want).abs().max()), float(want.abs().max()))
    return out


def norm_outputs(inp, rank, n_spatial, world):
    """Instance norm (``Norm2d``, and the fused norm, whose split passes'
    plain versions run over a split height), batch norm tracked and not:
    output, input gradient of Σ y·w, running statistics."""
    from cat_tpu_torch.core.config import NormConfig
    from cat_tpu_torch.ops.instance_norm import fused_instance_norm_act
    from cat_tpu_torch.ops.nn import Norm2d

    scale, bias = torch.from_numpy(inp["scale"]), torch.from_numpy(inp["bias"])
    out = {}
    for kind in ("instance", "fused", "batch_tracked", "batch"):
        cfg = NormConfig(kind="instance" if kind in ("instance", "fused") else "batch",
                         affine=True, track_running_stats=kind == "batch_tracked",
                         momentum=0.2)
        m = Norm2d(cfg, 6)
        sd = {"weight": scale, "bias": bias}
        if kind == "batch_tracked":
            sd.update(running_mean=torch.zeros(6), running_var=torch.ones(6))
        m.load_state_dict(sd)
        x = shard(torch.from_numpy(inp["x"]), rank, n_spatial, world).requires_grad_(True)
        if kind == "fused":
            y = fused_instance_norm_act(x, scale, bias, cfg.eps, "relu")
        else:
            y = m(x, train=True)
        (y * shard(torch.from_numpy(inp["w"]), rank, n_spatial, world)).sum().backward()
        out[kind] = {"y": y.detach(), "grad": x.grad.clone()}
        if kind == "batch_tracked":
            out[kind].update(mean=m.running_mean.clone(), var=m.running_var.clone())
    return out


def ka_outputs(inp, rank, n_spatial, world):
    from cat_tpu_torch.distill import ka as tka

    x = shard(torch.from_numpy(inp["x"]), rank, n_spatial, world).requires_grad_(True)
    y = shard(torch.from_numpy(inp["y"]), rank, n_spatial, world)
    v = tka.ka(x, y)
    v.backward()
    return {"value": v.detach(), "grad": x.grad.clone()}


def distill_run(inp, rank=0, n_spatial=1, world=1):
    """The inception distiller's steps from carried weights over the
    whole batches (each rank's part of them)."""
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller

    cfgs = {k: _port_cfg(v) for k, v in inp["cfgs"].items()}
    dist = InceptionDistiller(cfgs["teacher"], cfgs["student"], cfgs["disc"],
                              hp=DistillHParams(**inp["hp"]), device="cpu")
    state, tparams = dist.init_state(inp["teacher"], inp["student"], inp["disc"])
    metrics = []
    for batch in inp["batches"]:
        state, m = dist.train_step(state, tparams, {k: shard(v, rank, n_spatial, world)
                                                    for k, v in batch.items()}, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "G": dist.netG_student.state_dict(),
            "D": dist.netD.state_dict()}


def pix2pix_run(inp, rank=0, n_spatial=1, world=1):
    from cat_tpu_torch.models import losses as tlosses
    from cat_tpu_torch.train.pix2pix import Pix2PixHParams, Pix2PixTask

    mixing = tlosses.mixing_weights
    tlosses.mixing_weights = lambda n, generator, like: torch.from_numpy(ALPHA).reshape(
        n, 1, 1, 1).to(like)
    try:
        task = Pix2PixTask(_port_cfg(inp["cfgs"]["gen"]), _port_cfg(inp["cfgs"]["disc"]),
                           Pix2PixHParams(**inp["hp"]), device="cpu")
        state = task.init_state(0, inp["G"])
        task.netD.load_state_dict(inp["D"])
        metrics = []
        for batch in inp["batches"]:
            state, m = task.train_step(state, {k: shard(v, rank, n_spatial, world)
                                               for k, v in batch.items()}, LR)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        tlosses.mixing_weights = mixing
    return {"metrics": metrics, "G": task.netG.state_dict(), "D": task.netD.state_dict()}


def cyclegan_run(inp, rank=0, n_spatial=1, world=1):
    from cat_tpu_torch.train.common import train_state_dict
    from cat_tpu_torch.train.cyclegan import CycleGANHParams, CycleGANTask

    task = CycleGANTask(_port_cfg(inp["cfgs"]["gen"]), _port_cfg(inp["cfgs"]["disc"]),
                        CycleGANHParams(**inp["hp"]), device="cpu")
    state = task.init_state(SIZE, SIZE, seed=3)
    metrics = []
    for batch in inp["batches"]:
        state, m = task.train_step(state, {k: shard(v, rank, n_spatial, world)
                                           for k, v in batch.items()}, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": train_state_dict(state)}


CASES = {
    2: {"halo": _case_halo,
        "norms": lambda i, r: norm_outputs(i, r, 2, 2),
        "ka": lambda i, r: ka_outputs(i, r, 2, 2),
        "distill": lambda i, r: distill_run(i, r, 2, 2),
        "pix2pix_in": lambda i, r: pix2pix_run(i, r, 2, 2),
        "pix2pix_bn_gp": lambda i, r: pix2pix_run(i, r, 2, 2),
        "cyclegan": lambda i, r: cyclegan_run(i, r, 2, 2)},
    3: {"halo": _case_halo},
    4: {"norms": lambda i, r: norm_outputs(i, r, 2, 4),
        "ka": lambda i, r: ka_outputs(i, r, 2, 4),
        "distill": lambda i, r: distill_run(i, r, 2, 4)},
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


def _inputs():
    """Every case's inputs, and the JAX objects its test steps from."""
    import jax
    import jax.numpy as jnp

    from cat_tpu.core import config as jcfg
    from cat_tpu.distill.inception_distiller import DistillHParams as JHP
    from cat_tpu.distill.inception_distiller import InceptionDistiller as JDistiller
    from cat_tpu.train import pix2pix as jpix2pix
    from cat_tpu_torch.utils import jax_import
    from tests.conftest import fast_init
    from tests.test_torch_teacher import nchw

    rs = np.random.RandomState(17)
    inp, ref = {}, {}
    inp["halo"] = {}
    for name, (h, kind, _) in GEOMETRIES.items():
        cin = 4 if name.startswith(("block", "packed")) else 3
        inp["halo"][name] = {"x": rs.randn(2, cin, h, 6),
                             "w": rs.randn(2, 4, 2 * h, 12)}
    inp["norms"] = {"x": (rs.randn(4, 6, 10, 7) * 3 + 2).astype(np.float32),
                    "w": rs.randn(4, 6, 10, 7).astype(np.float32),
                    "scale": (rs.rand(6) + 0.5).astype(np.float32),
                    "bias": rs.randn(6).astype(np.float32)}
    inp["ka"] = {"x": rs.randn(6, 3, 10, 7).astype(np.float32),
                 "y": rs.randn(6, 4, 10, 5).astype(np.float32)}

    def gen_cfg(ngf, norm, **kw):
        return jcfg.InceptionGeneratorConfig.make(ngf=ngf, channels=None,
                                                  channels_reduction_factor=2,
                                                  kernel_sizes=(1, 3, 5), n_blocks=3, norm=norm,
                                                  **kw)

    def images(n, c=3):
        return rs.randn(n, SIZE, SIZE, c).astype(np.float32)

    # the inception distill step: syncbatch nets, lsgan, KA on two taps
    norm = jcfg.NormConfig(kind="syncbatch", affine=True, track_running_stats=True)
    tc, sc = gen_cfg(8, norm), gen_cfg(4, norm)
    dc = jcfg.NLayerDiscriminatorConfig(input_nc=6, ndf=8, norm=norm)
    hp = dict(dataset_mode="aligned", gan_mode="lsgan", distill_loss_type="ka",
              mapping_layers=("encode", "block1"))
    jd = JDistiller(tc, sc, dc, hp=JHP(**hp))
    tv = dict(fast_init(jd.netG_teacher, jnp.zeros((1, SIZE, SIZE, 3)), seed=7))
    tv["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, v: (rs.rand(*v.shape) + 0.5 if p[-1].key == "var"
                      else rs.randn(*v.shape) * 0.05).astype(np.float32), tv["batch_stats"])
    jstate, tv = jd.init_state(jax.random.PRNGKey(0), SIZE, SIZE, tv)
    batches = [{k: images(4) for k in "AB"} for _ in range(2)]
    inp["distill"] = {
        "cfgs": {"teacher": jcfg.config_to_json(tc), "student": jcfg.config_to_json(sc),
                 "disc": jcfg.config_to_json(dc)},
        "hp": hp,
        "teacher": jax_import.generator_state_dict(tv["params"], tc, tv.get("batch_stats")),
        "student": jax_import.generator_state_dict(jstate.g.params["G"], sc, jstate.g.stats),
        "disc": jax_import.nlayer_discriminator_state_dict(jstate.d.params, dc, jstate.d.stats),
        "batches": [{k: nchw(v) for k, v in b.items()} for b in batches]}
    ref["distill"] = (jd, jstate, tv, batches, sc, dc)

    # the pix2pix step: instance norm with lsgan; tracked batch norm with wgangp
    for name, norm, gan_mode in (
            ("pix2pix_in", jcfg.NormConfig(kind="instance", affine=True,
                                           track_running_stats=False), "lsgan"),
            ("pix2pix_bn_gp", jcfg.NormConfig(kind="batch", affine=True,
                                              track_running_stats=True), "wgangp")):
        gc = gen_cfg(4, norm)
        pdc = jcfg.NLayerDiscriminatorConfig(input_nc=6, ndf=4, norm=norm)
        jtask = jpix2pix.Pix2PixTask(gc, pdc, jpix2pix.Pix2PixHParams(gan_mode=gan_mode))
        pstate = jtask.init_state(jax.random.PRNGKey(0), SIZE, SIZE)
        batches = [{k: images(2) for k in "AB"} for _ in range(2)]
        inp[name] = {
            "cfgs": {"gen": jcfg.config_to_json(gc), "disc": jcfg.config_to_json(pdc)},
            "hp": {"gan_mode": gan_mode},
            "G": jax_import.generator_state_dict(pstate.g.params, gc, pstate.g.stats),
            "D": jax_import.nlayer_discriminator_state_dict(pstate.d.params, pdc, pstate.d.stats),
            "batches": [{k: nchw(v) for k, v in b.items()} for b in batches]}
        ref[name] = (jtask, pstate, batches, gc, pdc)

    # CycleGAN: dropout and the penalty's draws, a batch-norm D, a pool of 3
    inorm = jcfg.NormConfig(kind="instance", affine=True, track_running_stats=False)
    bnorm = jcfg.NormConfig(kind="batch", affine=True, track_running_stats=True)
    inp["cyclegan"] = {
        "cfgs": {"gen": jcfg.config_to_json(gen_cfg(4, inorm, dropout_rate=0.5)),
                 "disc": jcfg.config_to_json(jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=4,
                                                                            norm=bnorm))},
        "hp": {"gan_mode": "wgangp", "pool_size": 3},
        "batches": [{k: nchw(images(2)) for k in "AB"} for _ in range(3)]}
    return inp, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, every world's ranks' results, the port's one-process
    results (computed meanwhile) and the JAX references' objects."""
    from _pytest.monkeypatch import MonkeyPatch

    from tests.test_torch_teacher import fixed_alpha, jax_stats_left_alone

    root = tmp_path_factory.mktemp("spatial")
    mp = MonkeyPatch()
    jax_stats_left_alone(mp)
    try:
        inp, ref = _inputs()
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
        one = {"norms": norm_outputs(inp["norms"], 0, 1, 1),
               "ka": ka_outputs(inp["ka"], 0, 1, 1),
               "distill": distill_run(inp["distill"]),
               "cyclegan": cyclegan_run(inp["cyclegan"])}
        for t in threads:
            t.join()
        fixed_alpha(mp)  # the JAX pix2pix steps' penalty weights, as the ranks' (pix2pix_run)
        if failures:
            raise failures[0]
        outs = {w: [torch.load(root / f"out{w}_{r}.pt", weights_only=False) for r in range(w)]
                for w in WORLDS}
        yield {"inp": inp, "ref": ref, "outs": outs, "one": one}
    finally:
        mp.undo()


def _ok(ranks, world, case):
    for r, out in enumerate(ranks["outs"][world]):
        assert "error" not in out[case], f"world {world} rank {r}:\n{out[case]['error']}"
    return [out[case] for out in ranks["outs"][world]]


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = (x.detach() if isinstance(x, torch.Tensor) else x for x in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _params_close(got, want, steps, what, lr=LR):
    """Within Adam's 2.5·lr·steps (tests/test_torch_teacher.py's bound)."""
    assert got.keys() == want.keys(), what
    worst = max(float((got[k].detach().float() - want[k].detach().float()).abs().max())
                for k in want)
    assert worst <= 2.5 * lr * steps, (what, worst)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_halo_conv_matches_the_unsplit_conv(ranks, world, geometry):
    """Forward, input gradient and second-order gradient on every rank
    within 1e-5 of the reference's largest value."""
    for r, out in enumerate(_ok(ranks, world, "halo")):
        for what, (gap, scale) in out[geometry].items():
            assert gap <= 1e-5 * scale, (f"S={world} rank {r} {what}", gap, scale)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["instance", "fused", "batch_tracked", "batch"])
def test_norms_over_a_split_height_equal_one_process(ranks, world, kind):
    """Output, input gradient and running statistics at S = 2 and 2 x 2."""
    n_spatial = WORLDS[world]
    want = ranks["one"]["norms"][kind]
    for r, out in enumerate(_ok(ranks, world, "norms")):
        got = out[kind]
        for key in want:
            w = want[key] if key in ("mean", "var") else shard(want[key], r, n_spatial, world)
            _close(got[key], w, f"{world} ranks, rank {r} {kind} {key}", rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ka_over_a_split_height_is_the_global_ka(ranks, world):
    """Value and gradient against one process and against
    ``jax.value_and_grad`` of the JAX KA on the whole batch (rtol 1e-5).  A
    rank's gradient is that of the ranks' summed objective (each computes
    the global KA): the world size times the JAX gradient on its part."""
    import jax
    import jax.numpy as jnp

    from cat_tpu.distill.ka import ka as jka

    x, y = ranks["inp"]["ka"]["x"], ranks["inp"]["ka"]["y"]
    val, grad = jax.value_and_grad(lambda a: jka(a, jnp.asarray(y), use_pallas="no"))(
        jnp.asarray(x))
    one = ranks["one"]["ka"]
    n_spatial = WORLDS[world]
    for r, out in enumerate(_ok(ranks, world, "ka")):
        _close(out["value"], val, f"rank {r} KA", rtol=1e-5, atol=0)
        _close(out["value"], one["value"], f"rank {r} KA, one process", rtol=1e-5, atol=0)
        part = shard(torch.from_numpy(np.array(grad)), r, n_spatial, world)
        _close(out["grad"], world * part, f"rank {r} dKA/dx", rtol=1e-5, atol=1e-7)
        _close(out["grad"], world * shard(one["grad"], r, n_spatial, world),
               f"rank {r} dKA/dx, one process", rtol=1e-5, atol=1e-7)


def _jax_steps(ranks, case, world=2):
    """Step the JAX reference of ``case`` over its batches, holding every
    rank's metrics at each step."""
    import jax.numpy as jnp

    outs = _ok(ranks, world, case)
    r = ranks["ref"][case]
    jobj, jstate, batches = r[0], r[1], r[3 if case == "distill" else 2]
    for step, b in enumerate(batches):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if case == "distill":
            jstate, jm = jobj.train_step(jstate, r[2], b, LR)
        else:
            jstate, jm = jobj.train_step(jstate, b, LR)
        for rank, out in enumerate(outs):
            assert out["metrics"][step].keys() == jm.keys()
            for k in jm:
                _close(out["metrics"][step][k], jm[k], f"rank {rank} step {step + 1} {k}")
    return outs, jstate


def test_inception_distill_step_at_two_spatial_ranks_matches_the_jax_step(ranks):
    """Two steps of the syncbatch KA distiller (teacher and student taps
    split in height, lsgan): every metric on both ranks, and the student's
    and D's parameters and running statistics, against the JAX
    single-device step."""
    from cat_tpu_torch.utils import jax_import

    outs, jstate = _jax_steps(ranks, "distill")
    sc, dc = ranks["ref"]["distill"][4:]
    g = jax_import.generator_state_dict(jstate.g.params["G"], sc, jstate.g.stats)
    d = jax_import.nlayer_discriminator_state_dict(jstate.d.params, dc, jstate.d.stats)
    for r, out in enumerate(outs):
        for name, got, want in (("G", out["G"], g), ("D", out["D"], d)):
            stats = [k for k in got if ".running" in k or k.startswith("running")]
            _params_close({k: v for k, v in got.items() if k not in stats},
                          {k: v for k, v in want.items() if k not in stats}, 2, f"rank {r} {name}")
            for k in stats:
                _close(got[k], want[k], f"rank {r} {name} {k}", rtol=1e-3, atol=2.5 * LR * 2)


@pytest.mark.parametrize("case", ["pix2pix_in", "pix2pix_bn_gp"])
def test_pix2pix_step_at_two_spatial_ranks_matches_the_jax_step(ranks, case):
    """Instance norm with lsgan, and tracked batch norm with wgangp (the
    penalty's per-sample norm summed over the spatial axis; its weights
    fixed on both sides): two steps' metrics and the parameters."""
    from cat_tpu_torch.utils import jax_import

    outs, jstate = _jax_steps(ranks, case)
    gc, dc = ranks["ref"][case][3:]
    want = {"G": jax_import.generator_state_dict(jstate.g.params, gc),
            "D": jax_import.nlayer_discriminator_state_dict(jstate.d.params, dc)}
    for r, out in enumerate(outs):
        for net in ("G", "D"):
            _params_close({k: v for k, v in out[net].items() if ".running" not in k},
                          {k: v for k, v in want[net].items() if ".running" not in k}, 2,
                          f"rank {r} {net}")


def test_cyclegan_step_at_two_spatial_ranks_equals_one_process(ranks):
    """Three wgangp steps with dropout (masks drawn at full height, each
    rank keeping its rows), a batch-norm D and a pool of 3 holding whole
    images: losses within 1e-5, the pools alike on both ranks and equal to
    one process's, parameters within Adam's bound."""
    want = ranks["one"]["cyclegan"]
    for r, out in enumerate(_ok(ranks, 2, "cyclegan")):
        for step, (got_m, want_m) in enumerate(zip(out["metrics"], want["metrics"])):
            assert got_m.keys() == want_m.keys()
            for k in want_m:
                _close(got_m[k], want_m[k], f"rank {r} step {step + 1} {k}", rtol=1e-5, atol=1e-5)
        for name, pool in want["state"]["pools"].items():
            assert out["state"]["pools"][name]["count"] == pool["count"] == 3
            _close(out["state"]["pools"][name]["buffer"], pool["buffer"], f"rank {r} pool {name}",
                   rtol=1e-4, atol=1e-4)
        for net in ("g", "d"):
            _params_close(out["state"][net]["params"], want["state"][net]["params"], 3,
                          f"rank {r} {net}")


def test_distill_step_on_a_two_by_two_grid_equals_one_process(ranks):
    """The syncbatch KA distiller at D x S = 2 x 2 (two rows and half the
    height a rank): every rank's metrics and parameters against the port's
    one process."""
    want = ranks["one"]["distill"]
    for r, out in enumerate(_ok(ranks, 4, "distill")):
        for step, (got_m, want_m) in enumerate(zip(out["metrics"], want["metrics"])):
            assert got_m.keys() == want_m.keys()
            for k in want_m:
                _close(got_m[k], want_m[k], f"rank {r} step {step + 1} {k}", rtol=1e-4, atol=1e-5)
        for net in ("G", "D"):
            stats = [k for k in out[net] if ".running" in k]
            _params_close({k: v for k, v in out[net].items() if k not in stats},
                          {k: v for k, v in want[net].items() if k not in stats}, 2,
                          f"rank {r} {net}")


def test_loader_and_bank_rows_are_the_one_process_batch(tmp_path):
    """Each rank's (data, height) part of every batch of the host loader and
    of the device bank is its part of the one-process batch, after the same
    crops and flips."""
    from PIL import Image

    from cat_tpu_torch.data import datasets as tds
    from cat_tpu_torch.data.device_data import DeviceData, DeviceDataLoader
    from cat_tpu_torch.data.transforms import TransformSpec
    from cat_tpu_torch.parallel.spatial import rows

    rs = np.random.RandomState(0)
    for side in ("trainA", "trainB"):
        os.makedirs(tmp_path / side)
        for i in range(8):
            Image.fromarray(rs.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                tmp_path / side / f"{i}.png")
    spec = TransformSpec(load_size=36, crop_size=31)  # 31 rows: 16 and 15 over S = 2
    whole = list(tds.create_dataloader("unaligned", str(tmp_path), 4, spec, seed=5,
                                       num_workers=0))
    dd, _ = DeviceData.from_unaligned(str(tmp_path), "train", 36, 31, device="cpu")
    bank = list(DeviceDataLoader(dd, 4, 2, seed=5))
    for world, n_spatial in ((2, 2), (4, 2)):
        n_data = world // n_spatial
        for r in range(world):
            d, s = divmod(r, n_spatial)
            dshard = (d, n_data) if n_data > 1 else None
            got = list(tds.create_dataloader("unaligned", str(tmp_path), 4, spec, seed=5,
                                             num_workers=2, process_shard=dshard,
                                             height_shard=(s, n_spatial)))
            got_bank = list(DeviceDataLoader(dd, 4, 2, seed=5, process_shard=dshard,
                                             height_shard=(s, n_spatial)))
            start, stop = rows(31, s, n_spatial)
            assert len(got) == len(whole) == 2
            for g, w, gb, wb in zip(got, whole, got_bank, bank):
                for k in "AB":
                    assert g[k].shape[2] == stop - start
                    assert torch.equal(g[k], shard(w[k], r, n_spatial, world))
                    assert torch.equal(gb[k], shard(wb[k], r, n_spatial, world))
