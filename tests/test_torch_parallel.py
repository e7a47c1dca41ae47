"""Data parallelism in the port over two gloo processes on the CPU, held
against the JAX package's single-device functions of the whole batch (ngf
4-8, 3 blocks, 32 px, global batch 2-8, inputs and weights made with numpy
from a seed and carried over with ``utils/jax_import.py``):

  * the host-side merges (``reduce_moments``, ``reduce_hist``), one share
    empty, against numpy's sums;
  * the loader's slice of rank r against the JAX package's
    ``process_shard=(r, 2)`` loader, and the divisibility error;
  * KA of the global batch (B 6, an odd F): value and each rank's rows'
    gradient against ``jax.value_and_grad`` of ``cat_tpu.distill.ka``;
  * ``Norm2d`` batch and syncbatch: output, input gradient and running
    statistics against the JAX norm over the whole batch;
  * the inception distill step (``tests/test_sharding.py:61-95``'s batch
    norm), the pix2pix step (``:33-58``) and the SPADE distill step
    (syncbatch) against the JAX single-device steps, metrics at the JAX
    sharding tests' rtol 5e-4 / atol 1e-5 and parameters within Adam's
    2.5·lr·steps (its ±lr on float32-noise gradients);
  * the CycleGAN step (one pool over the global fakes, dropout masks and
    the gradient penalty's weights drawn over the global batch, a batch-norm
    D) and the FID (a random judge's 64 stem features) and mIoU evaluators
    against the port's world of one.

One spawn of two ranks (``parallel/mesh.py::spawn``, 120 s at most) runs
every world-2 case in ``_rank_main``; the JAX references run in the test
process afterwards.  Rank workers import nothing of JAX.
"""

import json
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
RTOL, ATOL = 5e-4, 1e-5  # tests/test_sharding.py's tolerances for the sharded step
TIMEOUT = 120


def _rows(x, rank, world=2):
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def _port_cfg(text):
    from cat_tpu_torch.core import config as tcfg

    return tcfg.config_from_json(text)


# ---------------------------------------------------------------------------
# the world-2 cases, run by each rank
# ---------------------------------------------------------------------------


def _case_merges(inp, rank):
    from cat_tpu_torch.parallel import multihost

    a = inp["acts"]
    n, s1, s2 = (a.shape[0], a.sum(0), a.T @ a) if rank == 0 else (0, None, None)
    moments = multihost.reduce_moments(n, s1, s2)
    return {"moments": moments, "hist": multihost.reduce_hist(inp["hists"][rank])}


def _case_ka(inp, rank):
    import torch.distributed.nn.functional as dnn

    from cat_tpu_torch.distill import ka as tka

    out = {}
    x = _rows(torch.from_numpy(inp["x"]), rank).requires_grad_(True)
    y = _rows(torch.from_numpy(inp["y"]), rank)
    v = tka.ka(x, y)
    v.backward()
    out["value"], out["grad"] = v.detach(), x.grad.clone()
    # the library's autograd gather, whose backward sums the ranks' slices
    x2 = x.detach().clone().requires_grad_(True)
    v2 = tka._KA.apply(torch.cat(dnn.all_gather(x2)), torch.cat(dnn.all_gather(y)))
    v2.backward()
    out["value_library"], out["grad_library"] = v2.detach(), x2.grad.clone()
    return out


def _case_norms(inp, rank):
    from cat_tpu_torch.core.config import NormConfig
    from cat_tpu_torch.ops.nn import Norm2d

    out = {}
    for kind in ("batch", "syncbatch"):
        m = Norm2d(NormConfig(kind=kind, affine=True, track_running_stats=True, momentum=0.2),
                   inp["x"].shape[1])
        m.load_state_dict({"weight": torch.from_numpy(inp["scale"]),
                           "bias": torch.from_numpy(inp["bias"]),
                           "running_mean": torch.zeros(6), "running_var": torch.ones(6)})
        x = _rows(torch.from_numpy(inp["x"]), rank).requires_grad_(True)
        y = m(x, train=True)
        (y * _rows(torch.from_numpy(inp["w"]), rank)).sum().backward()
        out[kind] = {"y": y.detach(), "grad": x.grad.clone(),
                     "mean": m.running_mean.clone(), "var": m.running_var.clone()}
    return out


def _case_distill(inp, rank):
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller

    cfgs = {k: _port_cfg(v) for k, v in inp["cfgs"].items()}
    dist = InceptionDistiller(cfgs["teacher"], cfgs["student"], cfgs["disc"],
                              hp=DistillHParams(**inp["hp"]), device="cpu")
    state, tparams = dist.init_state(inp["teacher"], inp["student"], inp["disc"])
    metrics = []
    for batch in inp["batches"]:
        state, m = dist.train_step(state, tparams, {k: _rows(v, rank) for k, v in batch.items()},
                                   LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "G": dist.netG_student.state_dict(),
            "D": dist.netD.state_dict()}


def _case_pix2pix(inp, rank):
    from cat_tpu_torch.train.pix2pix import Pix2PixHParams, Pix2PixTask

    task = Pix2PixTask(_port_cfg(inp["cfgs"]["gen"]), _port_cfg(inp["cfgs"]["disc"]),
                       Pix2PixHParams(), device="cpu")
    state = task.init_state(0, inp["G"])
    task.netD.load_state_dict(inp["D"])
    metrics = []
    for batch in inp["batches"]:
        state, m = task.train_step(state, {k: _rows(v, rank) for k, v in batch.items()}, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "G": task.netG.state_dict(), "D": task.netD.state_dict()}


def _case_spade(inp, rank):
    from cat_tpu_torch.distill import spade_distiller as tsd
    from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict

    cfgs = {k: _port_cfg(v) for k, v in inp["cfgs"].items()}
    dist = tsd.SPADEDistiller(cfgs["teacher"], cfgs["student"], cfgs["disc"],
                              tsd.SPADEDistillHParams(**inp["hp"]), input_nc=3,
                              contain_dontcare=True, device="cpu")
    state, tparams = dist.init_state(inp["teacher"], seed=5)
    load_train_state_dict(state, inp["state"])
    metrics = []
    for batch in inp["batches"]:
        state, m = dist.train_step(state, tparams, {k: _rows(v, rank) for k, v in batch.items()},
                                   LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": train_state_dict(state)}


def _case_spade_remat(inp, rank):
    """The SPADE case under --remat 1, without and with a selective
    policy: the recompute runs the batch-norm sums' collectives again."""
    return {policy: _case_spade({**inp, "hp": {**inp["hp"], "remat": True,
                                              "remat_policy": policy}}, rank)
            for policy in ("", "dots_saveable")}


def cyclegan_run(inp, rank=0):
    """The CycleGAN case's steps from a seed (the world of one calls it
    with the whole batches)."""
    from cat_tpu_torch.train.cyclegan import CycleGANHParams, CycleGANTask
    from cat_tpu_torch.train.common import train_state_dict

    task = CycleGANTask(_port_cfg(inp["cfgs"]["gen"]), _port_cfg(inp["cfgs"]["disc"]),
                        CycleGANHParams(**inp["hp"]), device="cpu")
    state = task.init_state(SIZE, SIZE, seed=3)
    metrics = []
    for batch in inp["batches"]:
        state, m = task.train_step(state, {k: _rows(v, rank, inp["world"])
                                           for k, v in batch.items()}, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": train_state_dict(state)}


def _case_cyclegan(inp, rank):
    return cyclegan_run({**inp, "world": 2}, rank)


class StemJudge(torch.nn.Module):
    """The judge's stem (output block 0) pooled to 64 features: the FID
    evaluator's merge at a width whose matrix square root is instant."""

    def __init__(self, path):
        from cat_tpu_torch.metrics.inception import load_inception

        super().__init__()
        self.net = load_inception(path, output_blocks=(0,), device="cpu")

    def forward(self, x):
        return [self.net(x)[0].mean(dim=(2, 3))]


def evaluators(inp, process_shard=None):
    """The FID and mIoU evaluators over the aligned val pairs, the
    generator a fixed function."""
    from cat_tpu_torch.data import datasets as tds
    from cat_tpu_torch.data.transforms import TransformSpec
    from cat_tpu_torch.metrics import drn
    from cat_tpu_torch.train.evaluation import FIDEvaluator, MIoUEvaluator

    def gen(x):
        return torch.tanh(0.7 * x + 0.1)

    spec = TransformSpec(preprocess="none", load_size=inp["w"], crop_size=inp["w"],
                         no_flip=True)
    loader = tds.create_eval_dataloader("aligned", inp["pairs"], 2, spec, "BtoA")
    stats = {"mu": inp["mu"], "sigma": inp["sigma"]}
    log_dir = inp["log_dir"] if process_shard is None or process_shard[0] == 0 else None
    fid = FIDEvaluator(gen, loader, StemJudge(inp["judge"]), stats, log_dir, 2, device="cpu",
                       process_shard=process_shard)
    miou = MIoUEvaluator(gen, loader, drn.load_drnseg(inp["drn"], device="cpu"), inp["table"],
                         data_dir=inp["origin"], batch_size=2, device="cpu",
                         process_shard=process_shard)
    return fid, miou


def _case_eval(inp, rank):
    fid, miou = evaluators(inp, (rank, 2))
    return {"fid": fid("0")[0], "miou": miou("0")[0]}


CASES = {"merges": _case_merges, "ka": _case_ka, "norms": _case_norms,
         "distill": _case_distill, "pix2pix": _case_pix2pix, "spade": _case_spade,
         "spade_remat": _case_spade_remat,
         "cyclegan": _case_cyclegan, "eval": _case_eval}


def _rank_main(device, root):
    """A rank: every case of ``root/in.pt`` in turn, each one's result (or
    its traceback) to ``root/out<rank>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    inputs = torch.load(os.path.join(root, "in.pt"), weights_only=False)
    out = {}
    for name, fn in CASES.items():
        try:
            out[name] = fn(inputs[name], rank)
        except Exception:  # reported by the case's test
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(root, f"out{rank}.pt"))


# ---------------------------------------------------------------------------
# the inputs (the JAX package's weights, carried) and the spawn
# ---------------------------------------------------------------------------


def _inputs(root):
    """Every case's inputs, and the JAX objects its test steps from."""
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from cat_tpu.core import config as jcfg
    from cat_tpu.distill.inception_distiller import DistillHParams as JHP
    from cat_tpu.distill.inception_distiller import InceptionDistiller as JDistiller
    from cat_tpu.metrics import drn as jdrn
    from cat_tpu.train import pix2pix as jpix2pix
    from cat_tpu_torch.metrics.inception import write_random_judge
    from cat_tpu_torch.utils import jax_import
    from tests.conftest import fast_init
    from tests.test_torch_miou import CLASSES, TINY_CHANNELS, TINY_LAYERS, _cityscapes_fixture
    from tests.test_torch_spade_distill import _batch, _worlds
    from tests.test_torch_teacher import nchw
    from cat_tpu_torch.train.common import train_state_dict

    rs = np.random.RandomState(233)
    inp, ref = {}, {}
    inp["merges"] = {"acts": rs.randn(7, 5), "hists": [rs.randint(0, 50, (4, 4)) for _ in "01"]}
    inp["ka"] = {"x": rs.randn(6, 3, 5, 7).astype(np.float32),
                 "y": rs.randn(6, 4, 3, 3).astype(np.float32)}
    inp["norms"] = {"x": (rs.randn(4, 6, 5, 7) * 3 + 2).astype(np.float32),
                    "w": rs.randn(4, 6, 5, 7).astype(np.float32),
                    "scale": (rs.rand(6) + 0.5).astype(np.float32),
                    "bias": rs.randn(6).astype(np.float32)}

    def gen_cfg(ngf, norm, **kw):
        return jcfg.InceptionGeneratorConfig.make(ngf=ngf, channels=None,
                                                  channels_reduction_factor=2,
                                                  kernel_sizes=(1, 3), n_blocks=3, norm=norm, **kw)

    def images(n, c=3):
        return rs.randn(n, SIZE, SIZE, c).astype(np.float32)

    # the inception distill step on tests/test_sharding.py:61-95's config
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
    batches = [{k: images(8) for k in "AB"} for _ in range(2)]
    inp["distill"] = {
        "cfgs": {"teacher": jcfg.config_to_json(tc), "student": jcfg.config_to_json(sc),
                 "disc": jcfg.config_to_json(dc)},
        "hp": hp,
        "teacher": jax_import.generator_state_dict(tv["params"], tc, tv.get("batch_stats")),
        "student": jax_import.generator_state_dict(jstate.g.params["G"], sc, jstate.g.stats),
        "disc": jax_import.nlayer_discriminator_state_dict(jstate.d.params, dc, jstate.d.stats),
        "batches": [{k: nchw(v) for k, v in b.items()} for b in batches]}
    ref["distill"] = (jd, jstate, tv, batches, sc, dc)

    # the pix2pix step on tests/test_sharding.py:33-58's config
    inorm = jcfg.NormConfig(kind="instance", affine=True, track_running_stats=False)
    gc, pdc = gen_cfg(4, inorm), jcfg.NLayerDiscriminatorConfig(input_nc=6, ndf=4)
    jtask = jpix2pix.Pix2PixTask(gc, pdc)
    pstate = jtask.init_state(jax.random.PRNGKey(0), SIZE, SIZE)
    batches = [{k: images(8) for k in "AB"} for _ in range(2)]
    inp["pix2pix"] = {
        "cfgs": {"gen": jcfg.config_to_json(gc), "disc": jcfg.config_to_json(pdc)},
        "G": jax_import.generator_state_dict(pstate.g.params, gc, pstate.g.stats),
        "D": jax_import.nlayer_discriminator_state_dict(pstate.d.params, pdc, pstate.d.stats),
        "batches": [{k: nchw(v) for k, v in b.items()} for b in batches]}
    ref["pix2pix"] = (jtask, pstate, batches, gc, pdc)

    # the SPADE distill step (syncbatch everywhere), tests/test_torch_spade_distill.py's nets
    jsd, sstate, stv, tdist, tstate, _ = _worlds(root, lambda_vgg=0.0)
    sbatches = [_batch(rs)]
    inp["spade_remat"] = inp["spade"] = {
        "cfgs": {k: _cfg_json(c) for k, c in (("teacher", tdist.teacher_cfg),
                                               ("student", tdist.student_cfg),
                                               ("disc", tdist.disc_cfg))},
        "hp": {"lambda_vgg": 0.0}, "teacher": tdist.netG_teacher.state_dict(),
        "state": train_state_dict(tstate), "batches": [b[1] for b in sbatches]}
    ref["spade"] = (jsd, sstate, stv, tdist, tstate, [b[0] for b in sbatches])

    # CycleGAN: dropout and the penalty's draws, a batch-norm D, a pool of 3
    bnorm = jcfg.NormConfig(kind="batch", affine=True, track_running_stats=True)
    inp["cyclegan"] = {
        "cfgs": {"gen": jcfg.config_to_json(gen_cfg(4, inorm, dropout_rate=0.5)),
                 "disc": jcfg.config_to_json(jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=4,
                                                                            norm=bnorm))},
        "hp": {"gan_mode": "wgangp", "pool_size": 3},
        "batches": [{k: nchw(images(4)) for k in "AB"} for _ in range(3)]}

    # the evaluators: 5 val pairs (3 batches of 2: shares of 2 and 1), a
    # random judge's stem and statistics, a tiny DRN judge
    from tests.test_torch_miou import H, W

    table = _cityscapes_fixture(root, n=5)
    judge = str(root / "judge.pth")
    write_random_judge(judge, seed=1)
    drn_path = str(root / "drn_tiny.msgpack")
    model = jdrn.DRNSeg(classes=CLASSES, layers=TINY_LAYERS, channels=TINY_CHANNELS)
    jdrn.save_drnseg(drn_path, model, fast_init(model, jnp.zeros((1, H, W, 3)), seed=3))
    a = rs.randn(64, 16) / 4
    inp["eval"] = {"pairs": str(root / "pairs"), "w": W, "judge": judge, "drn": drn_path,
                   "table": str(table), "origin": str(root), "log_dir": str(root / "ev2"),
                   "mu": rs.randn(64) * 0.1, "sigma": a @ a.T + 0.01 * np.eye(64)}
    return inp, ref


def _cfg_json(cfg):
    from cat_tpu_torch.core import config as tcfg

    return tcfg.config_to_json(cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, both ranks' results, the world-of-one results the
    port computes meanwhile, and the JAX references' objects."""
    from _pytest.monkeypatch import MonkeyPatch

    from tests.test_torch_teacher import jax_stats_left_alone

    root = tmp_path_factory.mktemp("parallel")
    mp = MonkeyPatch()
    jax_stats_left_alone(mp)
    try:
        inp, ref = _inputs(root)
        torch.save(inp, root / "in.pt")
        failure = []

        def run():
            try:
                mesh.spawn(_rank_main, 2, args=(str(root),), device="cpu", timeout=TIMEOUT)
            except BaseException as e:  # re-raised in the test process
                failure.append(e)

        t = threading.Thread(target=run)
        t.start()
        world1 = {"cyclegan": cyclegan_run({**inp["cyclegan"], "world": 1})}
        fid, miou = evaluators({**inp["eval"], "log_dir": str(root / "ev1")})
        world1["eval"] = {"fid": fid("0")[0], "miou": miou("0")[0]}
        t.join()
        if failure:
            raise failure[0]
        outs = [torch.load(root / f"out{r}.pt", weights_only=False) for r in (0, 1)]
        yield {"root": root, "inp": inp, "ref": ref, "outs": outs, "world1": world1}
    finally:
        mp.undo()


def _ok(ranks, case):
    for r, out in enumerate(ranks["outs"]):
        assert "error" not in out[case], f"rank {r}:\n{out[case]['error']}"
    return [out[case] for out in ranks["outs"]]


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


def test_moments_and_hist_merge_with_an_empty_share(ranks):
    a = ranks["inp"]["merges"]["acts"]
    for out in _ok(ranks, "merges"):
        n, s1, s2 = out["moments"]
        assert n == 7
        np.testing.assert_array_equal(s1, a.sum(0))
        np.testing.assert_array_equal(s2, a.T @ a)
        np.testing.assert_array_equal(out["hist"], sum(ranks["inp"]["merges"]["hists"]))


def test_ka_over_two_ranks_is_the_global_batch_ka(ranks):
    """Value and each rank's rows' gradient against ``jax.value_and_grad``
    of the JAX KA on the whole batch (rtol 1e-5).  A rank's gradient is
    that of the ranks' summed objective, as for every loss of a step: each
    rank's KA is the global one, so it is twice the JAX gradient, and the
    step's average of the parameter gradients over the ranks divides the
    world size out.  The custom gather's gradient equals the library's
    autograd gather's, whose backward needs a collective."""
    import jax
    import jax.numpy as jnp

    from cat_tpu.distill.ka import ka as jka

    x, y = ranks["inp"]["ka"]["x"], ranks["inp"]["ka"]["y"]
    val, grad = jax.value_and_grad(lambda a: jka(a, jnp.asarray(y), use_pallas="no"))(
        jnp.asarray(x))
    for r, out in enumerate(_ok(ranks, "ka")):
        _close(out["value"], val, f"rank {r} KA", rtol=1e-5, atol=0)
        _close(out["grad"], 2 * _rows(np.asarray(grad), r), f"rank {r} dKA/dx", rtol=1e-5,
               atol=1e-7)
        _close(out["grad"], out["grad_library"], f"rank {r} gather routes", rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["batch", "syncbatch"])
def test_batch_norm_over_two_ranks_is_the_global_batch_norm(ranks, kind):
    """Output, input gradient and running statistics against the JAX norm
    over the whole batch."""
    import jax
    import jax.numpy as jnp

    from cat_tpu.core import config as jcfg
    from cat_tpu.ops import nn as jnn

    i = ranks["inp"]["norms"]
    m = jnn.Norm2d(jcfg.NormConfig(kind=kind, affine=True, track_running_stats=True,
                                   momentum=0.2))
    x, w = i["x"].transpose(0, 2, 3, 1), i["w"].transpose(0, 2, 3, 1)
    variables = {"params": {"scale": jnp.asarray(i["scale"]), "bias": jnp.asarray(i["bias"])},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}

    def loss(xx):
        y, new = m.apply(variables, xx, train=True, mutable=["batch_stats"])
        return (y * w).sum(), (y, new["batch_stats"])

    (_, (y, stats)), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    for r, out in enumerate(_ok(ranks, "norms")):
        o = out[kind]
        _close(o["y"].numpy().transpose(0, 2, 3, 1), _rows(np.asarray(y), r), f"rank {r} y",
               rtol=1e-5, atol=1e-5)
        _close(o["grad"].numpy().transpose(0, 2, 3, 1), _rows(np.asarray(g), r),
               f"rank {r} dx", rtol=1e-4, atol=1e-5)
        _close(o["mean"], stats["mean"], f"rank {r} running mean", rtol=1e-5, atol=1e-6)
        _close(o["var"], stats["var"], f"rank {r} running var", rtol=1e-5, atol=1e-6)


def test_inception_distill_step_over_two_ranks_matches_the_jax_step(ranks):
    """Two steps of the batch-norm KA distiller at global batch 8: every
    metric on both ranks, the student's and D's parameters and running
    statistics against the JAX single-device step."""
    import jax.numpy as jnp

    from cat_tpu_torch.utils import jax_import

    jd, jstate, tv, batches, sc, dc = ranks["ref"]["distill"]
    outs = _ok(ranks, "distill")
    for step, b in enumerate(batches):
        jstate, jm = jd.train_step(jstate, tv, {k: jnp.asarray(v) for k, v in b.items()}, LR)
        for r, out in enumerate(outs):
            assert out["metrics"][step].keys() == jm.keys()
            for k in jm:
                _close(out["metrics"][step][k], jm[k], f"rank {r} step {step + 1} {k}")
    g = jax_import.generator_state_dict(jstate.g.params["G"], sc, jstate.g.stats)
    d = jax_import.nlayer_discriminator_state_dict(jstate.d.params, dc, jstate.d.stats)
    for r, out in enumerate(outs):
        for name, got, want in (("G", out["G"], g), ("D", out["D"], d)):
            stats = [k for k in got if k.startswith("running") or ".running" in k]
            _params_close({k: v for k, v in got.items() if k not in stats},
                          {k: v for k, v in want.items() if k not in stats}, 2, f"rank {r} {name}")
            for k in stats:
                _close(got[k], want[k], f"rank {r} {name} {k}", rtol=1e-3, atol=2.5 * LR * 2)


def test_pix2pix_step_over_two_ranks_matches_the_jax_step(ranks):
    import jax.numpy as jnp

    from cat_tpu_torch.utils import jax_import

    jtask, jstate, batches, gc, dc = ranks["ref"]["pix2pix"]
    outs = _ok(ranks, "pix2pix")
    for step, b in enumerate(batches):
        jstate, jm = jtask.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()}, LR)
        for r, out in enumerate(outs):
            assert out["metrics"][step].keys() == jm.keys()
            for k in jm:
                _close(out["metrics"][step][k], jm[k], f"rank {r} step {step + 1} {k}")
    for r, out in enumerate(outs):
        _params_close(out["G"], jax_import.generator_state_dict(jstate.g.params, gc), 2,
                      f"rank {r} G")
        _params_close(out["D"], jax_import.nlayer_discriminator_state_dict(jstate.d.params, dc),
                      2, f"rank {r} D")


def test_spade_distill_step_over_two_ranks_matches_the_jax_step(ranks):
    """One KA step of the syncbatch SPADE distiller at one row a rank (a
    global KA of 2 rows, where each rank's own would be the constant 1):
    metrics, and the state against the JAX distiller's at
    tests/test_torch_spade_distill.py's bounds.  One step: the second's
    losses move with Adam's ±lr on near-zero gradients (D's first-conv
    biases, whose sum of the fake and the real term nearly cancels), which
    the ranks' two partial sums round differently from one sum."""
    from cat_tpu_torch.train.common import load_train_state_dict
    from tests.test_torch_spade_distill import _compare_states

    jsd, jstate, tv, tdist, tstate, jbatches = ranks["ref"]["spade"]
    outs = _ok(ranks, "spade")
    for step, jb in enumerate(jbatches):
        jstate, jm = jsd.train_step(jstate, tv, jb, LR)
        for r, out in enumerate(outs):
            assert out["metrics"][step].keys() == jm.keys()
            for k in jm:
                _close(out["metrics"][step][k], jm[k], f"rank {r} step {step + 1} {k}")
    for r, out in enumerate(outs):
        load_train_state_dict(tstate, out["state"])
        _compare_states(jstate, tstate, tdist, ranks["root"], len(jbatches))


@pytest.mark.parametrize("policy", ["", "dots_saveable"])
def test_spade_remat_over_two_ranks_equals_no_remat(ranks, policy):
    """--remat 1 (and a selective policy) over two ranks: the recompute in
    the backward runs the batch-norm sums' all-reduces again, in the same
    order on both ranks; the step equals the one without remat."""
    want = _ok(ranks, "spade")
    for r, out in enumerate(_ok(ranks, "spade_remat")):
        got = out[policy]
        for k, v in want[r]["metrics"][0].items():
            _close(got["metrics"][0][k], v, f"rank {r} {k}", rtol=1e-6, atol=1e-7)
        for net in ("g", "d"):
            for k, v in want[r]["state"][net]["params"].items():
                _close(got["state"][net]["params"][k], v, f"rank {r} {net} {k}", rtol=1e-6,
                       atol=1e-7)


def test_cyclegan_step_over_two_ranks_equals_one_process(ranks):
    """Three wgangp steps with dropout, a batch-norm D and a pool of 3 (it
    fills in step 1 and swaps after): the losses within 1e-5, the pools'
    images and counts, and the parameters within Adam's bound, against the
    port's world of one."""
    want = ranks["world1"]["cyclegan"]
    for r, out in enumerate(_ok(ranks, "cyclegan")):
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


def test_fid_and_miou_over_two_ranks_equal_one_process(ranks):
    """Two ranks sweep 2 and 1 of the 3 val batches: FID to 1e-3 relative,
    mIoU exactly; only the primary dumps."""
    want = ranks["world1"]["eval"]
    for r, out in enumerate(_ok(ranks, "eval")):
        assert out["fid"].keys() == want["fid"].keys()
        _close(out["fid"]["metric/fid"], want["fid"]["metric/fid"], f"rank {r} FID", rtol=1e-3,
               atol=0)
        assert out["miou"] == want["miou"]
    dumps = sorted(os.listdir(ranks["root"] / "ev2" / "eval" / "0" / "fake"))
    assert len(dumps) == 3  # rank 0's batches 0 and 2: 2 + 1 pairs


def test_loader_slices_equal_the_jax_process_shard(tmp_path):
    """Rank r's slice of every global batch of 4 (two aligned epochs, no
    random draws) equals the JAX package's ``process_shard=(r, 2)``
    loader's; with random crops and flips the ranks' slices join into the
    one-process batch; a global batch that 2 does not divide raises in
    both."""
    from PIL import Image

    from cat_tpu.data import datasets as jds
    from cat_tpu.data import transforms as jtf
    from cat_tpu_torch.data import datasets as tds
    from cat_tpu_torch.data import transforms as ttf

    rs = np.random.RandomState(0)
    os.makedirs(tmp_path / "train")
    for i in range(8):
        Image.fromarray(rs.randint(0, 256, (36, 72, 3), dtype=np.uint8)).save(
            tmp_path / "train" / f"{i}.png")
    fixed = dict(load_size=36, crop_size=36, no_flip=True)
    for r in (0, 1):
        jl = jds.create_dataloader("aligned", str(tmp_path), 4, jtf.TransformSpec(**fixed),
                                   seed=5, num_workers=0, process_shard=(r, 2))
        tl = tds.create_dataloader("aligned", str(tmp_path), 4, ttf.TransformSpec(**fixed),
                                   seed=5, num_workers=2, process_shard=(r, 2))
        for _ in range(2):
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl) == 2
            for g, w in zip(got, want):
                assert g["A_paths"] == w["A_paths"]
                np.testing.assert_array_equal(g["A"].numpy(), np.asarray(w["A"]).transpose(
                    0, 3, 1, 2))
    spec = ttf.TransformSpec(load_size=40, crop_size=32)
    whole = list(tds.create_dataloader("aligned", str(tmp_path), 4, spec, seed=5, num_workers=0))
    parts = [list(tds.create_dataloader("aligned", str(tmp_path), 4, spec, seed=5,
                                        num_workers=w, process_shard=(r, 2)))
             for r, w in ((0, 0), (1, 2))]
    for b, p0, p1 in zip(whole, *parts):
        assert torch.equal(b["A"], torch.cat([p0["A"], p1["A"]]))
        assert torch.equal(b["B"], torch.cat([p0["B"], p1["B"]]))
    for make, spec_ in ((jds.create_dataloader, jtf.TransformSpec(**fixed)),
                        (tds.create_dataloader, ttf.TransformSpec(**fixed))):
        with pytest.raises(ValueError, match="global batch 3 not divisible by 2 processes"):
            make("aligned", str(tmp_path), 3, spec_, process_shard=(0, 2))


def test_one_process_runs_no_collective():
    """Without a process group the step's collectives return their input."""
    import torch.distributed as dist

    from cat_tpu_torch.parallel import collectives, multihost

    assert not dist.is_initialized()
    x = torch.randn(3, 2)
    assert collectives.all_gather_rows(x) is x and collectives.all_reduce_sum(x) is x
    assert collectives.local_rows(x) is x and collectives.world() == (0, 1)
    assert multihost.process_shard() == (0, 1) and multihost.is_primary()
    assert json.loads(json.dumps(collectives.global_rows(5))) == 5
