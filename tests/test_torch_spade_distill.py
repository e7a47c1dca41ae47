"""SPADE distillation in the port against the JAX package (CPU, float32,
ngf 16 teacher, 64 x 32, batch 2, inputs made with numpy from a seed):
``SPADEDistiller.train_step`` after 1 and 3 steps under KA (with VGG) and
under MSE (the adaptors), and the forwards that may write the running
statistics and D's ``u``.  One step under wgangp with EMA is in
tests/test_torch_spade_distill_verb.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.core import spade_config as jsc
from cat_tpu.distill import spade_distiller as jsd
from cat_tpu.models import vgg as jvgg
from cat_tpu.utils import checkpoint as jckpt
from cat_tpu_torch.distill import ka as tka
from cat_tpu_torch.distill import spade_distiller as tsd
from cat_tpu_torch.models import vgg as tvgg
from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init
from tests.test_torch_spade import H, W, _close, _labels, nchw, nhwc, to_port

torch.set_num_threads(1)

LR = 2e-4


def _cfgs():
    """Teacher ngf 16, student ngf 8 (3 labels + dontcare + edges, one
    kernel size: the JAX step's XLA compile dominates), spectral multiscale
    D."""
    kw = dict(semantic_nc=5, channels_reduction_factor=8, kernel_sizes=(3,),
              num_upsampling_layers="normal", crop_size=W, aspect_ratio=2.0)
    return (jsc.SPADEGeneratorConfig.make(ngf=16, **kw),
            jsc.SPADEGeneratorConfig.make(ngf=8, **kw),
            jsc.MultiscaleDiscriminatorConfig(input_nc=8, ndf=8, n_layers=3, num_D=2))


def _batch(rng):
    label, inst = _labels(rng)
    image = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    return ({"label": jnp.asarray(label), "instance": jnp.asarray(inst),
             "image": jnp.asarray(image)},
            {"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
             "image": nchw(image)})


def _worlds(tmp_path, vgg_sd=None, **hp):
    """The JAX distiller and its state (``fast_init`` weights, the teacher's
    running statistics moved), and the port's distiller on the same weights,
    its state carried from the JAX state's ``.msgpack``."""
    from cat_tpu.train.common import GANTrainState, NetState

    tcfg, scfg, dcfg = _cfgs()
    jvgg_vars = None if vgg_sd is None else jvgg.convert_torch_vgg19(
        {k: v.numpy() for k, v in vgg_sd.items()})
    jhp = jsd.SPADEDistillHParams(**hp)
    jdist = jsd.SPADEDistiller(tcfg, scfg, dcfg, jhp, vgg_variables=jvgg_vars)
    jdist.label_nc, jdist.contain_dontcare = 3, True
    rs = np.random.RandomState(7)
    tv = fast_init(jdist.netG_teacher, jnp.zeros((1, H, W, 5)), seed=1)
    tv = {**tv, "batch_stats": jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.uniform(0.5, 1.5, x.shape) if p[-1].key == "var"
                                 else rs.randn(*x.shape) * 0.1, jnp.float32),
        tv["batch_stats"])}
    sv = fast_init(jdist.netG_student, jnp.zeros((1, H, W, 5)), seed=2)
    dv = fast_init(jdist.netD, jnp.zeros((1, H, W, 8)), seed=3)
    widths = [(jsd._tap_width(scfg, n), jsd._tap_width(tcfg, n)) for n in jhp.mapping_layers]
    group = {"G": sv["params"], "A": {
        f"A{i}": fast_init(jsd._Adaptor(ft), jnp.zeros((1, 2, 2, fs)), seed=4 + i)["params"]
        for i, (fs, ft) in enumerate(widths)}}
    opt_init = jax.jit(jdist.tx.init)
    jstate = GANTrainState(
        step=jnp.zeros((), jnp.int32),
        g=NetState(group, opt_init(group), {k: v for k, v in sv.items() if k != "params"}),
        d=NetState(dv["params"], opt_init(dv["params"]),
                   {k: v for k, v in dv.items() if k != "params"}),
        rng=jax.random.PRNGKey(0),
        extra={"ema_G": jax.tree.map(jnp.copy, sv["params"])} if jhp.ema_decay > 0 else None)

    vgg = None
    if vgg_sd is not None:
        vgg = tvgg.VGG19Features()
        vgg.load_state_dict(vgg_sd)
    fields = {f.name for f in dataclasses.fields(tsd.SPADEDistillHParams)}
    dist = tsd.SPADEDistiller(to_port(tcfg), to_port(scfg), to_port(dcfg),
                              tsd.SPADEDistillHParams(**{k: v for k, v in hp.items()
                                                         if k in fields}),
                              vgg=vgg, input_nc=3, contain_dontcare=True, device="cpu")
    t_sd = jax_import.spade_generator_state_dict(
        tv["params"], dist.teacher_cfg, {k: v for k, v in tv.items() if k != "params"})
    state, teacher_params = dist.init_state(t_sd, seed=5)
    load_train_state_dict(state, _carried(jstate, dist, tmp_path))
    return jdist, jstate, tv, dist, state, teacher_params


def _carried(jstate, dist, tmp_path):
    path = jckpt.save_train_state(str(tmp_path), "carry", jstate)
    return jax_import.spade_distill_state_dict(ckpt.load_pytree(path), dist.student_cfg,
                                               dist.disc_cfg)


def _compare_states(jstate, state, dist, tmp_path, step):
    """Parameters within 2.5·lr·steps at each group's TTUR rate (the bound
    of tests/test_torch_spade.py: Adam turns float32 noise on near-zero
    gradients into full steps); the running statistics and D's ``u``
    (weight_v is informational) at rtol 1e-4 after step 1, within the
    parameters' drift after."""
    want, got = _carried(jstate, dist, tmp_path), train_state_dict(state)
    mult_g, mult_d = dist.lr_mults
    for net, group, lr in (("g", "params", LR * mult_g), ("d", "params", LR * mult_d)):
        assert got[net][group].keys() == want[net][group].keys()
        worst = max(float((v.detach() - want[net][group][k]).abs().max())
                    for k, v in got[net][group].items())
        assert worst <= 2.5 * lr * step, (net, step, worst)
    worst = max(float((v.detach() - want["adaptors"][k]).abs().max())
                for k, v in got["adaptors"].items())
    assert worst <= 2.5 * LR * mult_g * step, ("adaptors", step, worst)
    tol = dict(rtol=1e-4, atol=1e-6) if step == 1 else dict(rtol=1e-3, atol=2.5 * LR * step)
    for net in ("g", "d"):
        assert got[net]["stats"].keys() == want[net]["stats"].keys()
        for k, v in got[net]["stats"].items():
            if not k.endswith("weight_v"):
                _close(v, want[net]["stats"][k], f"step {step} {net} {k}", **tol)
    return want, got


def _check_eval(jdist, jstate, dist, state, jbatch, tbatch, tmp_path):
    """The student's eval output (the EMA weights where kept): as the JAX
    distiller's within 5% of its largest value after the steps (xavier at
    gain 0.02 makes weights of ~1e-3, and the first Adam steps move each by
    lr·sign(gradient), whose sign float32 noise flips on near-zero
    gradients), and at rtol 1e-4 once the JAX state is loaded into the
    port's."""
    want = np.asarray(jdist.generate_student_raw(jstate, jbatch))
    _close(nhwc(dist.generate_student_raw(state, tbatch)), want, "generate_student_raw",
           rtol=0, atol=0.05 * np.abs(want).max())
    load_train_state_dict(state, _carried(jstate, dist, tmp_path))
    _close(nhwc(dist.generate_student_raw(state, tbatch)), want,
           "generate_student_raw from the JAX state", rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("loss", ["ka", "mse"])
def test_spade_distiller_steps_match_jax(rng, tmp_path, loss):
    """KA (with the VGG loss) and MSE: the losses and the three distill
    parts after 1 and 3 steps at rtol 1e-4, the parameters, adaptors,
    running statistics and ``u`` against the JAX distiller's, and the
    student's eval output; the KA adaptors keep their values (zero
    gradient); the port's KA runs its Gram through ``ka.gram`` (the plain
    version on the CPU), twice a tap."""
    vgg_sd = tvgg.random_vgg19_state_dict(seed=4) if loss == "ka" else None
    jdist, jstate, tv, dist, state, tparams = _worlds(
        tmp_path, vgg_sd, distill_loss_type=loss, lambda_vgg=10.0 if loss == "ka" else 0.0)
    a0 = {k: v.clone() for k, v in state.adaptors.items()}
    jbatch, tbatch = _batch(rng)
    calls = []
    gram = tka.gram
    tka.gram = lambda x: calls.append(x.shape) or gram(x)
    try:
        for step in range(1, 4):
            jstate, jm = jdist.train_step(jstate, tv, jbatch, LR)
            state, tm = dist.train_step(state, tparams, tbatch, LR)
            assert tm.keys() == jm.keys()
            assert {f"Specific_loss/distill{i}" for i in range(3)} <= set(tm)
            for k in jm:
                _close(float(tm[k]), float(jm[k]), f"step {step} {k}", rtol=1e-4, atol=1e-6)
            if step in (1, 3):
                _compare_states(jstate, state, dist, tmp_path, step)
    finally:
        tka.gram = gram
    assert len(calls) == (6 * 3 if loss == "ka" else 0)
    if loss == "ka":
        assert all(torch.equal(v, a0[k]) for k, v in state.adaptors.items())
        assert float(tm["G_loss/vgg"]) > 0
    else:
        assert not any(torch.equal(v, a0[k]) for k, v in state.adaptors.items())
    _check_eval(jdist, jstate, dist, state, jbatch, tbatch, tmp_path)
    _close(nhwc(dist.generate_teacher_raw(tparams, tbatch)),
           jdist.generate_teacher_raw(tv, jbatch), "generate_teacher_raw", rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spectral", [False, True])
def test_spade_distiller_writes_state_only_where_the_jax_distiller_does(rng, spectral):
    """One step, replayed by hand on copies: the student's running statistics
    (and, with spectral blocks, its ``u``) are those of the G step's forward
    alone (the D step's train-mode regeneration writes none), D's ``u`` that
    of the D step's one writing forward.  With ``remat`` the step's losses
    and state are the same."""
    tcfg, scfg, dcfg = _cfgs()
    scfg = dataclasses.replace(scfg, blocks=tuple(dataclasses.replace(b, spectral=spectral)
                                                  for b in scfg.blocks))

    def make(remat, teacher_sd=None, student_sd=None, disc_sd=None):
        dist = tsd.SPADEDistiller(to_port(tcfg), to_port(scfg), to_port(dcfg),
                                  tsd.SPADEDistillHParams(remat=remat, lambda_vgg=0.0),
                                  input_nc=3, contain_dontcare=True, device="cpu")
        if teacher_sd is None:
            from cat_tpu_torch.models.spade import SPADEGenerator

            teacher_sd = SPADEGenerator(to_port(tcfg), generator=torch.Generator()
                                        .manual_seed(1)).state_dict()
        return (dist, *dist.init_state(teacher_sd, student_sd, disc_sd, seed=2)), teacher_sd

    (dist, state, tparams), t_sd = make(False)
    g0, d0 = copy.deepcopy(dist.netG_student), copy.deepcopy(dist.netD)
    (rdist, rstate, rtparams), _ = make(True, t_sd, g0.state_dict(), d0.state_dict())
    _, tbatch = _batch(rng)
    _, m = dist.train_step(state, tparams, tbatch, LR)
    _, rm = rdist.train_step(rstate, rtparams, tbatch, LR)
    for k in m:
        _close(float(rm[k]), float(m[k]), k, rtol=1e-5, atol=1e-7)
    for a, b in ((rdist.netG_student, dist.netG_student), (rdist.netD, dist.netD)):
        for k, v in a.state_dict().items():
            _close(v, b.state_dict()[k], k, rtol=1e-5, atol=1e-6)
    sem = dist.semantics(tbatch)
    with torch.no_grad():
        g0(sem, train=True)  # the G step's forward, on the old weights
        d0(torch.cat([sem, tbatch["image"]], 1), train=True)  # one power iteration
    for net, ref in ((dist.netG_student, g0), (dist.netD, d0)):
        bufs = dict(ref.named_buffers())
        assert bufs
        for k, v in bufs.items():
            torch.testing.assert_close(net.get_buffer(k), v, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# --remat_policy: selective rematerialisation of the student forward
# ---------------------------------------------------------------------------


def _recording(state):
    """The G group's gradients of every step, recorded as its Adam takes them."""
    grads, step = [], state.g.opt.step

    def record(g, lr):
        grads.append([x.clone() for x in g])
        return step(g, lr)

    state.g.opt.step = record
    return grads


@pytest.mark.parametrize("policy", sorted(tsd.REMAT_POLICIES))
def test_remat_policy_steps_match_no_remat_and_jax(rng, tmp_path, policy):
    """Two KA steps under ``remat`` with each supported
    ``jax.checkpoint_policies`` name: the losses, the G group's gradients
    and the running statistics of the same steps without remat from the
    same state, and the JAX distiller's under the same policy at this
    file's tolerances."""
    jdist, jstate, tv, dist, state, tparams = _worlds(tmp_path, lambda_vgg=0.0, remat=True,
                                                      remat_policy=policy)
    assert dist.hp.remat and dist.hp.remat_policy == policy
    plain = tsd.SPADEDistiller(dist.teacher_cfg, dist.student_cfg, dist.disc_cfg,
                               dataclasses.replace(dist.hp, remat=False, remat_policy=""),
                               input_nc=3, contain_dontcare=True, device="cpu")
    pstate, ptparams = plain.init_state(dist.netG_teacher.state_dict(), seed=5)
    load_train_state_dict(pstate, train_state_dict(state))
    grads, pgrads = _recording(state), _recording(pstate)
    jbatch, tbatch = _batch(rng)
    for step in (1, 2):
        jstate, jm = jdist.train_step(jstate, tv, jbatch, LR)
        state, tm = dist.train_step(state, tparams, tbatch, LR)
        pstate, pm = plain.train_step(pstate, ptparams, tbatch, LR)
        for k in jm:
            _close(float(tm[k]), float(pm[k]), f"step {step} {k}, no remat", rtol=1e-6, atol=1e-9)
            _close(float(tm[k]), float(jm[k]), f"step {step} {k}, JAX", rtol=1e-4, atol=1e-6)
        for g, p in zip(grads[-1], pgrads[-1]):
            _close(g, p, f"step {step} gradient", rtol=1e-5,
                   atol=1e-9 + 1e-6 * float(p.abs().max()))
        for k, v in state.g.stats.items():
            _close(v, pstate.g.stats[k], f"step {step} {k}", rtol=1e-6, atol=1e-9)
        _compare_states(jstate, state, dist, tmp_path, step)


@pytest.mark.parametrize("name", ["save_only_these_names", "offload_dot_with_no_batch_dims",
                                  "save_from_both_policies", "dots_savable"])
def test_remat_policy_refuses_factory_and_unknown_names(name):
    """A policy that takes arguments, or an unknown name, raises a
    ``ValueError`` listing the supported names under ``remat``; without it
    the name is not read, as in the JAX package."""
    tcfg, scfg, dcfg = (to_port(c) for c in _cfgs())
    with pytest.raises(ValueError, match="supported names are .*dots_saveable"):
        tsd.SPADEDistiller(tcfg, scfg, dcfg, tsd.SPADEDistillHParams(remat=True, remat_policy=name),
                           device="cpu")
    assert tsd.SPADEDistiller(tcfg, scfg, dcfg, tsd.SPADEDistillHParams(remat_policy=name),
                              device="cpu").policy is None


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_selective_checkpoint_replays_dropout_and_reads_saved_dots(policy):
    """``train/common.py::checkpointed`` under a policy: the recompute draws
    the first pass's dropout mask (the RNG rewound outside the selective
    context) and gives the plain forward's output and gradients; under a
    dots policy the backward runs two matmuls fewer (the saved forward
    ones)."""
    from cat_tpu_torch import import_stdlib_profile

    import_stdlib_profile()  # the flop counter reaches TorchDynamo
    from torch.utils.flop_counter import FlopCounterMode

    from cat_tpu_torch.models.blocks import dropout
    from cat_tpu_torch.train.common import checkpointed

    net = torch.nn.Linear(16, 16)
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    rng = torch.Generator()

    def fn():
        return dropout(torch.tanh(net(x)) @ net.weight, 0.5, True, rng)

    outs, grads, flops = [], [], []
    for remat in (False, True):
        rng.manual_seed(1)
        y = checkpointed(fn, net, rng, tsd.remat_policy(policy)) if remat else fn()
        counter = FlopCounterMode(display=False)
        with counter:
            grads.append(torch.autograd.grad(y.square().sum(), list(net.parameters())))
        outs.append(y.detach())
        flops.append(counter.get_total_flops())
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    saved = 2 * 8 * 16 * 16 * 2  # the forward's addmm and mm, recomputed or not
    assert flops[1] - flops[0] == (0 if policy == "dots_saveable" else saved)
