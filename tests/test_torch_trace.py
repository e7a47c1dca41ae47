"""The phase spans of the port's distillers (``cat_tpu_torch/utils/trace.py``)
on the CPU, for the inception and the SPADE distiller and ``GenericDistiller``
(on ADM's UNet) at toy widths:

  * with no profiler recording, ``span`` enters no ``record_function`` and
    launches no marker;
  * under ``torch.profiler``, one ``train_step`` emits its ``step.*``
    spans (six in a GAN's step, four in ``GenericDistiller``'s) in the order
    of its phases, none overlapping another, and they
    cover at least 95% of the step's aten op time;
  * a traced step and an untraced one from the same seed give bit-identical
    losses and parameters.
"""

import pytest
import torch

from cat_tpu_torch import import_stdlib_profile
from cat_tpu_torch.utils import trace

LR = 2e-4
ORDER = {
    "inception": ["step.teacher_fwd", "step.student_fwd", "step.d_loss_bwd", "step.adam",
                  "step.g_loss_bwd", "step.adam"],
    "spade": ["step.teacher_fwd", "step.student_fwd", "step.g_loss_bwd", "step.adam",
              "step.d_loss_bwd", "step.adam"],
    "generic": ["step.teacher_fwd", "step.student_fwd", "step.g_loss_bwd", "step.adam"],
}
# a loss each kind's step reports
LOSSES = {"inception": {"D_loss/fake", "D_loss/real", "G_loss/gan"},
          "spade": {"D_loss/fake", "D_loss/real", "G_loss/gan"},
          "generic": {"G_loss/recon", "G_loss/distill"}}


def _inception():
    from cat_tpu_torch.core.config import (InceptionGeneratorConfig, NLayerDiscriminatorConfig,
                                           NormConfig)
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.models.generator import InceptionGenerator

    norm = NormConfig(kind="instance", affine=True, track_running_stats=False)

    def cfg(ngf):
        return InceptionGeneratorConfig.make(ngf=ngf, channels_reduction_factor=2,
                                             kernel_sizes=(3,), n_blocks=3, norm=norm)

    hp = DistillHParams(dataset_mode="unaligned", gan_mode="lsgan",
                        mapping_layers=("encode", "block1"))
    dist = InceptionDistiller(cfg(8), cfg(4), NLayerDiscriminatorConfig(input_nc=3, ndf=8),
                              hp, device="cpu")
    gen = torch.Generator().manual_seed(1)
    teacher = InceptionGenerator(cfg(8), generator=gen).state_dict()
    batch = {k: torch.randn(2, 3, 32, 32, generator=gen) for k in "AB"}
    return dist, teacher, batch


def _spade():
    from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig,
                                                 SPADEGeneratorConfig)
    from cat_tpu_torch.distill.spade_distiller import SPADEDistiller, SPADEDistillHParams
    from cat_tpu_torch.models.spade import SPADEGenerator

    kw = dict(semantic_nc=5, channels_reduction_factor=8, kernel_sizes=(3,),
              num_upsampling_layers="normal", crop_size=64, aspect_ratio=2.0)
    tcfg, scfg = SPADEGeneratorConfig.make(ngf=16, **kw), SPADEGeneratorConfig.make(ngf=8, **kw)
    dcfg = MultiscaleDiscriminatorConfig(input_nc=8, ndf=8, n_layers=3, num_D=2)
    dist = SPADEDistiller(tcfg, scfg, dcfg, SPADEDistillHParams(), device="cpu")
    gen = torch.Generator().manual_seed(1)
    teacher = SPADEGenerator(tcfg, "xavier", 0.02, generator=gen).state_dict()
    labels = torch.randint(0, 5, (2, 32, 64), generator=gen)
    batch = {"semantics": torch.nn.functional.one_hot(labels, 5).permute(0, 3, 1, 2).float(),
             "image": torch.rand(2, 3, 32, 64, generator=gen) * 2 - 1}
    return dist, teacher, batch


def _generic():
    """ADM's UNet KA-distilled at half width by ``GenericDistiller``."""
    from cat_tpu_torch.distill.generic import GenericDistiller, GenericDistillHParams
    from cat_tpu_torch.models.adm import ADMConfig, ADMUNet

    torch.manual_seed(1)

    def net(width):
        return ADMUNet(ADMConfig(image_size=16, model_channels=width, channel_mult=(1, 2),
                                 attention_resolutions=(8,), num_head_channels=16))

    hp = GenericDistillHParams(mapping_layers=("input_blocks.2", "output_blocks.4"),
                               recon_loss_type="l2")
    dist = GenericDistiller(net(64), net(32), {}, {}, hp, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = (torch.randn(2, 6, 16, 16, generator=gen), torch.randint(0, 1000, (2,), generator=gen))
    return dist, None, batch


MAKE = {"inception": _inception, "spade": _spade, "generic": _generic}


def _step(kind):
    """A fresh distiller's state from seed 0, and a function running one step."""
    dist, teacher, batch = MAKE[kind]()
    if teacher is None:  # GenericDistiller holds its teacher's weights
        state, tparams = dist.init_state(seed=0)
    else:
        state, tparams = dist.init_state(teacher, seed=0)

    def step():
        _, metrics = dist.train_step(state, tparams, batch, LR)
        return metrics

    return state, step


def _profile(fn):
    import_stdlib_profile()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def _union(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def test_span_off_makes_no_record_and_no_marker(monkeypatch):
    """With no profiler recording, ``span`` touches neither the profiler's
    ``record_function`` nor the CUDA marker, even for a CUDA device."""
    def boom(*args, **kwargs):
        raise AssertionError("called with the profiler off")

    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "_sleep", boom)
    with trace.span("step.teacher_fwd", torch.device("cuda")):
        pass
    assert trace.span("step.adam", "cuda") is trace.span("step.adam")


@pytest.mark.parametrize("kind", ["inception", "spade", "generic"])
def test_train_step_off_makes_no_record_and_no_marker(kind, monkeypatch):
    """A whole step with the profiler off enters no ``record_function``."""
    _, step = _step(kind)

    def boom(*args, **kwargs):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "_sleep", boom)
    assert set(step()) >= LOSSES[kind]


def test_span_on_records_and_marks_cuda(monkeypatch):
    """Under a recording profiler a span is a ``user_annotation`` of its
    name, and a CUDA device's span launches one marker at entry and one at
    exit (here counted, as this host has no card)."""
    marks = []
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: marks.append(cycles))

    def traced():
        with trace.span("step.cpu", "cpu"):
            torch.ones(3).sum()
        with trace.span("step.cuda", torch.device("cuda", 0)):
            assert marks == [0]

    _, events = _profile(traced)
    assert marks == [0, 0]
    names = [e.name() for e in events if e.activity_type() == "user_annotation"]
    assert names == ["step.cpu", "step.cuda"]


@pytest.mark.parametrize("kind", ["inception", "spade", "generic"])
def test_train_step_spans_cover_the_step_in_order(kind):
    """One traced step: its spans in the order of the step's phases,
    disjoint, covering at least 95% of the step's aten op time."""
    _, step = _step(kind)
    _, events = _profile(step)
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                   if e.activity_type() == "user_annotation" and e.name().startswith("step."))
    assert [n for _, _, n in spans] == ORDER[kind]
    for (_, e0, _), (s1, _, _) in zip(spans, spans[1:]):
        assert e0 <= s1
    ops = _union((e.start_ns(), e.end_ns()) for e in events
                 if e.activity_type() == "cpu_op" and e.name().startswith("aten::"))
    op_ns = sum(e - s for s, e in ops)
    assert op_ns > 0
    covered = _overlap(ops, _union((s, e) for s, e, _ in spans))
    assert covered >= 0.95 * op_ns, (covered, op_ns)


@pytest.mark.parametrize("kind", ["inception", "spade", "generic"])
def test_traced_step_is_bit_identical(kind):
    """The spans change no arithmetic: a traced step and an untraced one
    from the same seed give the same losses and parameters, bit for bit."""
    state_a, step_a = _step(kind)
    state_b, step_b = _step(kind)
    plain = step_a()
    traced, _ = _profile(step_b)
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    nets = ("params",) if kind == "generic" else ("g", "d")
    for net in nets:
        a, b = (getattr(s, net) if kind == "generic" else getattr(s, net).params
                for s in (state_a, state_b))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
