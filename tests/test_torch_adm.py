"""ADM's diffusion UNet (``cat_tpu_torch/models/adm.py``) and its KA
distillation under ``GenericDistiller``, against the benchmark's plain
float32 reference (``benchmark/reference/adm_ka.py``) at the benchmark's
toy widths (``benchmark/families/adm_ka.py::tiny``), and against the
published sizes and the benchmark's frozen arithmetic
(``benchmark/yardstick/adm.py``).

Tolerances: the program and the reference compute the same float32
arithmetic in another order (ATen's GroupNorm against its formula, SDPA
against an explicit softmax, cuDNN-free CPU convs in both), so outputs
agree to float32 round-off carried through ~40 layers; each bound below
is ~100x the gap seen on this CPU and ~100x under what a wrong layer gives.
"""

from __future__ import annotations

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from benchmark import compare
from benchmark.families import adm_ka
from benchmark.families.common import seeded_weights
from benchmark.reference import adm_ka as ref
from benchmark.yardstick import adm as yard
from cat_tpu_torch import import_stdlib_profile
from cat_tpu_torch.distill.generic import GenericDistiller, GenericDistillHParams
from cat_tpu_torch.models.adm import (ADMConfig, ADMUNet, AttentionBlock, attention_sites,
                                      group_norm_sites, timestep_embedding)
from cat_tpu_torch.utils import trace

# FlopCounterMode, sdpa_kernel and torch.profiler load TorchDynamo, which
# imports ``profile``: the standard library's, not this repository's root script
import_stdlib_profile()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(REPO, "benchmark", "configs", "adm256_palette.json")))
TINY, TRAFFIC = adm_ka.tiny(CONFIG)
SEED = 2 ** 31 + 77


def _spec(width: int) -> dict:
    return adm_ka.net(TINY, width)


def _config(spec: dict) -> ADMConfig:
    return ADMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec.items()})


def _net(spec: dict, seed: int):
    """A program UNet and its seeded weights (the reference's layout)."""
    shapes = ref.shapes(spec)
    p = seeded_weights(shapes, torch.Generator().manual_seed(seed), "cpu", False,
                       ref.stds(shapes))
    net = ADMUNet(_config(spec))
    net.load_state_dict(p)
    return net, p


def _batch(seed: int):
    return adm_ka.bank(TINY, {**TRAFFIC, "bank": 1}, 2, torch.Generator().manual_seed(seed),
                       "cpu")[0]


def test_forward_and_taps_match_the_reference():
    spec = _spec(TINY["teacher_model_channels"])
    net, p = _net(spec, SEED)
    x, t = _batch(SEED)
    with torch.no_grad():
        eps, acts = net(x, t, taps=TINY["taps"])
        r_eps, r_acts = ref.unet(p, spec, x, t, TINY["taps"])
    assert eps.shape == (2, 3, 32, 32) and eps.std() > 0.1
    # float32 round-off through the blocks: gaps ~1e-6 of the values' scale
    torch.testing.assert_close(eps, r_eps, rtol=1e-4, atol=1e-4 * float(r_eps.abs().max()))
    assert list(acts) == TINY["taps"]
    for k in TINY["taps"]:
        torch.testing.assert_close(acts[k], r_acts[k], rtol=1e-4,
                                   atol=1e-4 * float(r_acts[k].abs().max()))
    assert torch.equal(net(x, t), eps)  # no taps asked: ε alone


def test_three_distill_steps_match_the_reference():
    """Three ``GenericDistiller`` KA steps, the benchmark cell's set-up at
    toy widths: losses, first gradients (Adam's first moment) and the
    change of every leaf against the reference's."""
    cell = adm_ka.setup(TINY, TRAFFIC, SEED, torch.device("cpu"))
    r = cell.reference()
    assert r["student_arch"] == 0.0
    for prog, mine in zip(cell.record["losses"], r["losses"]):
        assert set(prog) == set(mine) and len(prog) == 2 + len(TINY["taps"])
        for k, v in mine.items():
            # float32 sums of ~1e4 terms: relative round-off ~1e-6
            assert prog[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    keep = list(r["first_grad"])
    grad = compare.leaf_gaps(cell.record["first_grad"], r["first_grad"], keep)
    assert max(grad.values()) < 1e-4, compare.worst_leaves(cell.record["first_grad"],
                                                           r["first_grad"], keep)
    # Adam moves each element by ~lr whatever its gradient's size, so a leaf
    # whose gradient is round-off (under a thousandth of the median) moves by
    # round-off: those are left out, as the benchmark's comparison does
    moving = compare.moving_leaves(r["first_grad"])
    change = compare.leaf_gaps(cell.record["change"], r["change"], moving)
    assert len(moving) > 0.9 * len(keep)
    assert max(change.values()) < 1e-2 and sorted(change.values())[len(change) // 2] < 1e-5


def test_timestep_embedding_is_cos_then_sin():
    t = torch.tensor([0, 1, 999])
    emb = timestep_embedding(t, 8)
    freqs = [math.exp(-math.log(1e4) * i / 4) for i in range(4)]
    want = [[math.cos(s * f) for f in freqs] + [math.sin(s * f) for f in freqs]
            for s in (0, 1, 999)]
    assert emb.dtype == torch.float32
    # float32 arguments near 999 carry an ulp of 6e-5: the sines and cosines too
    torch.testing.assert_close(emb, torch.tensor(want), rtol=0, atol=1e-4)
    torch.testing.assert_close(emb, ref.timestep_embedding(t, 8))
    assert emb[0, :4].eq(1).all() and emb[0, 4:].eq(0).all()  # t = 0: cos 1, sin 0


def test_attention_legacy_layout_with_heads():
    """Four heads: qkv is read as (B·heads, 3d, T), each head's channels
    [q; k; v] in turn; a loop over the heads in that layout, the
    reference's explicit softmax and the program's block agree."""
    torch.manual_seed(3)
    block = AttentionBlock(64, heads=4)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(2, 64, 4, 4)
    with torch.no_grad():
        got = block(x)
        xf = x.reshape(2, 64, 16)
        qkv = block.qkv(block.norm(xf))
        by_head = []
        for b in range(2):
            heads = []
            for h in range(4):
                q, k, v = qkv[b, h * 48:(h + 1) * 48].split(16)
                w = torch.softmax(q.T @ k / math.sqrt(16), dim=-1)  # (T, S)
                heads.append(v @ w.T)  # (d, T)
            by_head.append(torch.cat(heads))
        loop = xf + block.proj_out(torch.stack(by_head))
        plain = xf + block.proj_out(ref.attention(qkv, 4))
    torch.testing.assert_close(got, loop.reshape(x.shape), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, plain.reshape(x.shape), rtol=1e-5, atol=1e-5)
    # another split of the channels (q, k, v each whole, then heads) differs
    q, k, v = qkv.reshape(2, 3, 4, 16, 16).unbind(1)
    other = F.scaled_dot_product_attention(q.transpose(2, 3), k.transpose(2, 3),
                                           v.transpose(2, 3)).transpose(2, 3).reshape(2, 64, 16)
    assert not torch.allclose(xf + block.proj_out(other), loop, atol=1e-3)


def test_bf16_step_runs_every_conv_and_linear_in_bf16(monkeypatch):
    """Under compute_dtype bfloat16 every conv's and linear's operands are
    bf16 (the float32 timestep embedding does not promote the forward);
    GroupNorm computes in float32."""
    seen = {"conv": set(), "linear": set(), "group_norm": set(), "sdpa": set()}

    def spy(kind, fn):
        def call(*args, **kwargs):
            seen[kind].update(a.dtype for a in args[:3] if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        return call

    for name, kind in (("conv1d", "conv"), ("conv2d", "conv"), ("linear", "linear"),
                       ("group_norm", "group_norm"), ("scaled_dot_product_attention", "sdpa")):
        monkeypatch.setattr(F, name, spy(kind, getattr(F, name)))
    t_spec, s_spec = _spec(64), _spec(32)
    teacher, _ = _net(t_spec, 1)
    student, _ = _net(s_spec, 2)
    hp = GenericDistillHParams(mapping_layers=tuple(TINY["taps"]), compute_dtype="bfloat16",
                               recon_loss_type="l2")
    dist = GenericDistiller(teacher, student, {}, {}, hp, device="cpu")
    state, tparams = dist.init_state(0)
    state, m = dist.train_step(state, tparams, _batch(4), 1e-4)
    assert seen["conv"] == seen["linear"] == seen["sdpa"] == {torch.bfloat16}
    assert seen["group_norm"] == {torch.float32}
    assert all(math.isfinite(float(v)) for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.params.values())


def _stored_channels_innermost(x: torch.Tensor) -> bool:
    """channels_last-contiguous: a 4-D tensor's ``channels_last``, a 3-D
    (N, C, T) view's storage (N, T, C)."""
    return x.movedim(1, -1).is_contiguous()


def test_distill_step_keeps_every_activation_channels_last(monkeypatch):
    """A tiny bf16 ``GenericDistiller`` step: every conv2d input and every
    GroupNorm input of both nets is channels_last-contiguous (the attention
    norms' (N, C, T) views stored (N, T, C)), most of them not trivially
    (more than one pixel); the taps come back channels-last with the
    published (N, C, H, W) shapes."""
    from cat_tpu_torch.models import adm

    seen = {"conv2d": [], "group_norm": []}

    def spy(kind, fn):
        def call(x, *args, **kwargs):
            seen[kind].append((_stored_channels_innermost(x), x[0, 0].numel() > 1))
            return fn(x, *args, **kwargs)
        return call

    monkeypatch.setattr(F, "conv2d", spy("conv2d", F.conv2d))
    monkeypatch.setattr(adm, "group_norm_act", spy("group_norm", adm.group_norm_act))
    teacher, _ = _net(_spec(64), 1)
    student, _ = _net(_spec(32), 2)
    hp = GenericDistillHParams(mapping_layers=tuple(TINY["taps"]), compute_dtype="bfloat16",
                               recon_loss_type="l2")
    dist = GenericDistiller(teacher, student, {}, {}, hp, device="cpu")
    state, tparams = dist.init_state(0)
    dist.train_step(state, tparams, _batch(4), 1e-4)
    convs = sum(1 for name, m in teacher.named_modules() if isinstance(m, torch.nn.Conv2d))
    assert len(seen["conv2d"]) == 2 * convs  # both nets' forwards
    assert len(seen["group_norm"]) == 2 * len(group_norm_sites(_config(_spec(64))))
    for kind, calls in seen.items():
        assert all(ok for ok, _ in calls), kind
        assert sum(wide for _, wide in calls) > 0.8 * len(calls), kind
    x, t = _batch(5)
    with torch.no_grad():
        eps, acts = teacher(x, t, taps=TINY["taps"])
    assert eps.shape == x[:, :3].shape and _stored_channels_innermost(eps)
    widths = teacher.cfg.tap_widths()
    for k, a in acts.items():
        assert a.shape[:2] == (2, widths[k]) and a.is_contiguous(memory_format=torch.channels_last)


def test_bf16_step_keeps_the_norms_float32_and_casts_the_rest_flat():
    """Under bf16 the GroupNorms' γ and β reach ``F.group_norm`` as the
    float32 masters themselves (no cast, so an update under bf16's step is
    not lost), while every other parameter is cast by the one flat cast:
    the same bf16 values as one cast a tensor, and float32 gradients equal
    to those back through one cast a tensor."""
    from cat_tpu_torch.train.common import cast_flat, cast_floats

    student, _ = _net(_spec(32), 2)
    names = student.float32_params()
    assert len(names) == 2 * len(group_norm_sites(_config(_spec(32))))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in student.named_parameters()}
    flat = cast_flat(params, torch.bfloat16, names)
    assert list(flat) == list(params)
    for k, v in flat.items():
        if k in names:
            assert v is params[k]
        else:
            assert v.dtype == torch.bfloat16 and torch.equal(v, params[k].to(torch.bfloat16))
    x, t = _batch(4)
    twin = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    per = {k: v if k in names else v.to(torch.bfloat16) for k, v in twin.items()}
    grads = [torch.autograd.grad(
        torch.func.functional_call(student, p, (x.bfloat16(), t)).float().square().mean(),
        list(leaves.values())) for p, leaves in ((flat, params), (per, twin))]
    assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(*grads))
    assert cast_floats(params["out.2.weight"], torch.bfloat16).dtype == torch.bfloat16

    seen = []
    gn = F.group_norm

    def spy(x, groups, w, b, eps):
        seen.append((w, b))
        return gn(x, groups, w, b, eps)

    teacher, _ = _net(_spec(64), 1)
    hp = GenericDistillHParams(mapping_layers=tuple(TINY["taps"]), compute_dtype="bfloat16",
                               recon_loss_type="l2")
    dist = GenericDistiller(teacher, student, {}, {}, hp, device="cpu")
    state, tparams = dist.init_state(0)
    F.group_norm = spy
    try:
        dist.train_step(state, tparams, _batch(5), 1e-4)
    finally:
        F.group_norm = gn
    masters = {id(v) for v in (*state.params.values(), *tparams.values())}
    assert len(seen) == (len(names) + len(teacher.float32_params())) // 2  # a call a norm
    assert all(id(w) in masters and id(b) in masters for w, b in seen)


def test_published_sizes():
    """The README's 256x256 flags with 6 input channels: 552.8M parameters;
    the half-width student 138.3M."""
    counts = []
    for width in (256, 128):
        with torch.device("meta"):
            net = ADMUNet(_config(adm_ka.net(CONFIG, width)))
        counts.append(sum(p.numel() for p in net.parameters()))
        assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
            k: s for k, (s, _) in ref.shapes(adm_ka.net(CONFIG, width)).items()}
    assert counts == [552_814_083, 138_289_923]
    cfg = _config(adm_ka.net(CONFIG, 256))
    widths = cfg.tap_widths()
    assert [widths[k] for k in CONFIG["taps"]] == [512, 1024, 512, 256]
    assert len(attention_sites(cfg)) == 16 and len(group_norm_sites(cfg)) == 101


def test_yardstick_counts_are_the_programs():
    """``yardstick/adm.py``'s forward and training MACs equal what
    ``FlopCounterMode`` counts of the program (attention on PyTorch's
    math path, whose matmuls it counts), its attention sites and GroupNorm
    values equal the program's site lists, and the program's forward
    calls SDPA and GroupNorm at exactly those sites."""
    spec = _spec(64)
    net, _ = _net(spec, 5)
    cfg = _config(spec)
    x, t = _batch(6)
    b = x.shape[0]
    with sdpa_kernel(SDPBackend.MATH):
        with FlopCounterMode(display=False) as fwd:
            with torch.no_grad():
                net(x, t)
        with FlopCounterMode(display=False) as train:
            net(x, t).square().mean().backward()
    assert fwd.get_total_flops() == 2 * b * yard.forward_macs(spec, 32)
    assert train.get_total_flops() == 2 * b * yard.train_macs(spec, 32)
    assert yard.attention_sites(spec, 32) == [s[1:] for s in attention_sites(cfg)]
    assert yard.group_norm_values(spec, 32) == [c * s * s for _, c, s in group_norm_sites(cfg)]

    calls = {"sdpa": [], "gn": []}
    sdpa, gn = F.scaled_dot_product_attention, F.group_norm

    def spy_sdpa(q, k, v, **kw):
        calls["sdpa"].append(tuple(q.shape))
        return sdpa(q, k, v, **kw)

    def spy_gn(x, groups, *args, **kw):
        calls["gn"].append(x[0].numel())
        return gn(x, groups, *args, **kw)

    F.scaled_dot_product_attention, F.group_norm = spy_sdpa, spy_gn
    try:
        with torch.no_grad():
            net(x, t)
    finally:
        F.scaled_dot_product_attention, F.group_norm = sdpa, gn
    assert calls["sdpa"] == [(b, h, n, d) for h, n, d in yard.attention_sites(spec, 32)]
    assert calls["gn"] == yard.group_norm_values(spec, 32)


def test_regions_lie_in_the_forward_phases():
    """Under a recording profiler the UNet's attention regions (host-only
    ``record_function`` spans) lie inside ``GenericDistiller``'s forward
    phases, one a block in each net (the phases' order:
    ``tests/test_torch_trace.py``), and no GroupNorm has one; with no
    profiler ``region`` is the shared no-op."""
    from torch.profiler import ProfilerActivity, profile

    assert trace.region("adm.attention") is trace.span("x") is trace._OFF
    teacher, _ = _net(_spec(64), 7)
    student, _ = _net(_spec(32), 8)
    hp = GenericDistillHParams(mapping_layers=tuple(TINY["taps"]), recon_loss_type="l2")
    dist = GenericDistiller(teacher, student, {}, {}, hp, device="cpu")
    state, tparams = dist.init_state(0)
    batch = _batch(9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(trace.region("r"), torch.autograd.profiler.record_function)
        dist.train_step(state, tparams, batch, 1e-4)
    events = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
              if e.name.startswith(("step.", "adm."))]
    forward = [(s, e) for s, e, n in events if n in ("step.teacher_fwd", "step.student_fwd")]
    regions = [(s, e, n) for s, e, n in events if n.startswith("adm.")]
    cfg = _config(_spec(64))
    assert sum(n == "adm.attention" for _, _, n in regions) == 2 * len(attention_sites(cfg))
    assert {n for _, _, n in regions} == {"adm.attention"}
    assert len(forward) == 2
    assert all(any(fs <= s and e <= fe for fs, fe in forward) for s, e, _ in regions)
