"""The frozen yardstick against shapes worked by hand: operation counts,
roofline bounds, kernel groups and the trace's reduction."""

from __future__ import annotations

import math

import pytest

from benchmark.reference import inception_ka as ref
from benchmark.trace import Timeline
from benchmark.yardstick import flops, kernel_groups, roofline

TINY = {"input_nc": 3, "output_nc": 3, "ds": [4, 8, 16], "us": [8, 4],
        "blocks": [{"res": [2], "res_k": [3], "dw": [3], "dw_k": [5]},
                   {"res": [], "res_k": [], "dw": [], "dw_k": []}]}


def test_generator_convs_by_hand():
    # 16 x 16 input: stem 3->4 7x7 at 16², downs to 8² and 4², the block at 4²
    convs = flops.generator_convs(TINY, 16, 16)
    assert convs == [
        3 * 4 * 49 * 256,  # stem
        4 * 8 * 9 * 64,  # down to 8 x 8
        8 * 16 * 9 * 16,  # down to 4 x 4
        16 * 2 * 9 * 16, 2 * 16 * 9 * 16,  # res branch k 3, in and out
        16 * 3 * 16, 3 * 25 * 16, 3 * 16 * 16,  # dw branch k 5: 1x1, depthwise, 1x1
        16 * 8 * 9 * 16,  # transposed 16 -> 8, from 4 x 4
        8 * 4 * 9 * 64,  # transposed 8 -> 4, from 8 x 8
        4 * 3 * 49 * 256,  # head
    ]


def test_profile_macs_by_hand():
    # the reference convention: transposed convs at their output size, norms C·H·W
    block = 2 * 16 * 2 * 9 * 16 + 2 * 16 + (2 * 16 * 3 * 16 + 3 * 25 * 16 + 2 * 3 * 16) + 16 * 16
    want = (3 * 4 * 49 * 256 + 4 * 256 + 4 * 8 * 9 * 64 + 8 * 64 + 8 * 16 * 9 * 16 + 16 * 16
            + block + 16 * 8 * 9 * 64 + 8 * 64 + 8 * 4 * 9 * 256 + 4 * 256 + 4 * 3 * 49 * 256)
    assert flops.profile_macs(TINY, 16, 16) == want


def test_profile_macs_is_the_programs_count():
    from cat_tpu_torch.compress.profiling import profile_generator
    from cat_tpu_torch.core.config import InceptionGeneratorConfig

    cfg = InceptionGeneratorConfig.make(ngf=64, channels_reduction_factor=6, kernel_sizes=(1, 3, 5))
    arch = ref.teacher_arch(3, 3, 64, 6, [1, 3, 5], 9)
    assert flops.profile_macs(arch, 256, 256) == profile_generator(cfg, 256, 256).macs
    assert round(flops.profile_macs(arch, 256, 256) / 1e9, 2) == 43.53


def test_nlayer_convs_by_hand():
    # 256²: 128², 64², 32², then stride 1 to 31² and 30²
    assert flops.nlayer_convs(3, 64, 3, 256, 256) == [
        3 * 64 * 16 * 128 * 128, 64 * 128 * 16 * 64 * 64, 128 * 256 * 16 * 32 * 32,
        256 * 512 * 16 * 31 * 31, 512 * 16 * 30 * 30]


def test_train_macs_and_grams():
    assert flops.train_macs([10, 20], input_grad=False, weight_grad=True) == 30 + 30 + 20
    assert flops.train_macs([10, 20], input_grad=True, weight_grad=False) == 30 + 30
    assert flops.gram_flops(4, 10) == 4 * 5 * 10
    assert flops.ka_backward_flops(4, 10) == 2 * 16 * 10


def test_step_flops_composes_the_passes():
    d = {"input_nc": 3, "ndf": 8, "n_layers": 3}
    t, s = TINY, {**TINY, "ds": [2, 4, 16]}
    taps = ("encode", "block0")
    dc = flops.nlayer_convs(3, 8, 3, 16, 16)
    sc = flops.generator_convs(s, 16, 16)
    macs = (sum(flops.generator_convs(t, 16, 16)) + 3 * sum(sc) - sc[0]
            + 2 * (3 * sum(dc) - dc[0]) + 2 * sum(dc))
    grams = 2 * (2 * (2 * 3 * 256) + 2 * 2 * 2 * 256)
    assert flops.inception_ka_step_flops(t, s, d, 2, 16, 16, taps) == 2 * 2 * macs + grams


def test_roofline_bounds_by_hand():
    # bf16 Gram of (128, 2**20): 256 MiB read + 64 KiB written vs 128·129·2**20 flops
    b, f = 128, 1 << 20
    by_bytes = (b * f * 2 + b * b * 4) / 3.35e12
    by_ops = b * (b + 1) * f / 989e12
    assert roofline.gram_bound_s(b, f, "bfloat16") == pytest.approx(max(by_bytes, by_ops))
    assert roofline.gram_bound_s(16, 8192, "float32") == pytest.approx(
        max((16 * 8192 * 4 + 16 * 16 * 4) / 3.35e12, 16 * 17 * 8192 / 67e12))
    assert roofline.norm_forward_bound_s(10 ** 9, "bfloat16") == pytest.approx(4e9 / 3.35e12)
    assert roofline.norm_backward_bound_s(10 ** 9, "bfloat16") == pytest.approx(6e9 / 3.35e12)


@pytest.mark.parametrize("name,group", [
    ("void gram_partial_tma<128, true>(...)", kernel_groups.GRAM),
    ("gram_reduce", kernel_groups.GRAM),
    ("inorm_act_bwd_smem<__nv_bfloat16>", kernel_groups.NORM_BWD),
    ("inorm_bwd_channels", kernel_groups.NORM_BWD),
    ("inorm_act_smem<__nv_bfloat16, 1>", kernel_groups.NORM_FWD),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<...>", kernel_groups.TRANSPOSE),
    ("sm90_xmma_fprop_implicit_gemm_bf16", kernel_groups.CONV),
    ("void at::native::conv_depthwise2d_forward_kernel<...>", kernel_groups.CONV),
    ("void at::native::reflection_pad2d_out_kernel<c10::BFloat16>", kernel_groups.PAD),
    ("void at::native::multi_tensor_apply_kernel<...>", kernel_groups.ADAM),
    ("void at::native::reduce_kernel<512, 1, ...>", kernel_groups.REDUCTION),
    ("void at::native::elementwise_kernel<128, 2, ...>", kernel_groups.ELEMENTWISE),
    ("void at::native::CatArrayBatchedCopy<...>", kernel_groups.ELEMENTWISE),
    ("something_else", kernel_groups.OTHER),
])
def test_kernel_groups(name, group):
    assert kernel_groups.group_of(name) == group


def test_timeline_reduction():
    ms = 1_000_000
    tl = Timeline(start=0, end=100 * ms, steps=2,
                  device=[("k1", 10 * ms, 30 * ms, "kernel"), ("k2", 20 * ms, 40 * ms, "kernel"),
                          ("Memcpy HtoD", 50 * ms, 60 * ms, "gpu_memcpy"),
                          ("k1", 90 * ms, 120 * ms, "kernel")],
                  host=[("bench.step", 0, 100 * ms), ("aten::empty_strided", 40 * ms, 50 * ms)])
    assert tl.busy() == [(10 * ms, 40 * ms), (50 * ms, 60 * ms), (90 * ms, 100 * ms)]
    assert tl.busy_s() == pytest.approx(0.05)
    assert tl.gaps() == [(0, 10 * ms), (40 * ms, 50 * ms), (60 * ms, 90 * ms)]
    assert len(tl.kernels()) == 3
    ops = dict(tl.device_ops())
    assert ops["k1"] == pytest.approx(0.05) and ops["k2"] == pytest.approx(0.02)
    idle = dict(tl.idle_gaps())
    assert idle["aten::empty_strided"] == pytest.approx(0.01)
    assert idle["bench.step"] == pytest.approx(0.04)
    assert math.isclose(sum(idle.values()), 0.05)


def test_idle_readers():
    from benchmark.metrics import device_idle_pct, launches_per_step
    from benchmark.run import Context

    ms = 1_000_000
    tl = Timeline(start=0, end=100 * ms, steps=2,
                  device=[("k", 0, 40 * ms, "kernel"), ("k", 50 * ms, 90 * ms, "kernel")],
                  host=[])
    ctx = Context(window_steps=10, window_s=0.5, timeline=tl)
    assert device_idle_pct.read(ctx) == pytest.approx(20.0)  # 80 of 100 ms busy
    assert launches_per_step.read(ctx) == 1.0
    assert device_idle_pct.read(Context()) is None
