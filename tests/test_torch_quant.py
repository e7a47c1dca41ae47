"""The port's int8 convolutions (``cat_tpu_torch/ops/quant.py``) against the
JAX package's (``cat_tpu/ops/quant.py``) on the CPU: the quantised values
and scales bit for bit, the int8 conv of every kind the teachers run, the
im2col and transposed lowering of the card's path against the plain
version, and ``int8_call`` / ``int8_calibrate`` over toy teachers (inception
packed and unpacked, SPADE packed) against the JAX interpreter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cat_tpu.core import config as jcfg
from cat_tpu.core import spade_config as jsc
from cat_tpu.models import spade as jspade
from cat_tpu.models.generator import InceptionGenerator as JGen
from cat_tpu.ops import quant as jq
from cat_tpu_torch.models import spade as tspade
from cat_tpu_torch.models.generator import InceptionGenerator as TGen
from cat_tpu_torch.ops import quant as tq
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init
from tests.test_torch_spade import H, W, nchw, nhwc, to_port

torch.set_num_threads(1)


def _jax_conv(x, w, stride, pad, dil, groups, transposed=False, output_padding=0):
    """cat_tpu's int8_conv on NHWC / HWIO operands, the conv given as the
    port's (NCHW x, torch weight); a transposed conv as cat_tpu's
    ``ConvTranspose2d`` emits it (input dilation, flipped HWIO kernel)."""
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    if transposed:
        k = w.shape[2]
        wj = jnp.asarray(tq.transposed_weight(torch.from_numpy(w), groups).numpy()
                         .transpose(2, 3, 1, 0))
        lo = dil * (k - 1) - pad
        kw = dict(window_strides=(1, 1), padding=[(lo, lo + output_padding)] * 2,
                  lhs_dilation=(stride, stride))
    else:
        wj = jnp.asarray(w.transpose(2, 3, 1, 0))
        kw = dict(window_strides=(stride, stride), padding=[(pad, pad)] * 2,
                  lhs_dilation=(1, 1))
    dn = jax.lax.conv_dimension_numbers(xj.shape, wj.shape, ("NHWC", "HWIO", "NHWC"))
    out = jq.int8_conv(xj, wj, rhs_dilation=(dil, dil), dimension_numbers=dn,
                       feature_group_count=groups, batch_group_count=1, precision=None,
                       preferred_element_type=None, **kw)
    return np.asarray(out).transpose(0, 3, 1, 2)


def test_quantised_values_and_scales_equal_jax(rng):
    """qx, qw and the int8 values: bit for bit, float32 weights and
    bf16-rounded ones (the weights a bf16 teacher quantises), with exact
    halves (v / q = k + 0.5, rounded to even) among them."""
    x = (rng.randn(2, 8, 6, 6) * 3).astype(np.float32)
    x.flat[:5] = np.array([0.5, 1.5, 2.5, -0.5, -2.5]) * np.abs(x).max() / 127
    w = (rng.randn(12, 8, 3, 3) * 0.1).astype(np.float32)
    wb = torch.from_numpy(w).bfloat16().float().numpy()
    for name, wt in (("float32", w), ("bf16", wb)):
        qx, qw = tq.act_scale(torch.from_numpy(x)), tq.weight_scale(torch.from_numpy(wt))
        jqx = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-8) / 127.0
        jqw = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(wt)), axis=(1, 2, 3)), 1e-8) / 127.0
        np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx), err_msg=name)
        np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw), err_msg=name)
        xq = tq.quantize(torch.from_numpy(x), qx).numpy()
        wq = tq.quantize(torch.from_numpy(wt), qw.view(-1, 1, 1, 1)).numpy()
        jxq = jnp.clip(jnp.round(jnp.asarray(x) / jqx), -127, 127).astype(jnp.int8)
        jwq = jnp.clip(jnp.round(jnp.asarray(wt) / jqw[:, None, None, None]), -127,
                       127).astype(jnp.int8)
        np.testing.assert_array_equal(xq, np.asarray(jxq), err_msg=name)
        np.testing.assert_array_equal(wq, np.asarray(jwq), err_msg=name)
        assert xq.dtype == np.int8 and np.abs(xq).max() == 127
    assert list(xq.flat[:5]) == [0, 2, 2, 0, -2]  # halves round to even
    assert float(tq.act_scale(torch.zeros(3))) == np.float32(1e-8) / np.float32(127)


CONVS = {  # (cin, cout, k, stride, pad, dilation, groups, transposed)
    "dense": (16, 24, 3, 1, 1, 1, 1, False),
    "strided": (16, 24, 3, 2, 1, 1, 1, False),
    "dilated": (16, 24, 3, 1, 2, 2, 1, False),
    "stem": (3, 8, 7, 1, 3, 1, 1, False),
    "grouped": (16, 32, 3, 1, 1, 1, 4, False),
    "depthwise": (16, 16, 5, 1, 2, 1, 16, False),
    "transposed": (16, 24, 3, 2, 1, 1, 1, True),
}


@pytest.mark.parametrize("kind", sorted(CONVS))
def test_int8_conv_matches_jax(rng, kind):
    """The port's int8 conv against cat_tpu's: outputs within rtol 1e-6 (in
    fact equal), the int32 accumulators exact against the float64 plain
    version (the transposed one through the stride-1 lowering of the
    card's path), ~1% from the float32 conv."""
    cin, cout, k, s, p, d, g, tr = CONVS[kind]
    x = rng.randn(2, cin, 9, 11).astype(np.float32)
    w = ((rng.randn(cin, cout // g, k, k) if tr else rng.randn(cout, cin // g, k, k))
         * 0.1).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32))
    if tr:
        got = tq.int8_conv(xt, wt, b, s, p, d, g, transposed=True, output_padding=1)
        ref_f = F.conv_transpose2d(xt, wt, b, s, p, 1, g, d)
    else:
        got = tq.int8_conv(xt, wt, b, s, p, d, g)
        ref_f = F.conv2d(xt, wt, b, s, p, d, g)
    want = _jax_conv(x, w, s, p, d, g, tr, 1) + b.numpy()[None, :, None, None]
    assert got.shape == want.shape == ref_f.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    rel = float((got - ref_f).abs().mean() / ref_f.abs().mean())
    assert rel < 0.02, rel

    qx = tq.act_scale(xt)
    wr = tq.transposed_weight(wt, g) if tr else wt
    xq, wq = tq.quantize(xt, qx), tq.quantize(wr, tq.weight_scale(wr).view(-1, 1, 1, 1))
    if tr:
        acc = tq.int8_conv_acc_plain(tq.lower_transposed(xq, (k, k), s, p, 1, d), wq, 1, 0, d, g)
        wq_t = tq.quantize(wt, tq.weight_scale(wr).view(1, -1, 1, 1))  # groups 1: out is dim 1
        exact = F.conv_transpose2d(xq.double(), wq_t.double(), None, s, p, 1, g, d)
        assert torch.equal(acc, exact.to(torch.int32))
    else:
        acc = tq.int8_conv_acc(xq, wq, s, p, d, g)
        assert torch.equal(acc, tq.int8_conv_acc_plain(xq, wq, s, p, d, g))
    assert acc.dtype == torch.int32


@pytest.mark.parametrize("kind", ["dense", "strided", "dilated", "stem"])
def test_im2col_path_is_exact_at_every_chunk(rng, kind):
    """The card's ``groups == 1`` path (im2col, K and N padded to 8, M past
    16 rows, chunked over the batch) with a plain product in place of
    ``torch._int_mm``: the plain version's accumulator, whole and in
    one-image chunks; ``_int_mm``'s operand rules hold."""
    cin, cout, k, s, p, d, _, _ = CONVS[kind]
    xq = torch.from_numpy(rng.randint(-127, 128, (3, cin, 9, 11)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (cout, cin, k, k)).astype(np.int8))
    seen = []

    def mm(a, b):
        assert a.dtype == b.dtype == torch.int8 and a.is_contiguous() and b.t().is_contiguous()
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        seen.append(a.shape[0])
        return (a.double() @ b.double()).to(torch.int32)

    want = tq.int8_conv_acc_plain(xq, wq, s, p, d)
    assert torch.equal(tq.im2col_acc(xq, wq, s, p, d, mm=mm), want)
    rows = want.shape[2] * want.shape[3]
    one_image = rows * 8 * -(-cin * k * k // 8)
    assert torch.equal(tq.im2col_acc(xq, wq, s, p, d, mm=mm, max_bytes=one_image), want)
    assert seen[0] >= 3 * rows and len(seen) == 4


# ---------------------------------------------------------------------------
# int8_call / int8_calibrate over toy teachers
# ---------------------------------------------------------------------------


def _inception(packed):
    cfg = jcfg.InceptionGeneratorConfig.make(
        ngf=8, channels_reduction_factor=2, kernel_sizes=(1, 3, 5), n_blocks=2,
        norm=jcfg.NormConfig(kind="instance", affine=True, track_running_stats=False))
    jg = JGen(cfg, packed_blocks=packed)
    v = fast_init(jg, jnp.zeros((1, 32, 32, 3)), seed=5)
    tg = TGen(to_port(cfg), packed_blocks=packed)
    tg.load_state_dict(jax_import.generator_state_dict(v["params"], cfg))
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    taps = ("encode", "block1")
    return (lambda p, xx: jg.apply({"params": p}, xx, taps=taps)), v["params"], tg, x, taps


def _spade():
    cfg = jsc.SPADEGeneratorConfig.make(semantic_nc=5, ngf=4, channels_reduction_factor=4,
                                        kernel_sizes=(3,), num_upsampling_layers="normal",
                                        crop_size=W, aspect_ratio=2.0, nhidden=16,
                                        spectral=True)
    jg = jspade.SPADEGenerator(cfg, packed_blocks=True)
    v = fast_init(jg, jnp.zeros((1, H, W, 5)), seed=3)
    tg = tspade.SPADEGenerator(to_port(cfg))
    tg.load_state_dict(jax_import.spade_generator_state_dict(v["params"], to_port(cfg), v))
    seg = (np.random.RandomState(2).rand(2, H, W, 5) > 0.6).astype(np.float32)
    taps = ("head_0", "up_1")
    stats = {k: x for k, x in v.items() if k != "params"}
    return (lambda p, s: jg.apply({"params": p, **stats}, s, taps=taps)), v["params"], tg, seg, taps


@pytest.mark.parametrize("teacher", ["inception_packed", "inception_unpacked", "spade_packed"])
def test_int8_call_and_calibrate_match_jax(teacher):
    """The toy teacher's output and taps under ``int8_call`` within 1e-5 of
    cat_tpu's largest value, ``int8_calibrate``'s scales equal in number
    and order (rtol 1e-6); the calibrated scales fed back reproduce the
    dynamic forward; a scale tuple one short raises (at the extra conv), one
    long raises at the end.  cat_tpu's interpreter runs eagerly, each
    operation as written: under ``jax.jit`` XLA reassociates the float32
    arithmetic between the convs (``max / 127`` becomes a multiply by
    1/127), a conv input moves by ~1e-7, an int8 value on a rounding
    boundary flips, and the SPADE teacher's last tap moves ~1% from JAX's
    own eager result."""
    jfn, jparams, tg, x, taps = (_spade() if teacher == "spade_packed"
                                 else _inception(teacher == "inception_packed"))
    (jy, jacts), jscales = jq.int8_calibrate(jfn, jparams, jnp.asarray(x))
    tg.eval()

    def fn(p, xx):
        return torch.func.functional_call(tg, p, (xx,), {"train": False, "taps": taps})

    params = {k: v.detach() for k, v in tg.named_parameters()}
    (y, acts), scales = tq.int8_calibrate(fn, params, nchw(x))
    assert len(scales) == len(jscales) > 10
    np.testing.assert_allclose(scales, [float(s) for s in jscales], rtol=1e-6)
    for name, got, want in [("out", y, jy)] + [(k, acts[k], jacts[k]) for k in taps]:
        want = np.asarray(want)
        np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    y_dyn, _ = tq.int8_call(fn, params, nchw(x))
    y_static, _ = tq.int8_call(fn, params, nchw(x), act_scales=scales)
    assert torch.equal(y_dyn, y) and torch.equal(y_static, y)
    with pytest.raises(ValueError, match="at conv #"):
        tq.int8_call(fn, params, nchw(x), act_scales=scales[:-1])
    with pytest.raises(ValueError, match="contains"):
        tq.int8_call(fn, params, nchw(x), act_scales=scales + (1.0,))
