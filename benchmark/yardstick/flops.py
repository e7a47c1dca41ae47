"""The work of the benchmark's steps, worked out from the configurations.

Frozen arithmetic: it counts what the algorithm needs, whatever implements
it, so a later change to the program cannot change what a cell's work is.

Two counts of an inception generator live here:

* ``profile_macs`` is the closed-form count that the CAT reference (and the
  program's ``compress/profiling.py``) uses for its FLOPs budget: a
  transposed conv counted at its *output* size, and each untracked norm as
  C·H·W.  The shrink search aims at this number, so the reference's shrink
  uses it to pick the same student.
* ``generator_convs`` lists each convolution's true multiply-adds (a
  stride-2 transposed conv at its input size, no norms), which is what
  ``mfu`` counts.

A generator architecture is a plain dict (see ``reference/inception_ka.py``):
``{"input_nc", "output_nc", "ds": [...], "us": [...], "blocks": [{"res",
"dw", "res_k", "dw_k"}, ...]}`` where ``res``/``dw`` are the mid widths of
the branches that exist, in config order, with their kernels beside them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def conv_out(size: int, k: int, stride: int = 1, pad: int = 0) -> int:
    return (size + 2 * pad - k) // stride + 1


# ---------------------------------------------------------------------------
# Inception generator
# ---------------------------------------------------------------------------


def profile_macs(arch: Dict, h: int, w: int) -> int:
    """The CAT reference's MAC count of an inception generator at h x w
    (affine instance norms, conv biases; batch 1)."""
    macs = 0

    def norm(c, hh, ww):
        return c * hh * ww

    macs += arch["input_nc"] * arch["ds"][0] * 49 * h * w + norm(arch["ds"][0], h, w)
    cin = arch["ds"][0]
    for ch in arch["ds"][1:]:
        h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
        macs += cin * ch * 9 * h * w + norm(ch, h, w)
        cin = ch
    dim = cin
    for b in arch["blocks"]:
        if not b["res"] and not b["dw"]:
            continue
        for mid, k in zip(b["res"], b["res_k"]):
            macs += 2 * dim * mid * k * k * h * w + norm(mid, h, w)
        for mid, k in zip(b["dw"], b["dw_k"]):
            macs += 2 * dim * mid * h * w + mid * k * k * h * w + 2 * norm(mid, h, w)
        macs += norm(dim, h, w)
    for ch in arch["us"]:
        h, w = h * 2, w * 2
        macs += cin * ch * 9 * h * w + norm(ch, h, w)
        cin = ch
    return macs + cin * arch["output_nc"] * 49 * h * w


def generator_convs(arch: Dict, h: int, w: int) -> List[int]:
    """True multiply-adds of each convolution of an inception generator's
    forward at h x w for one image, the stem first."""
    convs = [arch["input_nc"] * arch["ds"][0] * 49 * h * w]
    cin = arch["ds"][0]
    for ch in arch["ds"][1:]:
        h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
        convs.append(cin * ch * 9 * h * w)
        cin = ch
    dim = cin
    for b in arch["blocks"]:
        for mid, k in zip(b["res"], b["res_k"]):
            convs += [dim * mid * k * k * h * w, mid * dim * k * k * h * w]
        for mid, k in zip(b["dw"], b["dw_k"]):
            convs += [dim * mid * h * w, mid * k * k * h * w, mid * dim * h * w]
    for ch in arch["us"]:
        convs.append(cin * ch * 9 * h * w)  # each input pixel meets the 3x3 kernel once
        h, w = h * 2, w * 2
        cin = ch
    convs.append(cin * arch["output_nc"] * 49 * h * w)
    return convs


def generator_taps(arch: Dict, h: int, w: int, taps: Sequence[str]) -> Dict[str, int]:
    """Features a tap flattens to for one image (C·H·W): ``encode`` and
    ``block{i}`` are all at the bottleneck's width and size."""
    for _ in arch["ds"][1:]:
        h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    return {t: arch["ds"][-1] * h * w for t in taps}


def fused_norm_sites(arch: Dict, h: int, w: int, packed: bool) -> List[Tuple]:
    """(layer, channels, height, width, activation) of each affine instance
    norm of one forward at h x w, in order: the sites of the fused norm
    kernel.  The trunk's ConvNormActs (stem first, ReLU); each non-empty
    block's, at the bottleneck: unpacked, one a residual branch and two a
    depthwise branch (its 1x1 and its depthwise conv), packed, one a kernel
    size of the first convs (the 1x1 group also holds every depthwise
    branch's 1x1), in increasing size, and one for the depthwise stage,
    all ReLU; then its ``pw_bn`` over the bottleneck, with no activation;
    last the upsampling's (ReLU)."""
    sites = [("trunk", arch["ds"][0], h, w, "relu")]
    for ch in arch["ds"][1:]:
        h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
        sites.append(("trunk", ch, h, w, "relu"))
    dim = arch["ds"][-1]
    for b in arch["blocks"]:
        if not b["res"] and not b["dw"]:
            continue
        if packed:
            groups: Dict[int, int] = {}
            for mid, k in zip(b["res"], b["res_k"]):
                groups[k] = groups.get(k, 0) + mid
            if b["dw"]:
                groups[1] = groups.get(1, 0) + sum(b["dw"])
            mids = [groups[k] for k in sorted(groups)] + ([sum(b["dw"])] if b["dw"] else [])
        else:
            mids = list(b["res"]) + [m for m in b["dw"] for _ in range(2)]
        sites += [("blocks", m, h, w, "relu") for m in mids]
        sites.append(("blocks", dim, h, w, "none"))
    for ch in arch["us"]:
        h, w = h * 2, w * 2
        sites.append(("upsampling", ch, h, w, "relu"))
    return sites


# ---------------------------------------------------------------------------
# NLayer (PatchGAN) discriminator
# ---------------------------------------------------------------------------


def nlayer_convs(input_nc: int, ndf: int, n_layers: int, h: int, w: int) -> List[int]:
    """True multiply-adds of each 4x4 conv of the NLayer discriminator for
    one image, the first conv first."""
    h, w = conv_out(h, 4, 2, 1), conv_out(w, 4, 2, 1)
    convs = [input_nc * ndf * 16 * h * w]
    cin = ndf
    for n in range(1, n_layers + 1):
        cout = ndf * min(2 ** n, 8)
        stride = 2 if n < n_layers else 1
        h, w = conv_out(h, 4, stride, 1), conv_out(w, 4, stride, 1)
        convs.append(cin * cout * 16 * h * w)
        cin = cout
    h, w = conv_out(h, 4, 1, 1), conv_out(w, 4, 1, 1)
    convs.append(cin * 16 * h * w)
    return convs


# ---------------------------------------------------------------------------
# Passes and Grams
# ---------------------------------------------------------------------------


def train_macs(convs: Sequence[int], input_grad: bool, weight_grad: bool) -> int:
    """Forward and backward multiply-adds of one pass through a network of
    ``convs``: the forward, each conv's weight gradient when the weights
    train, and each conv's input gradient except the first conv's when the
    network's input takes none."""
    total = sum(convs)
    if weight_grad:
        total += sum(convs)
    total += sum(convs) if input_grad else sum(convs[1:])
    return total


def gram_flops(b: int, f: int) -> int:
    """Operations of one Gram X·Xᵀ of a (b, f) operand: its lower triangle,
    b(b+1)/2 dot products of f multiply-adds."""
    return b * (b + 1) * f


def ka_backward_flops(b: int, f: int) -> int:
    """Operations of KA's backward into one operand: a (b x b)(b x f) product."""
    return 2 * b * b * f


def inception_ka_step_flops(teacher: Dict, student: Dict, d: Dict, batch: int, h: int, w: int,
                            taps: Sequence[str]) -> int:
    """Operations of one KA-distillation step of the inception distiller
    (unaligned: D sees B alone) for a batch: the teacher's forward; the
    student's forward and backward (no gradient into the images); D's
    update, a forward and backward on the fake and on the real batch (no
    gradient into either image); the G loss's pass through the updated D
    (a forward and the input gradient, D's weights frozen); and per tap the
    two Grams and KA's backward into the student's tap."""
    t = sum(generator_convs(teacher, h, w))
    s_convs = generator_convs(student, h, w)
    d_convs = nlayer_convs(d["input_nc"], d["ndf"], d["n_layers"], h, w)
    macs = t + train_macs(s_convs, False, True)
    macs += 2 * train_macs(d_convs, False, True)
    macs += train_macs(d_convs, True, False)
    flops = 2 * macs * batch
    t_taps = generator_taps(teacher, h, w, taps)
    s_taps = generator_taps(student, h, w, taps)
    for tap in taps:
        flops += gram_flops(batch, t_taps[tap]) + gram_flops(batch, s_taps[tap])
        flops += ka_backward_flops(batch, s_taps[tap])
    return flops


# ---------------------------------------------------------------------------
# GauGAN: the inception-SPADE generator, the multiscale D, VGG19
# ---------------------------------------------------------------------------

SPADE_UPSAMPLED = {"G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3"}


def _stack(res, res_k, dw, dw_k, cin, cout, hw, reads_input):
    """(MACs, reads_input) of each conv of a multi-branch stack at hw pixels."""
    out = []
    for mid, k in zip(res, res_k):
        out += [(cin * mid * k * k * hw, reads_input), (mid * cout * k * k * hw, False)]
    for mid, k in zip(dw, dw_k):
        out += [(cin * mid * hw, reads_input), (mid * k * k * hw, False),
                (mid * cout * hw, False)]
    return out


def spade_convs(arch: Dict) -> List[tuple]:
    """(MACs for one image, whether the conv reads the semantics) of each
    convolution of an inception-SPADE generator (architecture dict of
    ``reference/spade_ka.py``, crop at its aspect ratio): the convs that read
    the semantics need no input gradient."""
    sw = arch["crop"] // 64
    sh = round(sw / arch["aspect"])
    convs = [(arch["semantic_nc"] * arch["fc"] * 9 * sh * sw, True)]
    hw = sh * sw
    for b in arch["blocks"]:
        if b["name"] in SPADE_UPSAMPLED:
            hw *= 4
        if b["res"] or b["dw"]:
            convs += _stack(b["sp_res"], b["sp_res_k"], b["sp_dw"], b["sp_dw_k"],
                            arch["semantic_nc"], 2 * b["fin"], hw, True)
            convs += _stack(b["res"], b["res_k"], b["dw"], b["dw_k"], b["fin"], b["fout"], hw,
                            False)
        if b["fin"] != b["fout"]:
            convs.append((b["fin"] * b["fout"] * hw, False))
    return convs + [(arch["blocks"][-1]["fout"] * arch["output_nc"] * 9 * hw, False)]


def spade_taps(arch: Dict, taps: Sequence[str]) -> Dict[str, int]:
    """Features of a block's output for one image (fout·H·W)."""
    sw = arch["crop"] // 64
    sh = round(sw / arch["aspect"])
    out, hw = {}, sh * sw
    for b in arch["blocks"]:
        if b["name"] in SPADE_UPSAMPLED:
            hw *= 4
        if b["name"] in taps:
            out[b["name"]] = b["fout"] * hw
    return out


def multiscale_d_convs(input_nc: int, ndf: int, n_layers: int, num_d: int, h: int,
                       w: int) -> List[int]:
    """Multiply-adds of each 4x4 conv (padding 2) of the multiscale D for one
    image, the scales on 3x3 stride-2 average pools; the first conv first."""
    convs = []
    for _ in range(num_d):
        hh, ww, cin, nf = h, w, input_nc, ndf
        for n in range(n_layers + 1):
            cout = 1 if n == n_layers else (ndf if n == 0 else min(nf * 2, 512))
            stride = 2 if n < n_layers - 1 else 1
            hh, ww = conv_out(hh, 4, stride, 2), conv_out(ww, 4, stride, 2)
            convs.append(cin * cout * 16 * hh * ww)
            cin, nf = cout, (cout if n < n_layers else nf)
        h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    return convs


VGG19_TO_RELU5_1 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
                    "M", 512)


def vgg_convs(h: int, w: int) -> List[int]:
    """Multiply-adds of each 3x3 conv of VGG19 up to relu5_1 for one image."""
    convs, cin = [], 3
    for v in VGG19_TO_RELU5_1:
        if v == "M":
            h, w = h // 2, w // 2
            continue
        convs.append(cin * v * 9 * h * w)
        cin = v
    return convs


def spade_ka_step_flops(teacher: Dict, student: Dict, d: Dict, batch: int,
                        taps: Sequence[str]) -> int:
    """Operations of one GauGAN KA-distillation step for a batch: the
    teacher's forward; the G update (the student's forward and backward, no
    input gradient into the semantics; D's forward over fake and real and
    its input gradient for the fake, D frozen; VGG19's forward over fake and
    real and its input gradient for the fake; per tap the two Grams and KA's
    backward into the student's tap); the D update (the updated student's
    forward, D's forward and backward over fake and real, no input
    gradient)."""
    h = round(teacher["crop"] / teacher["aspect"])
    w = teacher["crop"]
    t = sum(m for m, _ in spade_convs(teacher))
    s = spade_convs(student)
    s_fwd = sum(m for m, _ in s)
    s_bwd = s_fwd + sum(m for m, reads in s if not reads)
    dc = multiscale_d_convs(d["input_nc"], d["ndf"], d["n_layers"], d["num_D"], h, w)
    d_fwd = sum(dc)
    first = sum(dc[i * (d["n_layers"] + 1)] for i in range(d["num_D"]))
    vc = sum(vgg_convs(h, w))
    g_update = s_fwd + s_bwd + 2 * d_fwd + d_fwd + 2 * vc + vc
    d_update = s_fwd + 2 * d_fwd + 2 * (2 * d_fwd - first)
    flops = 2 * batch * (t + g_update + d_update)
    t_taps, s_taps = spade_taps(teacher, taps), spade_taps(student, taps)
    for tap in taps:
        flops += gram_flops(batch, t_taps[tap]) + gram_flops(batch, s_taps[tap])
        flops += ka_backward_flops(batch, s_taps[tap])
    return flops
