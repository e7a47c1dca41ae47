"""Plain PyTorch reference of CAT's KA-distillation step for GauGAN's
inception-SPADE generator: the step that ``cat_tpu_torch``'s
``SPADEDistiller.train_step`` computes, written from the method's
description and the reference CAT layout alone.

It imports nothing of the program.  It takes the seeded weights, buffers
and batches that the benchmark made, and works out itself what the
program derives: the semantics from the label and instance maps, the
shrunk student's widths (the FLOPs-targeted shrink), the branch-by-branch
stacks (the program packs them), and float32 throughout, convolutions and
matmuls without TF32.

The step (GauGAN's, TTUR: G at lr/2, D at 2·lr, Adam β = (0, 0.9)): the
frozen teacher in eval mode (running statistics) gives its taps; the
student in train mode (batch statistics) its image and taps; the G loss,
against the old D, is the hinge GAN term, feature matching over D's
intermediate maps (λ_feat / num_D), the VGG19 perceptual term (λ_vgg) and
λ_distill · Σ -KA over the taps; then D's update on a fake the *updated*
student regenerates in train mode, the hinge D loss on fake and real.  D's
spectral convs run one power iteration from their stored u at every
forward; only the D update's forward writes u back.

Weights are dicts in the program's key layout (the reference CAT's).  A
generator architecture is a plain dict: ``{"semantic_nc", "output_nc",
"fc", "crop", "aspect", "blocks"}``, each block ``{"name", "fin", "fout",
"res", "res_k", "dw", "dw_k", "sp_res", "sp_res_k", "sp_dw", "sp_dw_k"}``
listing the branches that exist.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.inception_ka import Adam, _id, exact_float32, ka, leaf_norms, quantiser

EPS = 1e-5
NAMES = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3")
UPSAMPLED = {"G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3"}  # 2x before these
VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
         512, 512, 512, 512, "M")
VGG_CFG = VGG19[:17]  # up to relu5_1
VGG_TAKE = (0, 2, 4, 8, 12)  # the convs whose ReLU is relu1_1 ... relu5_1
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


# ---------------------------------------------------------------------------
# Architectures and parameters
# ---------------------------------------------------------------------------


def teacher_arch(semantic_nc: int, ngf: int, reduction: int, kernels: Sequence[int],
                 crop: int, aspect: float, nhidden: int = 128) -> Dict:
    """The uniform teacher (num_upsampling_layers "more"): trunk 16·ngf,
    halved by each up block; branch widths min(fin, fout) // reduction,
    SPADE branches nhidden // reduction."""
    fc = 16 * ngf
    blocks, f = [], fc
    for name in NAMES:
        fin, fout = f, (f // 2 if name.startswith("up") else f)
        f = fout
        mid, smid = min(fin, fout) // reduction, nhidden // reduction
        blocks.append({"name": name, "fin": fin, "fout": fout,
                       "res": [mid] * len(kernels), "res_k": list(kernels),
                       "dw": [mid] * len(kernels), "dw_k": list(kernels),
                       "sp_res": [smid] * len(kernels), "sp_res_k": list(kernels),
                       "sp_dw": [smid] * len(kernels), "sp_dw_k": list(kernels)})
    return {"semantic_nc": semantic_nc, "output_nc": 3, "fc": fc, "crop": crop,
            "aspect": aspect, "blocks": blocks}


def latent(arch: Dict) -> Tuple[int, int]:
    sw = arch["crop"] // 64
    return round(sw / arch["aspect"]), sw


def _empty(b: Dict) -> bool:
    return not (b["res"] or b["dw"])


def generator_shapes(arch: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind): kind "conv", "bias", "scale", "shift", "mean"
    or "var" (a batch norm's running statistics)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def conv(name, cout, cin, k, bias=True):
        out[f"{name}.weight"] = ((cout, cin, k, k), "conv")
        if bias:
            out[f"{name}.bias"] = ((cout,), "bias")

    def norm(name, c, affine=True):
        if affine:
            out[f"{name}.weight"] = ((c,), "scale")
            out[f"{name}.bias"] = ((c,), "shift")
        out[f"{name}.running_mean"] = ((c,), "mean")
        out[f"{name}.running_var"] = ((c,), "var")

    sem = arch["semantic_nc"]
    conv("fc", arch["fc"], sem, 3)
    norm("fc_norm", arch["fc"])
    for b in arch["blocks"]:
        n, fin, fout = b["name"], b["fin"], b["fout"]
        if not _empty(b):
            norm(f"{n}.spade.param_free_norm", fin, affine=False)
            for j, (mid, k) in enumerate(zip(b["sp_res"], b["sp_res_k"])):
                conv(f"{n}.spade.res_ops.{j}.0.conv", mid, sem, k)
                norm(f"{n}.spade.res_ops.{j}.0.norm", mid)
                conv(f"{n}.spade.res_ops.{j}.1", 2 * fin, mid, k)
            for j, (mid, k) in enumerate(zip(b["sp_dw"], b["sp_dw_k"])):
                conv(f"{n}.spade.dw_ops.{j}.0.conv", mid, sem, 1)
                norm(f"{n}.spade.dw_ops.{j}.0.norm", mid)
                conv(f"{n}.spade.dw_ops.{j}.1.conv", mid, 1, k)
                norm(f"{n}.spade.dw_ops.{j}.1.norm", mid)
                conv(f"{n}.spade.dw_ops.{j}.2", 2 * fin, mid, 1)
            for j, (mid, k) in enumerate(zip(b["res"], b["res_k"])):
                conv(f"{n}.res_ops.{j}.0.conv", mid, fin, k)
                norm(f"{n}.res_ops.{j}.0.norm", mid)
                conv(f"{n}.res_ops.{j}.1.conv", fout, mid, k)
            for j, (mid, k) in enumerate(zip(b["dw"], b["dw_k"])):
                conv(f"{n}.dw_ops.{j}.0.conv", mid, fin, 1)
                norm(f"{n}.dw_ops.{j}.0.norm", mid)
                conv(f"{n}.dw_ops.{j}.1.conv", mid, 1, k)
                norm(f"{n}.dw_ops.{j}.1.norm", mid, affine=False)
                conv(f"{n}.dw_ops.{j}.2.conv", fout, mid, 1)
        if fin != fout:
            norm(f"{n}.shortcut.0", fin)
            conv(f"{n}.shortcut.1.conv", fout, fin, 1, bias=False)
    conv("conv_img", arch["output_nc"], arch["blocks"][-1]["fout"], 3)
    return out


def discriminator_shapes(input_nc: int, ndf: int, n_layers: int,
                         num_d: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The multiscale spectral-instance D: per scale, a plain 4x4 conv, then
    ``n_layers - 1`` spectral 4x4 convs (kind "sconv": ``weight_orig``, with
    ``weight_u``/``weight_v``, kind "u"/"v") each under an affine-free
    instance norm, then a plain 4x4 conv to one channel."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for i in range(num_d):
        p = f"discriminator_{i}"
        nf = ndf
        out[f"{p}.model0.0.weight"] = ((nf, input_nc, 4, 4), "conv")
        out[f"{p}.model0.0.bias"] = ((nf,), "bias")
        for n in range(1, n_layers):
            cin, nf = nf, min(nf * 2, 512)
            out[f"{p}.model{n}.0.0.weight_orig"] = ((nf, cin, 4, 4), "conv")
            out[f"{p}.model{n}.0.0.bias"] = ((nf,), "bias")
            out[f"{p}.model{n}.0.0.weight_u"] = ((nf,), "u")
            out[f"{p}.model{n}.0.0.weight_v"] = ((cin * 16,), "v")
        out[f"{p}.model{n_layers}.0.weight"] = ((1, nf, 4, 4), "conv")
        out[f"{p}.model{n_layers}.0.bias"] = ((1,), "bias")
    return out


def vgg_shapes() -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """torchvision's VGG19 ``features.{i}`` convs (the loss reads them up to
    relu5_1)."""
    out, cin, i = {}, 3, 0
    for v in VGG19:
        if v == "M":
            i += 1
            continue
        out[f"features.{i}.weight"] = ((v, cin, 3, 3), "conv")
        out[f"features.{i}.bias"] = ((v,), "bias")
        cin, i = v, i + 2
    return out


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def semantics(label: torch.Tensor, instance: torch.Tensor, label_nc: int) -> torch.Tensor:
    """One-hot labels, every id >= label_nc in a last don't-care channel,
    then the instance-boundary map (a pixel whose 4-neighbour has another
    instance id)."""
    lab = label.long().clamp(max=label_nc)
    one_hot = F.one_hot(lab, label_nc + 1).permute(0, 3, 1, 2).float()
    e = torch.zeros_like(instance, dtype=torch.bool)
    dx = instance[:, :, 1:] != instance[:, :, :-1]
    dy = instance[:, 1:, :] != instance[:, :-1, :]
    e[:, :, 1:] |= dx
    e[:, :, :-1] |= dx
    e[:, 1:, :] |= dy
    e[:, :-1, :] |= dy
    return torch.cat([one_hot, e.float()[:, None]], 1)


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def _bn(x, p, name, train, stats=None):
    """Batch norm over (N, H, W): batch statistics in train mode (recorded
    into ``stats`` when given), the running ones otherwise; affine when
    the parameters are there."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        if stats is not None:
            stats[f"{name}.running_mean"] = mean.detach().clone()
            stats[f"{name}.running_var"] = var.detach().clone()
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = (x - mean[:, None, None]) * torch.rsqrt(var + EPS)[:, None, None]
    if f"{name}.weight" in p:
        y = y * p[f"{name}.weight"][:, None, None] + p[f"{name}.bias"][:, None, None]
    return y


def generator(p: Dict[str, torch.Tensor], arch: Dict, seg: torch.Tensor, train: bool,
              taps: Sequence[str] = (), q=(None, None), stats=None):
    """The image in [-1, 1] and the named blocks' outputs."""
    q, gq = q[0] or _id, q[1] or _id

    def conv(h, name, groups=1):
        w = p[f"{name}.weight"]
        return gq(F.conv2d(q(h), q(w), p.get(f"{name}.bias"), padding=(w.shape[-1] - 1) // 2,
                           groups=groups))

    def bn(h, name):
        return _bn(h, p, name, train, stats)

    def lrelu(h):
        return F.leaky_relu(h, 0.01)

    acts = {}
    sh, sw = latent(arch)
    x = bn(conv(F.interpolate(seg, size=(sh, sw), mode="nearest"), "fc"), "fc_norm")
    h = sh
    for b in arch["blocks"]:
        n = b["name"]
        if n in UPSAMPLED:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            h *= 2
        if _empty(b):
            out = None
        else:
            s = F.interpolate(seg, size=(h, x.shape[3]), mode="nearest")
            total = 0.0
            for j, k in enumerate(b["sp_res_k"]):
                pre = f"{n}.spade.res_ops.{j}"
                total = total + conv(F.relu(bn(conv(s, f"{pre}.0.conv"), f"{pre}.0.norm")),
                                     f"{pre}.1")
            for j, mid in enumerate(b["sp_dw"]):
                pre = f"{n}.spade.dw_ops.{j}"
                t = F.relu(bn(conv(s, f"{pre}.0.conv"), f"{pre}.0.norm"))
                t = F.relu(bn(conv(t, f"{pre}.1.conv", groups=mid), f"{pre}.1.norm"))
                total = total + conv(t, f"{pre}.2")
            normed = bn(x, f"{n}.spade.param_free_norm")
            fin = b["fin"]
            if isinstance(total, float):  # no SPADE branch left: the norm alone
                tmp = lrelu(normed)
            else:
                tmp = lrelu(normed * (1.0 + total[:, :fin]) + total[:, fin:])
            out = 0.0
            for j in range(len(b["res"])):
                pre = f"{n}.res_ops.{j}"
                out = out + conv(lrelu(bn(conv(tmp, f"{pre}.0.conv"), f"{pre}.0.norm")),
                                 f"{pre}.1.conv")
            for j, mid in enumerate(b["dw"]):
                pre = f"{n}.dw_ops.{j}"
                t = lrelu(bn(conv(tmp, f"{pre}.0.conv"), f"{pre}.0.norm"))
                t = lrelu(bn(conv(t, f"{pre}.1.conv", groups=mid), f"{pre}.1.norm"))
                out = out + conv(t, f"{pre}.2.conv")
        if b["fin"] != b["fout"]:
            skip = conv(bn(x, f"{n}.shortcut.0"), f"{n}.shortcut.1.conv")
        else:
            skip = x
        out = skip if out is None else out + skip
        x = out
        if n in taps:
            acts[n] = x
    y = torch.tanh(conv(F.leaky_relu(x, 0.2), "conv_img"))
    return y, acts


def _inorm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt((x - mean).square().mean(dim=(2, 3), keepdim=True) + EPS)


def _l2norm(v):
    return v / (torch.linalg.vector_norm(v) + 1e-12)


def discriminator(p: Dict[str, torch.Tensor], u: Dict[str, torch.Tensor], x: torch.Tensor,
                  n_layers: int, num_d: int, write_u: bool, q=(None, None)):
    """Per scale, the list of every layer's output (the last the logits);
    the scales on an image pyramid of 3x3 stride-2 average pools that leave
    the padding out.  A spectral conv divides its kernel by σ from one power
    iteration from its u (σ held constant); with ``write_u`` the new u is
    stored."""
    q, gq = q[0] or _id, q[1] or _id
    outs = []
    for i in range(num_d):
        pre = f"discriminator_{i}"
        feats, h = [], x
        for n in range(n_layers + 1):
            if 0 < n < n_layers:
                name = f"{pre}.model{n}.0.0"
                w = p[f"{name}.weight_orig"]
                with torch.no_grad():
                    mat = w.detach().reshape(w.shape[0], -1)
                    v = _l2norm(mat.t() @ u[name])
                    un = _l2norm(mat @ v)
                    sigma = un @ (mat @ v)
                    if write_u:
                        u[name] = un
                w = w / sigma
                stride = 1 if n == n_layers - 1 else 2
            else:
                name = f"{pre}.model{n}.0"
                w = p[f"{name}.weight"]
                stride = 2 if n == 0 else 1
            h = gq(F.conv2d(q(h), q(w), p[f"{name}.bias"], stride=stride, padding=2))
            if 0 < n < n_layers:
                h = _inorm(h)
            if n < n_layers:
                h = F.leaky_relu(h, 0.2)
            feats.append(h)
        outs.append(feats)
        if i != num_d - 1:
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
    return outs


def vgg_features(p: Dict[str, torch.Tensor], x: torch.Tensor, q=(None, None)) -> List:
    """relu1_1, relu2_1, relu3_1, relu4_1, relu5_1 of VGG19 (3x3 convs,
    2x2 max pools), [-1, 1] images fed as they are."""
    q, gq = q[0] or _id, q[1] or _id
    outs, i, c = [], 0, 0
    for v in VGG_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            i += 1
            continue
        x = F.relu(gq(F.conv2d(q(x), q(p[f"features.{i}.weight"]), p[f"features.{i}.bias"],
                               padding=1)))
        if c in VGG_TAKE:
            outs.append(x)
        i, c = i + 2, c + 1
    return outs


# ---------------------------------------------------------------------------
# The shrink
# ---------------------------------------------------------------------------


def _branches_macs(res, res_k, dw, dw_k, cin, cout, h, w):
    macs = 0
    for mid, k in zip(res, res_k):
        macs += cin * mid * k * k * h * w + mid * cout * k * k * h * w
    for mid, k in zip(dw, dw_k):
        macs += cin * mid * h * w + mid * k * k * h * w + mid * cout * h * w
    return macs


def profile_macs(arch: Dict) -> int:
    """The reference's MAC count (its batch norms count nothing): the
    convolutions, at the crop's size."""
    sh, sw = latent(arch)
    macs = arch["semantic_nc"] * arch["fc"] * 9 * sh * sw
    h, w = sh, sw
    for b in arch["blocks"]:
        if b["name"] in UPSAMPLED:
            h, w = 2 * h, 2 * w
        if not _empty(b):
            macs += _branches_macs(b["sp_res"], b["sp_res_k"], b["sp_dw"], b["sp_dw_k"],
                                   arch["semantic_nc"], 2 * b["fin"], h, w)
            macs += _branches_macs(b["res"], b["res_k"], b["dw"], b["dw_k"], b["fin"],
                                   b["fout"], h, w)
        if b["fin"] != b["fout"]:
            macs += b["fin"] * b["fout"] * h * w
    return macs + arch["blocks"][-1]["fout"] * arch["output_nc"] * 9 * h * w


def shrink(arch: Dict, p: Dict[str, torch.Tensor], target_macs: float, cin_lb: int) -> Dict:
    """The student's widths: the smallest threshold on |γ| (among the values
    the scales take) whose architecture fits ``target_macs``.  The trunk
    keeps its channels above the threshold in whole multiples of 16, at
    least ``cin_lb`` of them; each block's and SPADE's branch keeps its
    channels above the threshold, with no floor; fin and fout follow the
    trunk."""
    def g(name):
        return p[f"{name}.weight"].detach().abs().double().cpu().numpy()

    fc_g = g("fc_norm")
    blocks_g = []
    for b in arch["blocks"]:
        n = b["name"]
        blocks_g.append({key: [g(f"{n}.{pre}.{j}.0.norm") for j in range(len(b[key]))]
                         for key, pre in (("res", "res_ops"), ("dw", "dw_ops"),
                                          ("sp_res", "spade.res_ops"),
                                          ("sp_dw", "spade.dw_ops"))})

    def candidate(t):
        fc = max(int((fc_g > t).sum()) // 16, cin_lb) * 16
        blocks, f = [], fc
        for b, bg in zip(arch["blocks"], blocks_g):
            fin, fout = f, (f // 2 if b["name"].startswith("up") else f)
            f = fout
            nb = {"name": b["name"], "fin": fin, "fout": fout}
            for key in ("res", "dw", "sp_res", "sp_dw"):
                kept = [(int((gam > t).sum()), k) for gam, k in zip(bg[key], b[f"{key}_k"])]
                nb[key] = [c for c, _ in kept if c]
                nb[f"{key}_k"] = [k for c, k in kept if c]
            blocks.append(nb)
        return {**arch, "fc": fc, "blocks": blocks}

    values = np.unique(np.concatenate([fc_g] + [x for bg in blocks_g for v in bg.values()
                                                for x in v]))
    lo, hi = 0, values.size - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if profile_macs(candidate(values[mid])) <= target_macs:
            hi = mid
        else:
            lo = mid + 1
    return candidate(float(values[lo]))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _hinge_g(pred):
    return sum(-scale[-1].mean() for scale in pred) / len(pred)


def _hinge_d(pred, real: bool):
    if real:
        return sum(-torch.clamp_max(s[-1] - 1.0, 0.0).mean() for s in pred) / len(pred)
    return sum(-torch.clamp_max(-s[-1] - 1.0, 0.0).mean() for s in pred) / len(pred)


def calibrate_stats(p: Dict[str, torch.Tensor], arch: Dict, seg: torch.Tensor) -> Dict:
    """Running statistics for a seeded (untrained) teacher: each batch
    norm's batch statistics on ``seg``, so that its eval-mode forward on
    that batch is its train-mode one."""
    stats: Dict[str, torch.Tensor] = {}
    with exact_float32(), torch.no_grad():
        generator(p, arch, seg, True, stats=stats)
    return stats


def run_steps(teacher_p, teacher, student_p, student, d_p, vgg_p, batches, hp: Dict, lr: float,
              precision: Optional[Dict] = None) -> Dict:
    """The GauGAN KA-distillation steps of CAT on ``batches`` (one step
    each), in float32; returns each step's losses, each leaf's first
    gradient norm ("G:name", "D:name") and each leaf's change after the
    steps.  ``precision`` as in ``inception_ka.run_steps`` (the control)."""
    prec = precision or {}
    q = quantiser(prec.get("precision"), prec.get("grad_precision"))
    n_layers, num_d = hp["n_layers_D"], hp["num_D"]
    with exact_float32():
        tp = {k: v.float() for k, v in teacher_p.items()}
        vp = {k: v.float() for k, v in vgg_p.items()}
        sp = {k: v.float().clone().requires_grad_(True) for k, v in student_p.items()
              if not k.endswith(("running_mean", "running_var"))}
        s_bufs = {k: v.float() for k, v in student_p.items()
                  if k.endswith(("running_mean", "running_var"))}
        dp = {k: v.float().clone().requires_grad_(True) for k, v in d_p.items()
              if not k.endswith(("weight_u", "weight_v"))}
        u = {k[:-len(".weight_u")]: v.float().clone() for k, v in d_p.items()
             if k.endswith(".weight_u")}
        start = {**{f"G:{k}": v.detach().clone() for k, v in sp.items()},
                 **{f"D:{k}": v.detach().clone() for k, v in dp.items()}}
        opt_g = Adam(sp, hp["beta1"], hp["beta2"])
        opt_d = Adam(dp, hp["beta1"], hp["beta2"])
        taps = hp["taps"]
        losses, first = [], {}
        for batch in batches:
            sem = semantics(batch["label"], batch["instance"], hp["label_nc"])
            real = batch["image"].float()
            with torch.no_grad():
                _, t_acts = generator(tp, teacher, sem, False, taps, q)
            fake, s_acts = generator({**sp, **s_bufs}, student, sem, True, taps, q)
            d_now = {k: v.detach() for k, v in dp.items()}
            both = discriminator(d_now, u, torch.cat([torch.cat([sem, fake], 1),
                                                      torch.cat([sem, real], 1)]),
                                 n_layers, num_d, False, q)
            b = sem.shape[0]
            pred_fake = [[t[:b] for t in s] for s in both]
            pred_real = [[t[b:] for t in s] for s in both]
            l_gan = _hinge_g(pred_fake) * hp["lambda_gan"]
            l_feat = sum((f - r.detach()).abs().mean() / num_d for sf, sr in
                         zip(pred_fake, pred_real) for f, r in zip(sf[:-1], sr[:-1]))
            l_feat = l_feat * hp["lambda_feat"]
            fx = vgg_features(vp, fake, q)
            with torch.no_grad():
                fy = vgg_features(vp, real, q)
            l_vgg = sum(w * (a - c).abs().mean() for w, a, c in zip(VGG_WEIGHTS, fx, fy))
            l_vgg = l_vgg * hp["lambda_vgg"]
            parts = {f"Specific_loss/distill{i}": -ka(s_acts[t], t_acts[t], q)
                     for i, t in enumerate(taps)}
            l_dis = sum(parts.values()) * hp["lambda_distill"]
            g_grads = dict(zip(sp, torch.autograd.grad(l_gan + l_feat + l_vgg + l_dis,
                                                       list(sp.values()))))
            opt_g.step(g_grads, lr * 0.5)
            with torch.no_grad():
                fake2, _ = generator({**sp, **s_bufs}, student, sem, True, (), q)
            both = discriminator(dp, u, torch.cat([torch.cat([sem, fake2], 1),
                                                   torch.cat([sem, real], 1)]),
                                 n_layers, num_d, True, q)
            l_d_fake = _hinge_d([[t[:b] for t in s] for s in both], False)
            l_d_real = _hinge_d([[t[b:] for t in s] for s in both], True)
            d_grads = dict(zip(dp, torch.autograd.grad(l_d_fake + l_d_real, list(dp.values()))))
            opt_d.step(d_grads, lr * 2.0)
            if not first:
                first = {**{f"G:{k}": v for k, v in leaf_norms(g_grads).items()},
                         **{f"D:{k}": v for k, v in leaf_norms(d_grads).items()}}
            losses.append({k: float(v.detach()) for k, v in {
                "G_loss/gan": l_gan, "G_loss/feat": l_feat, "G_loss/vgg": l_vgg,
                "G_loss/distill": l_dis, "D_loss/fake": l_d_fake, "D_loss/real": l_d_real,
                **parts}.items()})
            del fake, s_acts, t_acts, fx, fy, both, fake2
        end = {**{f"G:{k}": v.detach() for k, v in sp.items()},
               **{f"D:{k}": v.detach() for k, v in dp.items()}}
        change = {k: float((end[k] - start[k]).double().norm()) for k in start}
    return {"losses": losses, "first_grad": first, "change": change}
