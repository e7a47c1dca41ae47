"""Plain PyTorch reference of CAT's KA-distillation step for the inception
(ResNet-style) generator: the step that ``cat_tpu_torch``'s
``InceptionDistiller.train_step`` computes, written from the method's
description and the reference CAT layout alone.

It imports nothing of the program.  It takes the teacher's and D's seeded
weights and the batches that the benchmark made, and works out itself what
the program derives from them: the shrunk student's channels and its
sliced weights (the FLOPs-targeted shrink), the branch-by-branch blocks
(the program packs them), and float32 throughout (the program casts to
its compute dtype).  Convolutions and matmuls run in float32 with TF32 off.

Weights are dicts in the reference CAT key layout (``down_sampling.*``,
``features.{i}.res_ops.{pos}.*`` / ``dw_ops.{pos}.*`` / ``pw_bn``,
``up_sampling.*``; the NLayer D's ``model.{i}``).  An architecture is a
plain dict: ``{"input_nc", "output_nc", "ds", "us", "blocks"}``, each block
``{"res", "res_k", "dw", "dw_k"}`` listing the branches that exist (mid
width and kernel), in config order.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.yardstick.flops import profile_macs

EPS = 1e-5


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Architectures and their parameters
# ---------------------------------------------------------------------------


def teacher_arch(input_nc: int, output_nc: int, ngf: int, reduction: int,
                 kernels: Sequence[int], n_blocks: int) -> Dict:
    """The uniform teacher: trunk ngf, 2ngf, 4ngf; every branch of every
    block at 4·ngf // reduction channels."""
    mid = 4 * ngf // reduction
    block = {"res": [mid] * len(kernels), "res_k": list(kernels),
             "dw": [mid] * len(kernels), "dw_k": list(kernels)}
    return {"input_nc": input_nc, "output_nc": output_nc, "ds": [ngf, 2 * ngf, 4 * ngf],
            "us": [2 * ngf, ngf], "blocks": [dict(block) for _ in range(n_blocks)]}


def generator_shapes(arch: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every parameter of the generator: name -> (shape, kind), kind one of
    "conv" (a kernel), "bias", "scale" (a norm's γ) or "shift" (its β)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def conv(name, cout, cin, k, transposed=False):
        out[f"{name}.weight"] = ((cin, cout, k, k) if transposed else (cout, cin, k, k), "conv")
        out[f"{name}.bias"] = ((cout,), "bias")

    def norm(name, c):
        out[f"{name}.weight"] = ((c,), "scale")
        out[f"{name}.bias"] = ((c,), "shift")

    ds = arch["ds"]
    conv("down_sampling.1", ds[0], arch["input_nc"], 7)
    norm("down_sampling.2", ds[0])
    for j in range(1, len(ds)):
        conv(f"down_sampling.{3 * j + 1}", ds[j], ds[j - 1], 3)
        norm(f"down_sampling.{3 * j + 2}", ds[j])
    dim = ds[-1]
    for i, b in enumerate(arch["blocks"]):
        for pos, (mid, k) in enumerate(zip(b["res"], b["res_k"])):
            pre = f"features.{i}.res_ops.{pos}"
            conv(f"{pre}.1.0", mid, dim, k)
            norm(f"{pre}.1.1", mid)
            conv(f"{pre}.4", dim, mid, k)
        for pos, (mid, k) in enumerate(zip(b["dw"], b["dw_k"])):
            pre = f"features.{i}.dw_ops.{pos}"
            conv(f"{pre}.0.0", mid, dim, 1)
            norm(f"{pre}.0.1", mid)
            conv(f"{pre}.2.0", mid, 1, k)
            norm(f"{pre}.2.1", mid)
            conv(f"{pre}.4", dim, mid, 1)
        if b["res"] or b["dw"]:
            norm(f"features.{i}.pw_bn", dim)
    cin = dim
    for j, ch in enumerate(arch["us"]):
        conv(f"up_sampling.{3 * j}", ch, cin, 3, transposed=True)
        norm(f"up_sampling.{3 * j + 1}", ch)
        cin = ch
    conv(f"up_sampling.{3 * len(arch['us']) + 1}", arch["output_nc"], cin, 7)
    return out


def nlayer_shapes(input_nc: int, ndf: int, n_layers: int,
                  affine: bool) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The NLayer (PatchGAN) discriminator's parameters: 4x4 convs with
    biases, instance norms after the middle convs (with γ, β when affine)."""
    out = {"model.0.weight": ((ndf, input_nc, 4, 4), "conv"), "model.0.bias": ((ndf,), "bias")}
    cin = ndf
    for n in range(1, n_layers + 1):
        cout = ndf * min(2 ** n, 8)
        out[f"model.{3 * n - 1}.weight"] = ((cout, cin, 4, 4), "conv")
        out[f"model.{3 * n - 1}.bias"] = ((cout,), "bias")
        if affine:
            out[f"model.{3 * n}.weight"] = ((cout,), "scale")
            out[f"model.{3 * n}.bias"] = ((cout,), "shift")
        cin = cout
    last = 3 * n_layers + 2
    out[f"model.{last}.weight"] = ((1, cin, 4, 4), "conv")
    out[f"model.{last}.bias"] = ((1,), "bias")
    return out


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def _round(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x rounded to ``dt`` and back to float32; an fp8 type at a per-tensor
    scale that maps x's largest magnitude to the type's largest."""
    if dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        s = x.abs().amax().clamp_min(1e-30) / torch.finfo(dt).max
        return (x / s).to(dt).float() * s
    return x.to(dt).float()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient."""

    @staticmethod
    def forward(ctx, x, dt):
        ctx.dt = dt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dt), None


def quantiser(dtype: Optional[str], grad_dtype: Optional[str] = None):
    """For the control: (q, gq).  q rounds a convolution's operand to
    ``dtype`` in the forward and passes its gradient straight through; gq,
    put on a convolution's output, rounds the gradient that its backward
    takes to ``grad_dtype``.  (None, None) keeps float32."""
    if dtype is None:
        return None, None
    dt = getattr(torch, dtype)
    gdt = getattr(torch, grad_dtype or dtype)

    def q(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            xq = _round(x, dt)
        return x + (xq - x).detach()

    def gq(y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y, gdt)

    return q, gq


def _id(x):
    return x


def inorm(x: torch.Tensor, w: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> torch.Tensor:
    """Instance norm over each (sample, channel) plane, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    if w is not None:
        y = y * w[:, None, None] + b[:, None, None]
    return y


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x, (n, n, n, n), mode="reflect") if n else x


def generator(p: Dict[str, torch.Tensor], arch: Dict, x: torch.Tensor,
              taps: Sequence[str] = (), q=(None, None)
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's image in [-1, 1] and its taps (``encode``: the
    downsampling trunk's output; ``block{i}``: block i's).  ``q``: the
    control's rounding of every convolution (``quantiser``)."""
    q, gq = q[0] or _id, q[1] or _id

    def conv(h, name, **kw):
        return gq(F.conv2d(q(h), q(p[f"{name}.weight"]), p[f"{name}.bias"], **kw))

    def norm_relu(h, name):
        return F.relu(inorm(h, p[f"{name}.weight"], p[f"{name}.bias"]))

    acts = {}
    h = norm_relu(conv(_pad(x, 3), "down_sampling.1"), "down_sampling.2")
    for j in range(1, len(arch["ds"])):
        h = norm_relu(conv(h, f"down_sampling.{3 * j + 1}", stride=2, padding=1),
                      f"down_sampling.{3 * j + 2}")
    if "encode" in taps:
        acts["encode"] = h
    for i, b in enumerate(arch["blocks"]):
        if b["res"] or b["dw"]:
            total = 0.0
            for pos, k in enumerate(b["res_k"]):
                pre = f"features.{i}.res_ops.{pos}"
                t = norm_relu(conv(_pad(h, (k - 1) // 2), f"{pre}.1.0"), f"{pre}.1.1")
                total = total + conv(_pad(t, (k - 1) // 2), f"{pre}.4")
            for pos, (mid, k) in enumerate(zip(b["dw"], b["dw_k"])):
                pre = f"features.{i}.dw_ops.{pos}"
                t = norm_relu(conv(h, f"{pre}.0.0"), f"{pre}.0.1")
                t = norm_relu(conv(_pad(t, (k - 1) // 2), f"{pre}.2.0", groups=mid),
                              f"{pre}.2.1")
                total = total + conv(t, f"{pre}.4")
            pw = f"features.{i}.pw_bn"
            h = h + inorm(total, p[f"{pw}.weight"], p[f"{pw}.bias"])
        if f"block{i}" in taps:
            acts[f"block{i}"] = h
    for j in range(len(arch["us"])):
        h = gq(F.conv_transpose2d(q(h), q(p[f"up_sampling.{3 * j}.weight"]),
                                  p[f"up_sampling.{3 * j}.bias"],
                                  stride=2, padding=1, output_padding=1))
        h = norm_relu(h, f"up_sampling.{3 * j + 1}")
    y = torch.tanh(conv(_pad(h, 3), f"up_sampling.{3 * len(arch['us']) + 1}"))
    return y, acts


def nlayer(p: Dict[str, torch.Tensor], n_layers: int, x: torch.Tensor,
           q=(None, None)) -> torch.Tensor:
    """The PatchGAN's logit map: 4x4 convs (stride 2, then 1 for the last
    middle conv and the output), LeakyReLU(0.2)."""
    q, gq = q[0] or _id, q[1] or _id

    def conv(h, name, **kw):
        return gq(F.conv2d(q(h), q(p[f"{name}.weight"]), p[f"{name}.bias"], padding=1, **kw))

    h = F.leaky_relu(conv(x, "model.0", stride=2), 0.2)
    for n in range(1, n_layers + 1):
        h = conv(h, f"model.{3 * n - 1}", stride=2 if n < n_layers else 1)
        h = F.leaky_relu(inorm(h, p.get(f"model.{3 * n}.weight"), p.get(f"model.{3 * n}.bias")),
                         0.2)
    return conv(h, f"model.{3 * n_layers + 2}")


def ka(x: torch.Tensor, y: torch.Tensor, q=(None, None)) -> torch.Tensor:
    """Kernel alignment <XXᵀ, YYᵀ> / (‖XXᵀ‖ ‖YYᵀ‖) of batch-flattened taps."""
    q = q[0] or _id
    x, y = q(x.reshape(x.shape[0], -1)), q(y.reshape(y.shape[0], -1))
    gx, gy = x @ x.T, y @ y.T
    return (gx * gy).sum() / torch.sqrt((gx * gx).sum() * (gy * gy).sum())


# ---------------------------------------------------------------------------
# The shrink: the student's channels and weights from the teacher's
# ---------------------------------------------------------------------------


def _gammas(p: Dict[str, torch.Tensor], arch: Dict):
    """|γ| of the prunable norms: the trunk's, each branch's first, the
    upsampling's."""
    def g(name):
        return p[f"{name}.weight"].detach().abs().double().cpu().numpy()

    ds = [g("down_sampling.2")] + [g(f"down_sampling.{3 * j + 2}")
                                   for j in range(1, len(arch["ds"]))]
    blocks = [([g(f"features.{i}.res_ops.{pos}.1.1") for pos in range(len(b["res"]))],
               [g(f"features.{i}.dw_ops.{pos}.0.1") for pos in range(len(b["dw"]))])
              for i, b in enumerate(arch["blocks"])]
    us = [g(f"up_sampling.{3 * j + 1}") for j in range(len(arch["us"]))]
    return ds, blocks, us


def _keep_top(gam: np.ndarray, k: int) -> np.ndarray:
    k = min(k, len(gam))
    return gam >= np.sort(gam)[::-1][k - 1]


def _masks(ds, blocks, us, t: float, cin_lb: int):
    """Keep-masks at threshold t: |γ| > t, with the trunk's floor of cin_lb
    channels (the largest |γ|) and at least one bottleneck channel."""
    ds_m = []
    for j, gam in enumerate(ds):
        m = gam > t
        if m.sum() < cin_lb:
            m = _keep_top(gam, cin_lb)
        if j == len(ds) - 1 and m.sum() < 1:
            m = _keep_top(gam, 1)
        ds_m.append(m)
    blocks_m = [([g > t for g in res], [g > t for g in dw]) for res, dw in blocks]
    us_m = [m if (m := gam > t).sum() >= cin_lb else _keep_top(gam, cin_lb) for gam in us]
    return ds_m, blocks_m, us_m


def _masked_arch(arch: Dict, ds_m, blocks_m, us_m) -> Dict:
    blocks = []
    for b, (res_m, dw_m) in zip(arch["blocks"], blocks_m):
        res = [(int(m.sum()), k) for m, k in zip(res_m, b["res_k"]) if m.sum()]
        dw = [(int(m.sum()), k) for m, k in zip(dw_m, b["dw_k"]) if m.sum()]
        blocks.append({"res": [c for c, _ in res], "res_k": [k for _, k in res],
                       "dw": [c for c, _ in dw], "dw_k": [k for _, k in dw]})
    return {**arch, "ds": [int(m.sum()) for m in ds_m], "us": [int(m.sum()) for m in us_m],
            "blocks": blocks}


def shrink(arch: Dict, p: Dict[str, torch.Tensor], target_macs: float, h: int, w: int,
           cin_lb: int) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """The student of at most ``target_macs`` (the reference's MAC count at
    h x w): the smallest threshold on |γ|, among the values the scales take,
    whose architecture fits the budget; the teacher's weights sliced to the
    channels it keeps."""
    ds, blocks, us = _gammas(p, arch)
    values = np.unique(np.concatenate(ds + [g for r, d in blocks for g in r + d] + us))
    lo, hi = 0, values.size - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if profile_macs(_masked_arch(arch, *_masks(ds, blocks, us, values[mid], cin_lb)),
                        h, w) <= target_macs:
            hi = mid
        else:
            lo = mid + 1
    masks = _masks(ds, blocks, us, float(values[lo]), cin_lb)
    return _masked_arch(arch, *masks), _slice(p, arch, *masks)


def _slice(p: Dict[str, torch.Tensor], arch: Dict, ds_m, blocks_m, us_m) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def idx(m):
        return torch.as_tensor(np.flatnonzero(m), device=next(iter(p.values())).device)

    def conv(src, dst, cin_m, cout_m, transposed=False, depthwise=False):
        w = p[f"{src}.weight"]
        o_dim, i_dim = (1, 0) if transposed else (0, 1)
        if cin_m is not None and not depthwise:
            w = w.index_select(i_dim, idx(cin_m))
        if cout_m is not None:
            w = w.index_select(o_dim, idx(cout_m))
        out[f"{dst}.weight"] = w.clone()
        b = p[f"{src}.bias"]
        out[f"{dst}.bias"] = (b if cout_m is None else b.index_select(0, idx(cout_m))).clone()

    def norm(src, dst, m):
        for k in ("weight", "bias"):
            out[f"{dst}.{k}"] = p[f"{src}.{k}"].index_select(0, idx(m)).clone()

    prev = None
    for j, m in enumerate(ds_m):
        c = "down_sampling.1" if j == 0 else f"down_sampling.{3 * j + 1}"
        conv(c, c, prev, m)
        n = "down_sampling.2" if j == 0 else f"down_sampling.{3 * j + 2}"
        norm(n, n, m)
        prev = m
    dim_m = prev
    for i, (res_m, dw_m) in enumerate(blocks_m):
        pos = 0
        for old, m in enumerate(res_m):
            if not m.sum():
                continue
            src, dst = f"features.{i}.res_ops.{old}", f"features.{i}.res_ops.{pos}"
            conv(f"{src}.1.0", f"{dst}.1.0", dim_m, m)
            norm(f"{src}.1.1", f"{dst}.1.1", m)
            conv(f"{src}.4", f"{dst}.4", m, dim_m)
            pos += 1
        alive = pos
        pos = 0
        for old, m in enumerate(dw_m):
            if not m.sum():
                continue
            src, dst = f"features.{i}.dw_ops.{old}", f"features.{i}.dw_ops.{pos}"
            conv(f"{src}.0.0", f"{dst}.0.0", dim_m, m)
            norm(f"{src}.0.1", f"{dst}.0.1", m)
            conv(f"{src}.2.0", f"{dst}.2.0", None, m, depthwise=True)
            norm(f"{src}.2.1", f"{dst}.2.1", m)
            conv(f"{src}.4", f"{dst}.4", m, dim_m)
            pos += 1
        if alive + pos:
            norm(f"features.{i}.pw_bn", f"features.{i}.pw_bn", dim_m)
    prev = dim_m
    for j, m in enumerate(us_m):
        conv(f"up_sampling.{3 * j}", f"up_sampling.{3 * j}", prev, m, transposed=True)
        norm(f"up_sampling.{3 * j + 1}", f"up_sampling.{3 * j + 1}", m)
        prev = m
    head = f"up_sampling.{3 * len(us_m) + 1}"
    conv(head, head, prev, None)
    return out


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


class Adam:
    """Adam as CAT's optax chain applies it: bias-corrected moments, eps
    outside the square root, the learning rate applied last."""

    def __init__(self, params: Dict[str, torch.Tensor], beta1: float, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.params, self.b1, self.b2, self.eps = params, beta1, beta2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            m_hat = self.mu[k] / (1 - self.b1 ** self.t)
            v_hat = self.nu[k] / (1 - self.b2 ** self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def run_steps(teacher_p: Dict[str, torch.Tensor], teacher: Dict, student_p: Dict[str, torch.Tensor],
              student: Dict, d_p: Dict[str, torch.Tensor], n_layers_d: int,
              batches: List[Dict[str, torch.Tensor]], hp: Dict, lr: float,
              precision: Optional[Dict] = None) -> Dict:
    """The unaligned KA-distillation steps of CAT on ``batches`` (one step
    each), from the given weights, in float32.  Each step: the frozen
    teacher's image and taps; the student's; D's update on the detached fake
    and the real B, 0.5·(lsgan(fake, 0) + lsgan(real, 1)); the student's
    update through the updated D, lsgan(D(fake), 1)·λ_gan + λ_recon·L1(fake,
    teacher's image) + λ_distill·Σ -KA(student tap, teacher tap).

    Returns each step's losses, each leaf's first gradient norm ("G:name",
    "D:name") and each leaf's change after the steps.  ``precision`` (the
    control's: ``{"precision": dtype, "grad_precision": dtype}``) rounds
    every convolution's and Gram's operands, and the gradients the
    convolutions' backwards take, to those dtypes."""
    prec = precision or {}
    q = quantiser(prec.get("precision"), prec.get("grad_precision"))
    with exact_float32():
        tp = {k: v.float() for k, v in teacher_p.items()}
        sp = {k: v.float().clone().requires_grad_(True) for k, v in student_p.items()}
        dp = {k: v.float().clone().requires_grad_(True) for k, v in d_p.items()}
        start = {**{f"G:{k}": v.detach().clone() for k, v in sp.items()},
                 **{f"D:{k}": v.detach().clone() for k, v in dp.items()}}
        opt_g, opt_d = Adam(sp, hp["beta1"]), Adam(dp, hp["beta1"])
        taps = hp["taps"]
        losses, first_grads = [], {}
        for batch in batches:
            real_a, real_b = batch["A"].float(), batch["B"].float()
            with torch.no_grad():
                t_fake, t_acts = generator(tp, teacher, real_a, taps, q)
            s_fake, s_acts = generator(sp, student, real_a, taps, q)
            fake = s_fake.detach()
            l_d_fake = nlayer(dp, n_layers_d, fake, q).square().mean()
            l_d_real = (nlayer(dp, n_layers_d, real_b, q) - 1.0).square().mean()
            d_grads = torch.autograd.grad(0.5 * (l_d_fake + l_d_real), list(dp.values()))
            d_grads = dict(zip(dp, d_grads))
            opt_d.step(d_grads, lr)
            d_now = {k: v.detach() for k, v in dp.items()}
            l_gan = (nlayer(d_now, n_layers_d, s_fake, q) - 1.0).square().mean() * hp["lambda_gan"]
            l_rec = (s_fake - t_fake).abs().mean() * hp["lambda_recon"]
            parts = {f"Specific_loss/distill{i}": -ka(s_acts[t], t_acts[t], q)
                     for i, t in enumerate(taps)}
            l_dis = sum(parts.values()) * hp["lambda_distill"]
            g_grads = dict(zip(sp, torch.autograd.grad(l_gan + l_rec + l_dis, list(sp.values()))))
            opt_g.step(g_grads, lr)
            if not first_grads:
                first_grads = {**{f"G:{k}": v for k, v in leaf_norms(g_grads).items()},
                               **{f"D:{k}": v for k, v in leaf_norms(d_grads).items()}}
            losses.append({k: float(v.detach()) for k, v in {
                "G_loss/gan": l_gan, "G_loss/recon": l_rec, "G_loss/distill": l_dis,
                "D_loss/fake": l_d_fake, "D_loss/real": l_d_real, **parts}.items()})
            del s_fake, s_acts, t_fake, t_acts
        end = {**{f"G:{k}": v.detach() for k, v in sp.items()},
               **{f"D:{k}": v.detach() for k, v in dp.items()}}
        change = {k: float((end[k] - start[k]).double().norm()) for k in start}
    return {"losses": losses, "first_grad": first_grads, "change": change}
