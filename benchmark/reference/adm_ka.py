"""Plain PyTorch reference of the KA distillation of ADM's UNet
(openai/guided-diffusion ``UNetModel``, image-conditioned as Palette) into
a narrower one: the step that ``cat_tpu_torch``'s
``GenericDistiller.train_step`` computes on ``models/adm.py``, written from
guided-diffusion's layer equations alone.

It imports nothing of the program.  Float32 throughout, TF32 off; every
layer written out: GroupNorm from its formula (32 groups, biased variance,
eps 1e-5), attention as an explicit softmax(QKᵀ/√d)·V in ADM's legacy QKV
layout, the timestep's [cos, sin] sinusoid, KA from its definition, Adam
as the JAX package applies it (``inception_ka.py``).  The blocks are
``yardstick/adm.py``'s; the weights are dicts under guided-diffusion's
module names.  The student's blocks are checkpointed (exact recomputation
in float32), so a batch of 16 at 256 px fits on one card.

A net is a dict in ``yardstick/adm.py``'s form (``image_size``,
``in_channels``, ``model_channels``, ``out_channels``, ``num_res_blocks``,
``attention_resolutions``, ``channel_mult``, ``num_head_channels``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.inception_ka import Adam, exact_float32, ka, leaf_norms, quantiser
from benchmark.trace import import_stdlib_profile
from benchmark.yardstick.adm import GROUPS, blocks

EPS = 1e-5


def shapes(net: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every parameter: name -> (shape, kind), kind "conv" (a conv's or a
    linear's kernel), "bias", "scale" (a GroupNorm's γ) or "shift" (its β)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def kernel(name, shape):
        out[f"{name}.weight"] = (tuple(shape), "conv")
        out[f"{name}.bias"] = ((shape[0],), "bias")

    def norm(name, c):
        out[f"{name}.weight"] = ((c,), "scale")
        out[f"{name}.bias"] = ((c,), "shift")

    mc = net["model_channels"]
    emb = 4 * mc
    kernel("time_embed.0", (emb, mc))
    kernel("time_embed.2", (emb, emb))
    for name, layers in blocks(net, net["image_size"]):
        for j, layer in enumerate(layers):
            pre = f"{name}.{j}"
            if layer[0] == "conv":
                kernel(pre, (layer[2], layer[1], 3, 3))
            elif layer[0] == "res":
                cin, cout = layer[1], layer[2]
                norm(f"{pre}.in_layers.0", cin)
                kernel(f"{pre}.in_layers.2", (cout, cin, 3, 3))
                kernel(f"{pre}.emb_layers.1", (2 * cout, emb))
                norm(f"{pre}.out_layers.0", cout)
                kernel(f"{pre}.out_layers.3", (cout, cout, 3, 3))
                if cin != cout:
                    kernel(f"{pre}.skip_connection", (cout, cin, 1, 1))
            else:
                c = layer[1]
                norm(f"{pre}.norm", c)
                kernel(f"{pre}.qkv", (3 * c, c, 1))
                kernel(f"{pre}.proj_out", (c, c, 1))
    ch0 = mc * net["channel_mult"][0]
    norm("out.0", ch0)
    kernel("out.2", (net["out_channels"], ch0, 3, 3))
    return out


def stds(shape_of: Dict[str, Tuple[Tuple[int, ...], str]]) -> Dict[str, float]:
    """Each kernel's std, 1/√fan_in (fan_in: the input channels times the
    kernel's taps), so that every branch, ADM's zero-initialised output
    convs included, carries signal of the order of its input."""
    return {k: 1.0 / math.sqrt(math.prod(s[1:])) for k, (s, kind) in shape_of.items()
            if kind == "conv"}


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos, sin] of t·exp(-ln(10000)·i/half), i < half, in float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GroupNorm(32) over (N, C, ...): each group of C/32 channels and all
    positions normalised by its mean and biased variance, then γ, β."""
    n, c = x.shape[:2]
    xg = x.reshape(n, GROUPS, -1)
    mean = xg.mean(-1, keepdim=True)
    var = (xg - mean).square().mean(-1, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    per_channel = (1, c) + (1,) * (x.dim() - 2)
    return y * w.reshape(per_channel) + b.reshape(per_channel)


def attention(qkv: torch.Tensor, heads: int, q=None) -> torch.Tensor:
    """ADM's legacy QKV attention: qkv (B, 3·heads·d, T) read as
    (B·heads, 3d, T), split into q, k, v; softmax(qᵀk/√d) over the keys,
    applied to v; (B, heads·d, T).  ``q`` rounds each product's operands."""
    q = q or (lambda z: z)
    b, width, t = qkv.shape
    d = width // (3 * heads)
    qh, kh, vh = qkv.reshape(b * heads, 3 * d, t).split(d, dim=1)
    w = torch.einsum("bct,bcs->bts", q(qh), q(kh)) / math.sqrt(d)
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bts,bcs->bct", q(w), q(vh)).reshape(b, heads * d, t)


def _resample(x: torch.Tensor, how: str) -> torch.Tensor:
    if how == "down":
        return F.avg_pool2d(x, 2)
    if how == "up":
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x


def unet(p: Dict[str, torch.Tensor], net: Dict, x: torch.Tensor, t: torch.Tensor,
         taps: Sequence[str] = (), q=(None, None), remat: bool = False
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ε and the taps (each named block's output).  ``q``: the control's
    rounding (``inception_ka.py::quantiser``) of every conv's, linear's and
    attention product's operands.  ``remat``: each block checkpointed."""
    qf, gq = q[0] or (lambda z: z), q[1] or (lambda z: z)

    def conv(h, name, pad):
        w = p[f"{name}.weight"]
        fn = F.conv1d if w.dim() == 3 else F.conv2d
        return gq(fn(qf(h), qf(w), p[f"{name}.bias"], padding=pad))

    def linear(h, name):
        return gq(F.linear(qf(h), qf(p[f"{name}.weight"]), p[f"{name}.bias"]))

    def gn(h, name):
        return group_norm(h, p[f"{name}.weight"], p[f"{name}.bias"])

    def res(h, emb, pre, layer):
        _, cin, cout, _, resample = layer
        r = _resample(F.silu(gn(h, f"{pre}.in_layers.0")), resample)
        r = conv(r, f"{pre}.in_layers.2", 1)
        h = _resample(h, resample)
        scale, shift = linear(F.silu(emb), f"{pre}.emb_layers.1")[..., None, None].chunk(2, 1)
        r = gn(r, f"{pre}.out_layers.0") * (1 + scale) + shift
        r = conv(F.silu(r), f"{pre}.out_layers.3", 1)
        return (conv(h, f"{pre}.skip_connection", 0) if cin != cout else h) + r

    def attn(h, pre, layer):
        b, c, hh, ww = h.shape
        hf = h.reshape(b, c, hh * ww)
        a = attention(conv(gn(hf, f"{pre}.norm"), f"{pre}.qkv", 0), layer[3], qf)
        return (hf + conv(a, f"{pre}.proj_out", 0)).reshape(b, c, hh, ww)

    def block(name, layers):
        def run(h, emb):
            for j, layer in enumerate(layers):
                pre = f"{name}.{j}"
                if layer[0] == "conv":
                    h = conv(h, pre, 1)
                elif layer[0] == "res":
                    h = res(h, emb, pre, layer)
                else:
                    h = attn(h, pre, layer)
            return h
        if remat:
            return lambda h, emb: checkpoint(run, h, emb, use_reentrant=False)
        return run

    emb = linear(F.silu(linear(timestep_embedding(t, net["model_channels"]), "time_embed.0")),
                 "time_embed.2")
    acts, hs = {}, []
    h = x
    for name, layers in blocks(net, x.shape[-1]):
        if name.startswith("output"):
            h = torch.cat([h, hs.pop()], 1)
        h = block(name, layers)(h, emb)
        if name.startswith("input"):
            hs.append(h)
        if name in taps:
            acts[name] = h
    return conv(F.silu(gn(h, "out.0")), "out.2", 1), acts


def run_steps(teacher_p: Dict[str, torch.Tensor], teacher: Dict,
              student_p: Dict[str, torch.Tensor], student: Dict,
              batches: List[Tuple[torch.Tensor, torch.Tensor]], hp: Dict, lr: float,
              precision: Optional[Dict] = None) -> Dict:
    """The KA-distillation steps on ``batches`` ((x, t) each; one step
    each) from the given weights: the frozen teacher's ε and taps; the
    student's; the loss λ_recon·mean((ε_s - ε_t)²) + λ_distill·Σ -KA(student
    tap, teacher tap); Adam on the student alone.

    Returns each step's losses, each leaf's first gradient norm ("G:name")
    and each leaf's change after the steps.  ``precision`` (the control's:
    ``{"precision": dtype, "grad_precision": dtype}``) rounds every
    product's operands, and the gradients the convolutions' and linears'
    backwards take, to those dtypes."""
    prec = precision or {}
    q = quantiser(prec.get("precision"), prec.get("grad_precision"))
    taps = hp["taps"]
    import_stdlib_profile()  # checkpoint loads TorchDynamo, which reaches ``profile``
    with exact_float32():
        tp = {k: v.float() for k, v in teacher_p.items()}
        sp = {k: v.float().clone().requires_grad_(True) for k, v in student_p.items()}
        start = {k: v.detach().clone() for k, v in sp.items()}
        opt = Adam(sp, hp["beta1"], hp["beta2"])
        losses, first = [], {}
        for x, t in batches:
            with torch.no_grad():
                t_eps, t_acts = unet(tp, teacher, x.float(), t, taps, q)
            s_eps, s_acts = unet(sp, student, x.float(), t, taps, q, remat=True)
            l_rec = (s_eps - t_eps).square().mean() * hp["lambda_recon"]
            parts = {f"Specific_loss/distill{i}": -ka(s_acts[k], t_acts[k], q)
                     for i, k in enumerate(taps)}
            l_dis = sum(parts.values()) * hp["lambda_distill"]
            grads = dict(zip(sp, torch.autograd.grad(l_rec + l_dis, list(sp.values()))))
            opt.step(grads, lr)
            if not first:
                first = {f"G:{k}": v for k, v in leaf_norms(grads).items()}
            losses.append({k: float(v.detach()) for k, v in {
                "G_loss/recon": l_rec, "G_loss/distill": l_dis, **parts}.items()})
            del grads, s_eps, s_acts, t_eps, t_acts
        change = {f"G:{k}": float((v.detach() - start[k]).double().norm())
                  for k, v in sp.items()}
    return {"losses": losses, "first_grad": first, "change": change}
