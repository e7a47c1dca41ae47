"""The work of ADM's UNet (openai/guided-diffusion ``UNetModel``), worked
out from a configuration: its blocks, multiply-adds, attention sites and
GroupNorm sites, and one KA-distillation step's operations.

Frozen arithmetic, as ``flops.py``: what the algorithm needs, whatever
implements it.  A configuration is a dict with guided-diffusion's names:
``image_size``, ``in_channels``, ``model_channels``, ``out_channels``,
``num_res_blocks``, ``attention_resolutions`` (pixels: 32 means attention
at 32 x 32 for ``image_size``), ``channel_mult`` and
``num_head_channels``; res blocks resample inside (``resblock_updown``)
and take the timestep's scale and shift (``use_scale_shift_norm``).

A block is ``(name, layers)`` with guided-diffusion's module name; a layer
is ``("conv", cin, cout, k, hw)`` (the stem), ``("res", cin, cout, hw,
resample)`` (``hw`` its input's side, ``resample`` "", "down" or "up") or
``("attn", channels, hw, heads)``.  Output blocks' res layers take the skip
concatenated to their input, counted in ``cin``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from benchmark.yardstick.flops import gram_flops, ka_backward_flops
from benchmark.yardstick.roofline import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS

GROUPS = 32  # ADM's GroupNorm32


def _attention_hw(cfg: Dict, size: int) -> set:
    """The sides at which the net attends when run at ``size`` px: the
    downsampling factors of ``attention_resolutions`` at ``image_size``."""
    return {size // (cfg["image_size"] // r) for r in cfg["attention_resolutions"]}


def blocks(cfg: Dict, size: int) -> List[Tuple[str, List[Tuple]]]:
    """Every block of the UNet run at ``size`` px, in forward order:
    ``input_blocks.*``, ``middle_block``, ``output_blocks.*``."""
    mc, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    attend = _attention_hw(cfg, size)

    def attn(ch, hw):
        return [("attn", ch, hw, ch // cfg["num_head_channels"])] if hw in attend else []

    out: List[Tuple[str, List[Tuple]]] = []
    ch, hw = mc * mult[0], size
    out.append(("input_blocks.0", [("conv", cfg["in_channels"], ch, 3, hw)]))
    skips = [ch]
    for level, m in enumerate(mult):
        for _ in range(nrb):
            layers = [("res", ch, mc * m, hw, "")] + attn(mc * m, hw)
            ch = mc * m
            out.append((f"input_blocks.{len(out)}", layers))
            skips.append(ch)
        if level != len(mult) - 1:
            out.append((f"input_blocks.{len(out)}", [("res", ch, ch, hw, "down")]))
            hw //= 2
            skips.append(ch)
    out.append(("middle_block", [("res", ch, ch, hw, ""), ("attn", ch, hw,
                                                           ch // cfg["num_head_channels"]),
                                 ("res", ch, ch, hw, "")]))
    k = 0
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            layers = [("res", ch + skips.pop(), mc * m, hw, "")] + attn(mc * m, hw)
            ch = mc * m
            if level and i == nrb:
                layers.append(("res", ch, ch, hw, "up"))
                hw *= 2
            out.append((f"output_blocks.{k}", layers))
            k += 1
    return out


def _out_hw(hw: int, resample: str) -> int:
    return hw // 2 if resample == "down" else hw * 2 if resample == "up" else hw


def block_output(cfg: Dict, size: int) -> Dict[str, Tuple[int, int]]:
    """Each block's output (channels, side): a tap's width is C·side²."""
    out = {}
    for name, layers in blocks(cfg, size):
        last = layers[-1]
        if last[0] == "conv":
            out[name] = (last[2], last[4])
        elif last[0] == "res":
            out[name] = (last[2], _out_hw(last[3], last[4]))
        else:
            out[name] = (last[1], last[2])
    return out


def tap_values(cfg: Dict, size: int, taps: Sequence[str]) -> Dict[str, int]:
    """Values of each tap per image."""
    shapes = block_output(cfg, size)
    return {t: shapes[t][0] * shapes[t][1] ** 2 for t in taps}


def net_macs(cfg: Dict, size: int) -> Dict[str, int]:
    """One image's forward multiply-adds by part: ``stem`` (its input takes
    no gradient), ``time_in`` (the time MLP's first linear, on the
    sinusoid: no input gradient either), ``convs`` (every other conv and
    linear: res blocks' 3x3s and 1x1 skips, the timestep's scale-shift
    linears, attention's qkv and proj, the time MLP's second linear, the
    head) and ``attention`` (QKᵀ and AV)."""
    mc, emb = cfg["model_channels"], 4 * cfg["model_channels"]
    parts = {"stem": 0, "time_in": mc * emb, "convs": emb * emb, "attention": 0}
    for _, layers in blocks(cfg, size):
        for layer in layers:
            if layer[0] == "conv":
                _, cin, cout, k, hw = layer
                parts["stem"] += cin * cout * k * k * hw * hw
            elif layer[0] == "res":
                _, cin, cout, hw, resample = layer
                o = _out_hw(hw, resample) ** 2
                parts["convs"] += (cin * cout + cout * cout) * 9 * o + emb * 2 * cout
                if cin != cout:
                    parts["convs"] += cin * cout * o
            else:
                _, c, hw, _ = layer
                t = hw * hw
                parts["convs"] += 4 * c * c * t
                parts["attention"] += 2 * t * t * c
    ch0 = cfg["model_channels"] * cfg["channel_mult"][0]
    parts["convs"] += ch0 * cfg["out_channels"] * 9 * size * size
    return parts


def forward_macs(cfg: Dict, size: int) -> int:
    return sum(net_macs(cfg, size).values())


def train_macs(cfg: Dict, size: int) -> int:
    """A forward and backward: the forward, every weight's gradient, and
    every input gradient but the stem's and the first time linear's (their
    inputs, the image and the sinusoid, take none); attention's backward
    is twice its forward (dQ, dK, dV and dP)."""
    p = net_macs(cfg, size)
    return 3 * sum(p.values()) - p["stem"] - p["time_in"]


def attention_sites(cfg: Dict, size: int) -> List[Tuple[int, int, int]]:
    """Each attention block's (heads, tokens, head width) per image."""
    return [(layer[3], layer[2] ** 2, layer[1] // layer[3]) for _, layers in blocks(cfg, size)
            for layer in layers if layer[0] == "attn"]


def group_norm_values(cfg: Dict, size: int) -> List[int]:
    """Values each GroupNorm normalises per image, in forward order: two in
    a res block (its input; its conv's output, at the resampled side), one
    in an attention block, one in the head."""
    out = []
    for _, layers in blocks(cfg, size):
        for layer in layers:
            if layer[0] == "res":
                _, cin, cout, hw, resample = layer
                out += [cin * hw * hw, cout * _out_hw(hw, resample) ** 2]
            elif layer[0] == "attn":
                out.append(layer[1] * layer[2] ** 2)
    ch0 = cfg["model_channels"] * cfg["channel_mult"][0]
    return out + [ch0 * size * size]


def ka_step_flops(teacher: Dict, student: Dict, batch: int, size: int,
                  taps: Sequence[str]) -> int:
    """Operations of one KA-distillation step of ``GenericDistiller``: the
    teacher's forward, the student's forward and backward, and per tap the
    two Grams and KA's backward into the student's tap."""
    flops = 2 * batch * (forward_macs(teacher, size) + train_macs(student, size))
    t_taps, s_taps = tap_values(teacher, size, taps), tap_values(student, size, taps)
    for tap in taps:
        flops += gram_flops(batch, t_taps[tap]) + gram_flops(batch, s_taps[tap])
        flops += ka_backward_flops(batch, s_taps[tap])
    return flops


def attention_bound_s(bh: int, t: int, d: int, dtype: str, backward: bool) -> float:
    """Attention over ``bh`` (batch x heads) rows of ``t`` tokens of width
    ``d``: forward 4·bh·t²·d operations (QKᵀ and PV) with Q, K, V read and
    O written; backward 8·bh·t²·d (dV, dP, dQ, dK) with Q, K, V, O and dO
    read and dQ, dK, dV written; the larger of the operations at the
    dtype's peak and the bytes at HBM's rate (``roofline.py``)."""
    ops = (8 if backward else 4) * bh * t * t * d
    tensors = 8 if backward else 4
    return max(ops / PEAK_FLOPS[dtype], tensors * bh * t * d * ITEMSIZE[dtype] / HBM_BYTES_PER_S)
