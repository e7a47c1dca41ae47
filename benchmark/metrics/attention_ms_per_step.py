"""Device time a step of the attention kernels that
``F.scaled_dot_product_attention`` launches, forward and backward, found by
name (``NAMES``: substrings of the lower-cased kernel name): cuDNN's
(``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_*``/``_bprop_*``, what
PyTorch 2.11 picks on the H100 for bf16 heads of 64), FlashAttention-2's
(``flash_fwd_*``, ``flash_bwd_*``) and the memory-efficient ones
(``fmha_cutlass*``).  In the frozen groups of ``yardstick/kernel_groups.py``
they fall among the convolutions or in "other".  Nothing to read where the
cell runs no attention."""

NAMES = ("sdpa", "flash_fwd", "flash_bwd", "fmha")


def attention_ns(tl):
    """The traced window's attention kernel time, in ns."""
    return sum(e - s for n, s, e in tl.kernels() if any(k in n.lower() for k in NAMES))


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.steps:
        return None
    ns = attention_ns(tl)
    return ns / 1e6 / tl.steps if ns else None
