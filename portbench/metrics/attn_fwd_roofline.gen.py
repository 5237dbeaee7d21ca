"""Percent of their bound that the attention forward kernels K1 / K2
(`attention_kernel`, `csrc/flash_attention.cu`) reached in the traced
generation: the sum of `bounds.attention_bound` over the logical attention
calls they serve, over their device time.

The calls: the shape denoiser's self-attention sites of at least
KERNEL_MIN_TOKENS tokens (K1; the program routes shorter ones to plain
PyTorch) in each shape step, and the VQ decoder's mid attention (K2) in
each decode chunk.  A launch count that differs from those calls means the
routing moved: the metric then reads nothing."""

from portbench import bounds
from portbench.generate import DECODE_CHUNK

KERNEL = r"\battention_kernel\b"
KERNEL_MIN_TOKENS = 512


def shape_sites(unet, rows):
    """(b, l, h, d) of each self-attention site of one shape step."""
    r, mc = unet["image_size"], unet["model_channels"]
    mult, attn = unet["channel_mult"], unet["attention_resolutions"]
    out, ds = [], 1
    for level, m in enumerate(mult):
        n = unet["num_res_blocks"] + (unet["num_res_blocks"] + 1)
        if level == len(mult) - 1:
            n += 1                                  # the middle block's
        if ds in attn:
            tokens = r * (r // ds) ** 2
            heads = unet["num_heads"]
            out += [(rows, tokens, heads, m * mc // heads)] * n
        ds *= 2
    return out


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    unet = run.cfg["shape_branch"]["unet"]
    vq = run.cfg["shape_branch"]["vqvae"]["ddconfig"]
    k1 = [s for s in shape_sites(unet, run.rows)
          if s[1] >= KERNEL_MIN_TOKENS]
    chunk = DECODE_CHUNK
    side = vq["resolution"] // 2 ** (len(vq["ch_mult"]) - 1)
    k2 = (chunk, side ** 3, 1, vq["ch"] * vq["ch_mult"][-1])
    shape_steps = tr.span_count("shape_eps")
    chunks = tr.span_count("decode_latent")
    got_k1 = tr.in_span("shape_eps", KERNEL)
    got_k2 = tr.in_span("decode_latent", KERNEL)
    if (len(got_k1) != len(k1) * shape_steps or len(got_k2) != chunks
            or not got_k1 + got_k2):
        return None
    bound_ms = (shape_steps * sum(bounds.attention_bound(*s)["ms"]
                                  for s in k1)
                + chunks * bounds.attention_bound(*k2)["ms"])
    device_ms = sum(e - s for _, s, e, _ in got_k1 + got_k2) / 1e6
    return 100.0 * bound_ms / device_ms
