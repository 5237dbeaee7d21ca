"""Percent of its bound that the bf16 attention backward (`delta_kernel`
then `bwd_kernel`, `csrc/flash_attention_bwd.cu`) reached in the traced
train steps: `bounds.attention_backward_bound` summed over the shape
denoiser's self-attention sites that the forward kernel serves (K1, at
least KERNEL_MIN_TOKENS tokens, at the shape sub-batch's rows), over the
two kernels' device time.  A launch count that differs from those sites
reads nothing."""

from portbench import bounds

KERNELS = r"\b(delta_kernel|bwd_kernel)\b"
KERNEL_MIN_TOKENS = 512


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    unet = run.cfg["shape_branch"]["unet"]
    r, mc, heads = unet["image_size"], unet["model_channels"], \
        unet["num_heads"]
    sites, ds = [], 1
    for level, m in enumerate(unet["channel_mult"]):
        n = 2 * unet["num_res_blocks"] + 1 + (
            level == len(unet["channel_mult"]) - 1)
        tokens = r * (r // ds) ** 2
        if ds in unet["attention_resolutions"] and \
                tokens >= KERNEL_MIN_TOKENS:
            sites += [(run.mix["shape_rows"], tokens, heads,
                       m * mc // heads)] * n
        ds *= 2
    steps = tr.span_count("optimizer")
    got = tr.in_span("forward_backward", KERNELS)
    if not steps or len(got) != 2 * len(sites) * steps:
        return None
    bound_ms = steps * sum(bounds.attention_backward_bound(*s)["ms"]
                           for s in sites)
    return 100.0 * bound_ms / (sum(e - s for _, s, e, _ in got) / 1e6)
