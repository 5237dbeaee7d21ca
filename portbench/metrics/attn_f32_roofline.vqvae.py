"""Percent of its bound that the float32 attention forward K2
(`attention_tf32x3_kernel` with its `split_k` / `split_vt` pre-pass,
`csrc/flash_attention_tf32x3.cu`) reached in the traced VQ-VAE train
steps: `bounds.attention_bound` of the encoder's and the decoder's middle
attention, CALLS a step at (batch, tokens of the lowest resolution, 1
head, its channels), over those kernels' device time in the `vqvae_step`
spans.  The bound is the bf16 tensor cores' (that of
`attn_fwd_roofline.gen`), so that no arithmetic of float32 products can
read over 100%.  A launch count of the main kernel other than CALLS a step
means the routing moved: the metric then reads nothing."""

from portbench import bounds

KERNEL = r"\battention_tf32x3_kernel\b"
PREPASS = r"\bsplit_(k|vt)\b"
CALLS = 2


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    steps = tr.span_count("vqvae_step")
    main = tr.in_span("vqvae_step", KERNEL)
    if not steps or len(main) != CALLS * steps:
        return None
    dd = run.cfg["model"]["params"]["ddconfig"]
    side = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
    site = (run.mix["batch"], side ** 3, 1, dd["ch"] * dd["ch_mult"][-1])
    got = main + tr.in_span("vqvae_step", PREPASS)
    device_ms = sum(e - s for _, s, e, _ in got) / 1e6
    return 100.0 * CALLS * steps * bounds.attention_bound(*site)["ms"] \
        / device_ms
