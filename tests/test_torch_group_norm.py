"""The shape torso's fused GroupNorm (+ shift) + activation
(`echoscene_torch/kernels/group_norm.py`, `nn.blocks.group_norm_act`).

On the CPU: the kernel's plain version is the code it replaces (the norm
module, then nn.SiLU or RoundedSiLU) bit for bit; the dispatch rule keeps
the plain path for each input on which the kernel would compute another
function, and for no other; the list of the torso's norms that the model
gives on the meta device is the one a shape step runs.  On the card (`cuda`-marked;
no JAX here, so `python -m pytest tests/test_torch_group_norm.py -m cuda
--noconftest` runs them there): the kernel against the plain path at every
norm shape of the flagship's shape step at 272 rows, and one generation
call of each benchmark cell inside the correctness check's limits.
"""
import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch
from torch import nn

from echoscene_torch.kernels import group_norm as gnk
from echoscene_torch.models.config import ShapeDenoiserConfig
from echoscene_torch.nn import blocks
from echoscene_torch.nn.quant import RoundedSiLU
from echoscene_torch.nn.unet3d import torso_norm_sites

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the torso at test widths: 32 groups of 2-6 channels, three levels
TEST_WIDTHS = ShapeDenoiserConfig(image_size=8, model_channels=64,
                                  channel_mult=(1, 2, 3))
TEST_SITES = torso_norm_sites(TEST_WIDTHS, 2)
FLAGSHIP_ROWS = 272
FLAGSHIP_SITES = torso_norm_sites(ShapeDenoiserConfig(), FLAGSHIP_ROWS)
ACT_MODULES = {"none": None, "silu": nn.SiLU(),
               "rounded_silu": RoundedSiLU()}


@pytest.mark.parametrize("fault", [None, "weight", "mean", "activation",
                                   "truncation"])
def test_gap_to_plain_rejects_faults(fault, monkeypatch):
    """The card's yardstick on the CPU, the kernel stood in for by the
    plain version: sound, it passes; with one channel's weight 1% off, the
    slab's mean moved by 2^-12 of its std, or the f32 norm truncated to
    bf16 instead of rounded to nearest, the norm fails its bound;
    computing SiLU where RoundedSiLU was asked, the activation is not
    exact."""
    site = dict(name="gap", x_shape=(2, 96, 4, 8, 8), eps=1e-5)
    x, norm, shift = _inputs(site, torch.bfloat16, "rounded_silu", True)
    sound = gnk.group_norm_act
    off = float(x.float().std()) * 2.0 ** -12

    def faulty(x, groups, eps, weight, bias, shift, act):
        if fault == "weight":
            weight = weight.clone()
            weight[5] *= 1.01
        elif fault == "mean":
            # a mean moved by `off` shifts each output by -a_c * off
            bias = bias.float() - weight.float() * off / x.float().std()
        elif fault == "activation" and act == "rounded_silu":
            act = "silu"
        elif fault == "truncation":
            y = gnk.group_norm_act_plain(x.float(), groups, eps, weight,
                                         bias, shift)
            y = (y.view(torch.int32) & -65536).view(torch.float32)
            return gnk.activation_plain(y.to(torch.bfloat16), act)
        return sound(x, groups, eps, weight, bias, shift, act)
    monkeypatch.setattr(gnk, "group_norm_act", faulty)
    got = gnk.group_norm_act(x, 32, 1e-5, norm.weight, norm.bias, shift,
                             "rounded_silu")
    gap = gnk.gap_to_plain(x, 32, 1e-5, norm.weight, norm.bias, shift,
                           "rounded_silu", got)
    if fault is None:
        # the plain norm's own rounding: at most half a bf16 ulp, inside
        # the bound by its term for the statistics
        assert gap["norm_of_bound"] < 1.0
        assert gap["act_exact"] and gap["max_ulps"] == gap["differ"] == 0
    elif fault == "activation":
        assert gap["norm_of_bound"] < 1.0 and not gap["act_exact"]
    else:
        assert gap["norm_of_bound"] > 1.0


def _site_id(site):
    return "{}x{}".format(site["name"].replace(" ", "_"),
                          "x".join(map(str, site["x_shape"])))


def _inputs(site, dtype, act, with_shift, device="cpu", seed=0):
    """x (scaled and offset as a torso's activations are), a GroupNorm32
    of the site's channels with drawn parameters (f32 where the int8 twin
    keeps them, i.e. before a RoundedSiLU; else x's dtype) and a shift."""
    gen = torch.Generator().manual_seed(seed)
    shape = site["x_shape"]
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen) * 2.5 + 0.3).to(dtype)
    norm = blocks.GroupNorm32(c, eps=site["eps"])
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.2 * torch.randn(c, generator=gen))
    norm = norm.to(torch.float32 if act == "rounded_silu" else dtype)
    norm.requires_grad_(False)
    shift = (torch.randn((n, c), generator=gen).to(dtype) if with_shift
             else None)
    return x.to(device), norm.to(device), (
        None if shift is None else shift.to(device))


def _modules(x, norm, act, shift):
    """Today's code: the norm module, then the activation module."""
    h = norm(x, shift=shift)
    return h if ACT_MODULES[act] is None else ACT_MODULES[act](h)


@pytest.mark.parametrize("act", sorted(gnk.ACTS))
@pytest.mark.parametrize("with_shift", [False, True],
                         ids=["no_shift", "shift"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("site", TEST_SITES, ids=_site_id)
def test_plain_is_the_modules(site, dtype, with_shift, act):
    """`group_norm_act_plain` and `blocks.group_norm_act` on the CPU equal
    the norm module followed by nn.SiLU / RoundedSiLU, bit for bit."""
    x, norm, shift = _inputs(site, dtype, act, with_shift)
    want = _modules(x, norm, act, shift)
    plain = gnk.group_norm_act_plain(x, norm.num_groups, norm.eps,
                                     norm.weight, norm.bias, shift, act)
    got = blocks.group_norm_act(x, norm, ACT_MODULES[act], shift=shift)
    assert want.dtype == plain.dtype == got.dtype == dtype
    assert torch.equal(plain, want)
    assert torch.equal(got, want)


def _dispatch_case(case):
    """(x, norm, act, shift) of one dispatch case, and the reason the rule
    must give."""
    site = dict(name="n", x_shape=(2, 64, 4, 8, 8), eps=1e-5)
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    if case == "one spatial dim":
        site["x_shape"] = (2, 64, 1)
    elif case == "slab too large":
        site["x_shape"] = (1, 64, 16, 64, 64)     # 2 x 65,536 per slab
    elif case == "positions not a multiple of 8":
        site["x_shape"] = (2, 64, 3, 3, 3)
    x, norm, shift = _inputs(site, dtype, "silu", True)
    if case == "not contiguous":
        x = x.to(memory_format=torch.channels_last_3d)
    act = nn.GELU() if case == "other activation" else ACT_MODULES["silu"]
    if case == "autograd records":
        norm.requires_grad_(True)
    want = {"cpu": "not CUDA", "float32": "not bfloat16",
            "autograd records": "autograd records",
            "one spatial dim": "1 spatial dims",
            "other activation": "activation GELU"}.get(case, "not CUDA")
    return x, norm, act, shift, want


# what `unfit` says of the inputs the kernel does not take as they are:
# on the card it raises on the first two, and `blocks.group_norm_act`
# makes the third contiguous for it
UNFIT = {"slab too large": "does not fit",
         "positions not a multiple of 8": "not a multiple of 8",
         "not contiguous": "not contiguous"}


@pytest.mark.parametrize("case", [
    "cpu", "float32", "autograd records", "one spatial dim",
    "slab too large", "positions not a multiple of 8", "other activation",
    "not contiguous"])
def test_dispatch_rule_keeps_the_plain_path(case):
    """The rule names why the plain path is taken (each reason shows on
    the CPU: the device is checked last), and the plain path gives the
    modules' result.  An input the kernel cannot take as it is, is no
    reason: only the device keeps it from the kernel (`UNFIT`)."""
    x, norm, act, shift, want = _dispatch_case(case)
    assert want in blocks.plain_reason(x, norm, act, shift)
    if case in UNFIT:
        assert UNFIT[case] in gnk.unfit(x, norm.num_groups)
    with torch.no_grad():
        if case == "autograd records":
            # without autograd the input only misses the card
            assert "not CUDA" in blocks.plain_reason(x, norm, act, shift)
        h = norm(x, shift=shift)
        expect = act(h)
    got = blocks.group_norm_act(x, norm, act, shift=shift)
    assert torch.equal(got.detach(), expect)
    assert got.requires_grad == (case == "autograd records")


@pytest.mark.parametrize("sample_dtype", ["bfloat16", "int8"])
def test_torso_norm_sites_match_a_shape_step(sample_dtype, monkeypatch):
    """`torso_norm_sites`, read off the model on the meta device, lists
    exactly the norms of one twin shape step (shape, groups, eps, shift,
    activation: RoundedSiLU in the int8 twin), each of which the rule sends
    to the kernel but for the device, every input channel-first and
    contiguous; at the flagship's widths its 46 norms, each slab fitting
    the kernel."""
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.echo_scene import rel_s_dims
    from echoscene_torch.models.sgdiff import SGDiff

    cfg = tiny_config()
    cfg.sample_dtype = sample_dtype
    sd = cfg.shape_branch.denoiser
    m = 3
    sites = torso_norm_sites(sd, m)
    calls, reasons = [], set()
    norm_act = blocks._norm_act

    def record(x, norm, act, shift):
        calls.append((tuple(x.shape), norm.num_groups, norm.eps,
                      shift is not None, blocks.act_mode(act)))
        if x.dim() == 5:
            reasons.add(blocks.plain_reason(x, norm, act, shift))
            reasons.add(gnk.unfit(x, norm.num_groups))
        return norm_act(x, norm, act, shift)
    monkeypatch.setattr(blocks, "_norm_act", record)
    torch.manual_seed(0)
    sg = SGDiff(cfg, 9, 16, device="cpu")
    twin = sg.inference_module()
    z = torch.randn((m,) + (sd.image_size,) * 3
                    + (sg.cfg.shape_branch.vqvae.embed_dim,))
    calls.clear()
    with torch.no_grad():
        twin.shape_eps(z, torch.full((m,), 3), torch.randn(
            m, 1, rel_s_dims(sg.cfg)[-1]),
            torch.zeros((1, 3), dtype=torch.long), torch.ones(m),
            torch.ones(1))
    shape_calls = [c for c in calls if len(c[0]) == 5]
    silu = "rounded_silu" if sample_dtype == "int8" else "silu"
    want = Counter()
    for s in sites:
        want[(s["x_shape"], s["groups"], s["eps"], s["shift"],
              silu if s["act"] == "silu" else s["act"])] += s["calls"]
    assert Counter(shape_calls) == want
    assert sum(want.values()) == 21
    assert reasons == {"on cpu, not CUDA", None}

    sites = FLAGSHIP_SITES
    assert sum(s["calls"] for s in sites) == 46
    assert sum(s["calls"] for s in sites if s["shift"]) == 17
    assert sum(s["calls"] for s in sites if s["eps"] == 1e-6) == 11
    slabs = [s["x_shape"][1] // s["groups"] * s["x_shape"][2]
             * s["x_shape"][3] * s["x_shape"][4] for s in sites]
    assert max(slabs) == 86_016
    elements = sum(s["calls"] * slab * s["groups"] * FLAGSHIP_ROWS
                   for s, slab in zip(sites, slabs))
    assert elements == 25_632_768 * FLAGSHIP_ROWS
    for s in sites:
        _, c, d, h, w = s["x_shape"]
        assert gnk.smem_bytes(c // s["groups"], d * h * w) <= gnk.MAX_SMEM
    assert gnk.group_norm_bound(elements)["bytes"] == 4 * elements


# --- on the card ------------------------------------------------------------
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _against_plain(x, norm, act, shift):
    """The kernel's output against the plain path's (`gap_to_plain`): the
    norm within its error model, the activation exact."""
    got = gnk.group_norm_act(x, norm.num_groups, norm.eps, norm.weight,
                             norm.bias, shift, act)
    gap = gnk.gap_to_plain(x, norm.num_groups, norm.eps, norm.weight,
                           norm.bias, shift, act, got)
    assert gap["norm_of_bound"] <= 1.0, gap
    assert gap["act_exact"], gap
    return got, gap


@pytest.mark.cuda
@pytest.mark.parametrize("site", FLAGSHIP_SITES, ids=_site_id)
def test_cuda_kernel_matches_plain_at_the_torso_shapes(site):
    """Every norm shape of the flagship's shape step at 272 rows, each
    activation, with and without the shift."""
    _needs_cuda()
    for act in gnk.ACTS:
        for with_shift in (False, True):
            x, norm, shift = _inputs(site, torch.bfloat16, act, with_shift,
                                     "cuda")
            before = gnk.LAUNCHES["group_norm_act"]
            _, gap = _against_plain(x, norm, act, shift)
            # the call and gap_to_plain's launch of the norm
            assert gnk.LAUNCHES["group_norm_act"] == before + 2
            print(f"{_site_id(site)} {act} shift={with_shift}: worst gap "
                  f"{gap['max_ulps']} bf16 ulps ({gap['differ']:.2e} of the "
                  f"outputs differ), the norm at {gap['norm_of_bound']:.3e} "
                  f"of its bound")
            del x, shift
            torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype,shift_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_cuda_kernel_parameter_dtypes(param_dtype, shift_dtype):
    """Weight, bias and shift in bf16 or f32; two launches bit-equal."""
    _needs_cuda()
    site = dict(name="dtypes", x_shape=(3, 96, 4, 8, 8), eps=1e-5)
    x, norm, shift = _inputs(site, torch.bfloat16, "silu", True, "cuda")
    norm = norm.to(param_dtype)
    shift = shift.to(shift_dtype)
    for act in gnk.ACTS:
        _against_plain(x, norm, act, shift)
        a = gnk.group_norm_act(x, 32, 1e-5, norm.weight, norm.bias, shift,
                               act)
        b = gnk.group_norm_act(x, 32, 1e-5, norm.weight, norm.bias, shift,
                               act)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_inputs_it_does_not_take():
    """No fallback: a CUDA input the kernel cannot take raises, and no
    launch is counted."""
    _needs_cuda()
    w = torch.ones(64, device="cuda")
    b = torch.zeros(64, device="cuda")
    gnk.reset_launches()
    for x in (torch.randn(2, 64, 4, 8, 8, device="cuda"),
              torch.randn(2, 64, 8, device="cuda").bfloat16(),
              torch.randn(1, 64, 16, 64, 64, device="cuda").bfloat16(),
              torch.randn(2, 64, 3, 3, 3, device="cuda").bfloat16(),
              torch.randn(2, 8, 4, 8, 64, device="cuda").bfloat16()
              .transpose(1, 4)):
        with pytest.raises(ValueError):
            gnk.group_norm_act(x, 32, 1e-5, w, b)
    x = torch.randn(2, 64, 4, 8, 8, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        gnk.group_norm_act(x, 32, 1e-5, w, b, act="gelu")
    with pytest.raises(ValueError):
        gnk.group_norm_act(x, 32, 1e-5, w[:32], b)
    with pytest.raises(ValueError):
        gnk.group_norm_act(x, 32, 1e-5, w, b,
                           shift=torch.zeros(2, 64, device="cuda").t())
    assert gnk.LAUNCHES["group_norm_act"] == 0


@pytest.mark.cuda
def test_cuda_resblock_takes_the_kernel_without_autograd():
    """A bf16 ResBlock on the card: both norms through the kernel without
    autograd, none under autograd with trainable parameters."""
    _needs_cuda()
    torch.manual_seed(0)
    block = blocks.ResBlock(64, 128, 96).cuda().bfloat16()
    x = torch.randn(2, 64, 4, 8, 8, device="cuda").bfloat16()
    emb = torch.randn(2, 128, device="cuda").bfloat16()
    gnk.reset_launches()
    with torch.no_grad():
        block(x, emb)
    assert gnk.LAUNCHES["group_norm_act"] == 2
    block(x, emb).float().sum().backward()
    assert gnk.LAUNCHES["group_norm_act"] == 2


@pytest.mark.cuda
def test_cuda_dispatch_leaves_no_bf16_input_to_the_modules():
    """Without autograd a bf16 ResBlock takes the kernel on a
    non-contiguous input too (made contiguous: the same output as on the
    contiguous input), and a slab the kernel cannot take raises instead of
    running the modules."""
    _needs_cuda()
    torch.manual_seed(0)
    block = blocks.ResBlock(64, 128, 96).cuda().bfloat16()
    x = torch.randn(2, 64, 4, 8, 8, device="cuda").bfloat16()
    emb = torch.randn(2, 128, device="cuda").bfloat16()
    strided = x.to(memory_format=torch.channels_last_3d)
    assert not strided.is_contiguous()
    gnk.reset_launches()
    with torch.no_grad():
        want = block(x, emb)
        got = block(strided, emb)
    assert gnk.LAUNCHES["group_norm_act"] == 4
    assert torch.equal(got, want)
    norm = blocks.GroupNorm32(64).cuda().bfloat16()
    for shape in ((1, 64, 16, 64, 64), (2, 64, 3, 3, 3)):
        with torch.no_grad(), pytest.raises(ValueError):
            blocks.group_norm_act(torch.randn(shape, device="cuda")
                                  .bfloat16(), norm, nn.SiLU())
    assert gnk.LAUNCHES["group_norm_act"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gen_bf16_b32", "gen_int8_b32"])
def test_cuda_generation_inside_the_check_limits(workload):
    """One traced generation call of the benchmark cell: correct by every
    limit of the cell (shape_step: 0.03 bf16, 0.2 int8), every shape-torso
    norm through the kernel."""
    _needs_cuda()
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", workload,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    shape_step = result["checks"]["shape_step"]
    print(f"{workload}: shape_step {shape_step['value']!r} limit "
          f"{shape_step['limit']!r}")
    assert shape_step["value"] <= shape_step["limit"]
    assert result["correct"], result["checks"]
    assert result["metrics"]["shape_norm_fused_share.gen"]["value"] == 100.0
