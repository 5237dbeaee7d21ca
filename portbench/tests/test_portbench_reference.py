"""The float32 reference against the program at a tiny configuration on
the CPU: the same weights give the same outputs, part by part."""
import copy

import pytest
import torch

from portbench import check, generate
from tiny import tiny_config, tiny_mix

torch.set_num_threads(1)


def test_keys_match_at_full_width():
    from echoscene_torch.models.echo_scene import EchoSceneModule
    from portbench import model_config
    from portbench.reference.model import EchoScene
    cfg = model_config.load("echoscene_bf16")
    with torch.device("meta"):
        prog = EchoSceneModule(model_config.program_config(cfg, 32, 416,
                                                           768), 9, 16)
        ref = EchoScene(model_config.reference_model(cfg))
    ps = {k: v.shape for k, v in prog.state_dict().items()}
    rs = {k: v.shape for k, v in ref.state_dict().items()}
    assert ps == rs
    assert sum(p.numel() for p in ref.parameters()) == 634_879_015


@pytest.fixture(scope="module", params=["echoscene_bf16", "echoscene_int8"])
def f32_run(request):
    """The program with float32 sampling (and, for the int8 file, its
    sampling twin's sites left in f32) beside the reference in f32."""
    cfg = tiny_config(request.param)
    f32 = copy.deepcopy(cfg)
    f32["sample_dtype"] = "float32"
    run = generate.Generation(f32, tiny_mix(), 21, "cpu",
                              check.weight_spec(f32), False)
    run.window(0.0)
    ref = check.reference_outputs(check.reference(f32, 21, "cpu"), f32,
                                  run.graphs[0], run.rec, run.rows, "cpu")
    return check.numbers(check.produced(run.rec, run.host,
                                        run.graphs[0]["real_nodes"]), ref)


@pytest.mark.parametrize("part", check.NUMBERS)
def test_reference_equals_program_in_f32(f32_run, part):
    assert f32_run[part] < 1e-5


def _pair(c_in, c_out, stride=1):
    from echoscene_torch.nn.quant import Int8Conv3d
    from portbench.reference.model import Conv, Numerics
    torch.manual_seed(3)
    conv = torch.nn.Conv3d(c_in, c_out, 3, stride=stride, padding=1)
    ref = Conv(3, c_in, c_out, 3, stride=stride, padding=1)
    ref.load_state_dict(conv.state_dict())
    ref.quant, ref.num = True, Numerics("f32", True)
    return conv, Int8Conv3d, ref


@pytest.mark.parametrize("stride", [1, (1, 2, 2)])
def test_int8_site_equals_the_programs(stride):
    """The reference's W8A8 convolution is the program's Int8Conv3d up to
    the program's last bf16 rounding."""
    conv, int8, ref = _pair(12, 40, stride)
    x = torch.randn(2, 12, 4, 6, 6).to(torch.bfloat16)
    got = int8(conv)(x).float()
    want = ref(x.float())
    assert (got - want).abs().max() <= 2 ** -8 * want.abs().max()


def test_int8_factored_upsample_equals_the_programs():
    from echoscene_torch.nn.blocks import Upsample as PUp
    from portbench.reference.model import Numerics, Upsample
    conv, int8, _ = _pair(16, 16)
    prog = PUp(16, 3, factored=True)
    prog.conv = int8(conv, up_axes=(1, 2))
    ref = Upsample(16, 3)
    ref.conv.load_state_dict(conv.state_dict())
    ref.factored, ref.conv.num = True, Numerics("f32", True)
    x = torch.randn(2, 16, 3, 4, 4).to(torch.bfloat16)
    got = prog(x).float()
    want = ref(x.float())
    assert got.shape == want.shape == (2, 16, 3, 8, 8)
    assert (got - want).abs().max() <= 2 ** -8 * want.abs().max()


@pytest.mark.parametrize("branch", ["layout", "shape"])
def test_reference_chain_equals_the_programs(branch):
    """The reference's sub-schedule and DPM-Solver++(2M) chain against the
    program's, at the full configuration's schedules, on a denoiser of
    plain arithmetic."""
    from echoscene_torch.core.schedules import (ddim_tables,
                                                 lambda_uniform_timesteps)
    from echoscene_torch.diffusion.samplers import dpmpp_chain
    from portbench import model_config
    from portbench.reference import sampler
    cfg = model_config.load("echoscene_bf16")
    if branch == "layout":
        ac = sampler.layout_alphas_cumprod(cfg)
        steps = cfg["layout_branch"]["diffusion_kwargs"]["sample_steps"]
    else:
        ac = sampler.shape_alphas_cumprod(cfg)
        steps = cfg["shape_branch"]["ddim_steps"]
    ref = sampler.Chain(ac, steps)
    tables = ddim_tables(ac, lambda_uniform_timesteps(steps, ac), 0.0)
    assert list(ref.t) == list(tables.timesteps[::-1])

    def denoise(x, t):
        return 0.3 * x + 0.01 * t[:, None].float() / 1000

    x_T = torch.randn(16, 8, generator=torch.Generator().manual_seed(4))
    got = dpmpp_chain(denoise, (16, 8), tables, x_T=x_T, device="cpu")
    want = sampler.run_chain(ref, denoise, x_T)
    assert check.worst_row_gap(got, want) < 1e-5
