"""A whole run at a tiny size on the CPU, the chip's look skipped: a sound
run comes out correct, and each fault a generation cell can have, planted
in the timed path, comes out not correct.  The control, the reference in
the precision below the configuration's, fails the cell's limits."""
import json
import os

import pytest
import torch

from portbench import check, generate, run as bench
from tiny import tiny_config, tiny_mix

torch.set_num_threads(1)
CELLS = [("gen_bf16_b32", "echoscene_bf16"),
         ("gen_int8_b32", "echoscene_int8")]


def one_run(workload, config, seed=31):
    return bench.run_cell(workload, seed, 0.0, False, device="cpu",
                          cfg=tiny_config(config), mix=tiny_mix())


@pytest.mark.parametrize("workload,config", CELLS)
def test_sound_run_is_correct(workload, config):
    result = one_run(workload, config)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"gen_scenes_per_s", "setup_s"}
    json.dumps(result)


def fault(part, original):
    """The timed path broken at `part`: a shape denoiser that returns its
    input, a layout step that leaves out half of its rows, a decode chunk
    with one object's answer altered."""
    if part == "shape_eps":
        return lambda self, z, *args: z

    if part == "layout_eps":
        def half(self, *args):
            out = original(self, *args)
            h = out.shape[0] // 2
            return torch.cat([out[:h], torch.zeros_like(out[h:])])
        return half

    def altered(self, z):
        out = original(self, z).clone()
        out[0] = out[0] * 2.0
        return out
    return altered


@pytest.mark.parametrize("workload,config", CELLS)
@pytest.mark.parametrize("part", ["shape_eps", "layout_eps",
                                  "decode_latent"])
def test_fault_is_not_correct(monkeypatch, workload, config, part):
    from echoscene_torch.models.echo_scene import EchoSceneModule
    monkeypatch.setattr(EchoSceneModule, part,
                        fault(part, getattr(EchoSceneModule, part)))
    result = one_run(workload, config)
    assert not result["correct"], result["checks"]


def stale_chain(denoise_fn, shape, tables, x_T=None, generator=None,
                device="cuda"):
    """A chain that calls its denoiser at every step and never updates its
    state (a replay of stale buffers)."""
    x = x_T.float()
    for i in reversed(range(tables.num_steps)):
        denoise_fn(x, torch.full((shape[0],), int(tables.timesteps[i]),
                                 dtype=torch.long, device=device))
    return x


@pytest.mark.parametrize("workload,config", CELLS)
@pytest.mark.parametrize("branch,chain", [("layout", "stale"),
                                          ("shape", "stale"),
                                          ("shape", "ddim")])
def test_wrong_update_is_not_correct(monkeypatch, workload, config, chain,
                                     branch):
    """The chain's update broken, its denoiser sound: no update at all, or
    DDIM's update in DPM-Solver++'s place (wrong coefficients; the tiny
    layout denoiser's prediction hardly depends on its input, and DDIM and
    DPM-Solver++ then step alike, so that fault is tried on the shape
    chain)."""
    from echoscene_torch.diffusion import ldm, samplers
    bad = samplers.ddim_chain if chain == "ddim" else stale_chain
    if branch == "layout":
        monkeypatch.setitem(samplers.CHAINS, "dpmpp", bad)
    else:
        monkeypatch.setattr(ldm, "dpmpp_chain", bad)
    result = one_run(workload, config)
    assert not result["correct"], result["checks"]
    assert result["checks"][branch + "_update"]["value"] > result[
        "checks"][branch + "_update"]["limit"]


def test_host_copy_altered_is_not_correct(monkeypatch):
    """Two objects' boxes exchanged on their way to the host."""
    from echoscene_torch.diffusion.ddpm import LayoutDiffusion
    split = LayoutDiffusion.split_sample

    def altered(vec8):
        return dict(split(vec8[[1, 0] + list(range(2, vec8.shape[0]))]))
    monkeypatch.setattr(LayoutDiffusion, "split_sample",
                        staticmethod(altered))
    result = one_run("gen_bf16_b32", "echoscene_bf16")
    assert result["checks"]["layout_chain"]["value"] > result["checks"][
        "layout_chain"]["limit"]
    assert not result["correct"]


@pytest.mark.parametrize("workload,config", CELLS)
def test_control_fails_the_limits(workload, config):
    cfg = tiny_config(config)
    run = generate.Generation(cfg, tiny_mix(), 41, "cpu",
                              check.weight_spec(cfg), False)
    run.window(0.0)
    args = (cfg, run.graphs[0], run.rec, run.rows, "cpu")
    ref = check.reference_outputs(check.reference(cfg, 41, "cpu"), *args)
    ctl = check.reference_outputs(
        check.reference(cfg, 41, "cpu", "control"), *args, torch.bfloat16)
    got = check.numbers(ctl, ref)
    limits = check.limits(workload)
    assert any(got[k] > limits[k] for k in check.NUMBERS), got
    # the updates in bfloat16 fail their own limits
    assert got["layout_update"] > limits["layout_update"]
    assert got["shape_update"] > limits["shape_update"]


def test_no_device_gives_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--workload", "gen_bf16_b32", "--seed", "1",
                       "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "gen_bf16_b32",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=root, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
