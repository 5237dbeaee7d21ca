"""The VQ-VAE training cell (`vqvae_train`) at a tiny size on the CPU, its
chip look skipped: the float32 reference reproduces the program's float32
`VQVAETrainer.train_step` (the loss, the per-leaf gradients as Adam got
them, the change after three Adam steps) and the program's own bf16 compute
does not; a sound run comes out correct, and a step that leaves its state
unchanged or half of its batch out does not.  Then the logical operations
of a step at the published widths, and the cell's per-layer metrics on
made-up traces."""
import copy
import types

import pytest
import torch

from portbench import check, flops, model_config, run as bench, scenes
from portbench import vqvae_train as V
from test_portbench_trace import CPU, CUDA, Event

torch.set_num_threads(1)
CELL, CONFIG, TRAFFIC = "vqvae_train_f32_b8", "vqvae_snet_f32", \
    "vqvae_train_b8"


def tiny_config():
    cfg = copy.deepcopy(model_config.load(CONFIG))
    cfg["model"]["params"]["n_embed"] = 64
    cfg["model"]["params"]["ddconfig"].update(ch=8, resolution=16)
    return cfg


def tiny_mix():
    return dict(scenes.load(TRAFFIC), batch=4, sdf_resolution=16)


def numbers(seed, cfg=None):
    cfg = cfg or tiny_config()
    run = V.VQVAETraining(cfg, tiny_mix(), seed, "cpu", V.weight_spec(cfg),
                          False)
    run.release()
    return check.training_numbers(run, V.reference_steps(run))


# Both sides run CPU PyTorch's float32 kernels in orders of their own: the
# loss and the gradients' leaf norms differ by float32 round-off (read:
# under 5e-7 over 12 seeds), and the bf16 compute reads 2e-4 or more.  The
# change: Adam's first step moves each element by the learning rate in its
# gradient's direction, so an element whose gradient is round-off can move
# either way (read: up to 1.2e-3 in a small norm leaf), and bf16 reads
# 0.017 or more.
TOLERANCE = {"first_loss": 1e-5, "first_grad_median": 1e-5,
             "first_grad_norms": 1e-5, "change": 1e-2}


@pytest.mark.parametrize("seed", [52, 2 ** 31 + 77])
def test_reference_equals_program_in_f32(seed):
    got = numbers(seed)
    assert all(got[k] < TOLERANCE[k] for k in TOLERANCE), got


def test_program_bf16_is_not_within_the_tolerances():
    got = numbers(52, dict(tiny_config(), compute_dtype="bfloat16"))
    assert any(got[k] > TOLERANCE[k] for k in TOLERANCE), got
    assert got["first_loss"] > 10 * TOLERANCE["first_loss"]


def one_run(seed=53):
    return bench.run_cell(CELL, seed, 0.1, False, device="cpu",
                          cfg=tiny_config(), mix=tiny_mix())


def test_sound_run_is_correct():
    result = one_run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"vqvae_train_grids_per_s",
                                      "train_peak_mem_gib", "setup_s"}
    assert result["metrics"]["vqvae_train_grids_per_s"]["value"] > 0
    assert set(result["checks"]) == set(V.NUMBERS)


def test_state_unchanged_is_not_correct(monkeypatch):
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer

    def unchanged(self, state, batch):
        _, logs = self.loss_fn(state.module, batch)
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}
    monkeypatch.setattr(VQVAETrainer, "train_step", unchanged)
    result = one_run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct():
    restore = V.half_batch_loss()
    try:
        result = one_run()
    finally:
        restore()
    assert not result["correct"], result["checks"]


def test_weights_are_the_seeds_on_either_side():
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer
    from portbench.reference.vqvae import VQVAE, model_dict
    cfg = tiny_config()
    spec = V.weight_spec(cfg)
    prog = VQVAETrainer(V.program_config(cfg), device="cpu").init(
        torch.Generator()).module
    ref = VQVAE(model_dict(cfg))
    for model in (prog, ref):
        V.draw_(dict(model.named_parameters()), spec, 7, "cpu")
    for (n, p), (m, q) in zip(sorted(prog.named_parameters()),
                              sorted(ref.named_parameters())):
        assert n == m and torch.equal(p, q), n
    book = dict(ref.named_parameters())["quantize.embedding.weight"]
    assert 0 < book.abs().max() <= 1.0 / 64


def test_step_operations_at_the_published_widths():
    ops = flops.vqvae_train_ops(model_config.load(CONFIG),
                                scenes.load(TRAFFIC))
    assert ops["int8"] == 0.0
    assert ops["bf16"] == pytest.approx(23.85e12, rel=5e-3)


# ----------------------------------------------------------------------
# the per-layer metrics on made-up traces: two steps of 0.5 s in a 1 s
# window, the device busy 0.84 s of it

STEP_NS = 500_000_000
MAIN = "void (anonymous namespace)::attention_tf32x3_kernel<256, 64>(Maps)"
PREPASS = ("void (anonymous namespace)::split_k(float4 const*)",
           "void (anonymous namespace)::split_vt(float const*)")


def events(main_per_step=2):
    out = [Event("portbench.window", CPU, 0, 2 * STEP_NS, ann=True)]
    corr = 0
    for s in range(2):
        t0 = s * STEP_NS
        out.append(Event("portbench.vqvae_step", CPU, t0, STEP_NS - 1,
                         ann=True))
        kernels = [("conv", 400_000_000)]
        for _ in range(main_per_step):
            kernels += [(PREPASS[0], 1_000_000), (PREPASS[1], 1_000_000),
                        (MAIN, 8_000_000)]
        at = t0
        for name, dur in kernels:
            corr += 1
            out.append(Event("cudaLaunchKernel", CPU, t0 + corr, 1,
                             corr=corr))
            out.append(Event(name, CUDA, at, dur, corr=corr))
            at += dur
    return out


def traced_run(main_per_step=2, cfg=None, mix=None):
    from portbench.trace import Trace
    return types.SimpleNamespace(
        trace_data=Trace(events(main_per_step)),
        cfg=cfg or model_config.load(CONFIG), mix=mix or scenes.load(TRAFFIC))


def test_attention_roofline_reads_its_kernels():
    from portbench import bounds
    got = bench.reader("attn_f32_roofline.vqvae")(traced_run())
    bound_ms = bounds.attention_bound(8, 4096, 1, 256)["ms"]
    # 2 steps x 2 calls, each 10 ms of kernels (pre-pass and main)
    assert got == pytest.approx(100.0 * 4 * bound_ms / 40.0)


@pytest.mark.parametrize("main_per_step", [1, 3])
def test_attention_roofline_reads_nothing_when_the_routing_moved(
        main_per_step):
    assert bench.reader("attn_f32_roofline.vqvae")(
        traced_run(main_per_step)) is None


def test_mfu_and_idle():
    run = traced_run()
    ops = flops.vqvae_train_ops(run.cfg, run.mix)
    assert bench.reader("mfu.vqvae")(run) == pytest.approx(
        100.0 * flops.peak_seconds(ops) / 0.5)
    # each step: 400 ms of convolution and 20 ms of attention
    assert bench.reader("device_idle.vqvae")(run) == pytest.approx(
        100.0 * (1 - 0.84))


@pytest.mark.parametrize("name", ["mfu.vqvae", "device_idle.vqvae",
                                  "attn_f32_roofline.vqvae"])
def test_untraced_metrics_read_nothing(name):
    run = types.SimpleNamespace(trace_data=None, cfg=None, mix=None)
    assert bench.reader(name)(run) is None


@pytest.mark.cuda
def test_controls_on_the_card(cuda_device):
    """At the cell's own size on the card: the program within the cell's
    limits; the control (the reference with TF32 products), the program's
    own bf16 compute and the program with half of each batch left out each
    outside one of them or more."""
    cfg, mix = model_config.load(CONFIG), scenes.load(TRAFFIC)
    line = V.calibration_line(CELL, cfg, mix, 2 ** 31 + 7,
                              V.weight_spec(cfg), {"bf16", "fault"},
                              cuda_device)
    limits = check.limits(CELL)
    assert all(line["program"][k] <= limits[k] for k in limits), line
    for key in ("control_tf32", "program_bf16", "program_half_batch"):
        assert any(line[key][k] > limits[k] for k in limits), (key, line)
