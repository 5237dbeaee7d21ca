"""The training cell at a tiny size on the CPU, its chip look skipped: the
float32 reference reproduces the program's float32 step, a sound run comes
out correct, and a step that leaves its state unchanged or leaves half of
its batch out comes out not correct."""

import pytest
import torch

from portbench import calibrate, check, run as bench, train
from tiny import tiny_config, tiny_mix

torch.set_num_threads(1)


def config():
    cfg = tiny_config("echoscene_bf16", noisy=False)
    # CPU PyTorch's bf16 convolution gradients are not usable here: the
    # program trains in float32 on the CPU (its own CLI refuses bf16 there)
    cfg["compute_dtype"] = "float32"
    return cfg


def one_run(seed=51):
    return bench.run_cell("train_bf16_b64", seed, 0.0, False, device="cpu",
                          cfg=config(), mix=tiny_mix("train_published"))


def test_reference_equals_program_in_f32():
    cfg = config()
    run = train.Training(cfg, tiny_mix("train_published"), 52, "cpu",
                         check.weight_spec(cfg), False)
    run.release()
    got = check.training_numbers(run)
    # the tiny configuration's one-channel norm groups make some biases'
    # gradients round-off, which Adam's first steps turn into full moves:
    # the change is compared at full size only
    assert got["first_loss"] < 1e-5 and got["first_grad_median"] < 1e-3
    assert got["first_grad_norms"] < 1e-3


def test_sound_run_is_correct():
    result = one_run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_scenes_per_s",
                                      "train_peak_mem_gib", "setup_s"}


def test_state_unchanged_is_not_correct(monkeypatch):
    from echoscene_torch.models.sgdiff import SGDiff

    def unchanged(self, state, grads, norm=None):
        state.step += 1
    monkeypatch.setattr(SGDiff, "apply_gradients", unchanged)
    result = one_run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct():
    restore = calibrate.half_batch_losses()
    try:
        result = one_run()
    finally:
        restore()
    assert not result["correct"], result["checks"]
