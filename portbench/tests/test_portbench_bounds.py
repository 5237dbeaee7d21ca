"""The frozen bound functions reproduce the figures they were taken from,
and equal the program's own at the benchmark's shapes."""
import pytest

from portbench import bounds, model_config


def test_attention_bound_k1():
    assert bounds.attention_bound(42, 1024, 8, 56)["ms"] == pytest.approx(
        0.0843, abs=5e-5)


def test_attention_backward_bound():
    assert bounds.attention_backward_bound(8, 1024, 8, 56)["ms"] == \
        pytest.approx(0.0380, abs=5e-5)


def test_q2_step_bound():
    unet = model_config.load("echoscene_int8")["shape_branch"]["unet"]
    b = bounds.torso_step_bound_ms(unet, 42)
    assert b["q2_ms"] == pytest.approx(9.481, abs=5e-4)
    assert b["q2_calls"] == 57 and b["q1_calls"] == 51


@pytest.mark.parametrize("shape", [(42, 1024, 8, 56), (272, 1024, 8, 56),
                                   (8, 4096, 1, 256)])
def test_attention_bounds_equal_the_programs(shape):
    from echoscene_torch.kernels import flash_attention as fa
    assert bounds.attention_bound(*shape)["ms"] == pytest.approx(
        fa.attention_bound(*shape)["ms"], rel=1e-12)
    assert bounds.attention_backward_bound(*shape)["ms"] == pytest.approx(
        fa.attention_backward_bound(*shape)["ms"], rel=1e-12)


@pytest.mark.parametrize("rows", [42, 272])
def test_conv_sites_equal_the_programs(rows):
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig
    unet = model_config.load("echoscene_int8")["shape_branch"]["unet"]
    ours, q1 = bounds.torso_conv_sites(unet, rows)
    theirs, q1_theirs = q8.torso_conv_sites(ShapeDenoiserConfig(), rows)
    assert len(q1) == q1_theirs
    assert [(s["x_shape"], s["k"], s["taps"], s["calls"]) for s in ours] == \
        [(s["x_shape"], s["k"], s["taps"], s["calls"]) for s in theirs]
