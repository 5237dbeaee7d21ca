"""The port's host helpers (echoscene_torch/utils.py) against JAX's
echoscene_tpu/utils.py, with the cases of tests/test_utils_profiling.py."""
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_freemem_matches_jax():
    from echoscene_tpu.utils import FreeMemLinux as JaxFreeMem
    from echoscene_torch.utils import FreeMemLinux

    fm = FreeMemLinux("GB")
    assert fm.total > 1
    assert 0 < fm.available <= fm.total
    assert fm.user_free == pytest.approx(fm.available, rel=0.05)
    assert fm.total == JaxFreeMem("GB").total
    assert FreeMemLinux("MB").total == pytest.approx(fm.total * 1024)


def test_seed_everything_seeds_python_numpy_and_torch():
    from echoscene_torch.utils import seed_everything

    draws = []
    for _ in range(2):
        seed_everything(3)
        draws.append((random.random(), np.random.rand(2), torch.rand(2)))
    assert draws[0][0] == draws[1][0]
    assert np.allclose(draws[0][1], draws[1][1])
    assert torch.equal(draws[0][2], draws[1][2])


@pytest.mark.parametrize("lo", [-1.0, 0.0])
def test_tensor2im_matches_jax(lo):
    from echoscene_tpu.utils import tensor2im as jax_tensor2im
    from echoscene_torch.utils import tensor2im

    a = np.linspace(lo, 1, 12, dtype=np.float32).reshape(2, 2, 3)
    img = tensor2im(a)
    assert img.dtype == np.uint8 and img.max() == 255 and img.min() == 0
    np.testing.assert_array_equal(img, jax_tensor2im(a))
    np.testing.assert_array_equal(tensor2im(torch.from_numpy(a)), img)
