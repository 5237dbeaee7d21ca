"""CPU checks of the port's ZeRO-1 (echoscene_torch/parallel/zero.py).

* `zero1_update_shard` on 4 gloo ranks against JAX's `zero1_update_shard`
  through tests/test_zero1.py's `_run_zero1` harness on its toy tree, over
  four steps (the clip engaged, then a NaN gradient): within 1e-6;
* the full ZeRO-1 step on the tiny model over 2 gloo ranks against the
  port's dp step from the same weights, shards and draws: parameters within
  2e-5 (JAX's own bound, tests/test_zero1.py), with grad_accum 1 and 2;
* a ZeRO-1 checkpoint resume (also between micro-steps) bit-equal to the
  uninterrupted run; `restore_for_inference` on a ZeRO-1 checkpoint; a
  restore over another rank count, or into the AdamW state, raises.

Every rank runs a function of the package (parallel/dryrun.py); every
process group joins through a file in the test's temporary directory.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone."""
    from echoscene_torch.parallel import mesh

    mesh.init_process_group(0, 1, "gloo", str(tmp_path / "rendezvous"))
    yield
    mesh.destroy_process_group()


# --- the flat update against JAX's ------------------------------------------
def test_zero1_update_shard_matches_jax():
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from echoscene_tpu.models.sgdiff import lr_schedule
    from echoscene_tpu.parallel.zero import _flat_masks
    from echoscene_torch.parallel.dryrun import run_job, update_job
    from test_zero1 import _run_zero1, _tiny_cfg, _toy_params

    rng = np.random.default_rng(0)
    cfg = _tiny_cfg()
    params = _toy_params(rng)
    grad_seq = []
    # step 2's shape-denoiser gradients engage the norm-5 clip; step 4
    # holds a NaN there, which zeroes the whole subtree
    for scale in (1.0, 40.0, 0.3, 1.0):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape),
                                               jnp.float32), params)
        g["shape_denoiser"] = jax.tree.map(lambda x: x * scale,
                                           g["shape_denoiser"])
        grad_seq.append(g)
    grad_seq[3]["shape_denoiser"]["a"] = \
        grad_seq[3]["shape_denoiser"]["a"].at[0].set(jnp.nan)
    tmask, cmask, _ = _flat_masks(params)
    flat = lambda t: torch.from_numpy(np.array(ravel_pytree(t)[0]))
    job = {"devices": ["cpu"] * 4, "params": flat(params),
           "grads": [flat(g) for g in grad_seq],
           "train_mask": torch.from_numpy(tmask),
           "clip_mask": torch.from_numpy(cmask),
           "lr": (cfg.lr_init, tuple(cfg.lr_step), tuple(cfg.lr_evo))}
    history = run_job(job, "gloo", fn=update_job)
    assert len(history) == 4
    for k in range(1, 5):
        want = flat(_run_zero1(params, grad_seq[:k], lr_schedule(cfg)))
        np.testing.assert_allclose(history[k - 1].numpy(), want.numpy(),
                                   atol=1e-6, err_msg=f"after step {k}")
    final = history[-1].numpy()
    assert np.all(np.isfinite(final))
    # the frozen entries never move
    np.testing.assert_array_equal(final[~tmask], flat(params).numpy()[~tmask])


# --- the full step on the tiny model ----------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """dp and ZeRO-1 runs over 2 gloo ranks from the same weights, shards
    and draws: one optimizer step each (one call at grad_accum 1, two at
    grad_accum 2); and ZeRO-1 runs of 2 and 4 calls that save a checkpoint
    after their first call and resume a model with other weights from
    it."""
    from echoscene_torch.parallel.dryrun import run_job, tiny_job

    ckpt = {a: str(tmp_path_factory.mktemp(f"zero1_accum{a}"))
            for a in (1, 2)}
    job = tiny_job(["cpu", "cpu"], steps=4)
    shards = job.pop("shards")
    first = lambda k: [s[:k] for s in shards]
    job["runs"] = [
        {"name": "dp", "mode": "dp", "shards": first(1)},
        {"name": "zero1", "mode": "zero1", "shards": first(1)},
        {"name": "dp_accum2", "mode": "dp", "grad_accum": 2,
         "shards": first(2)},
        {"name": "zero1_accum2", "mode": "zero1", "grad_accum": 2,
         "shards": first(2)},
        {"name": "zero1_resume", "mode": "zero1", "shards": first(2),
         "resume_at": 1, "ckpt_dir": ckpt[1]},
        {"name": "zero1_accum2_resume", "mode": "zero1", "grad_accum": 2,
         "shards": shards, "resume_at": 1, "ckpt_dir": ckpt[2]}]
    return run_job(job, "gloo"), ckpt, job


def _assert_params_close(got, want, atol=2e-5):
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=atol, rtol=0, err_msg=n)


@pytest.mark.parametrize("accum", ["", "_accum2"])
def test_zero1_step_matches_dp_step(runs, accum):
    """One ZeRO-1 optimizer step against the replicated dp step (MultiSteps
    under grad_accum 2, which keeps a running mean where ZeRO-1 divides the
    sum): the same losses, parameters within 2e-5, the frozen VQ-VAE
    untouched, the batch-norm statistics equal.  (One step: from the second
    on, the rounding of the first moves gradients near zero, and Adam's
    normalised step turns such a change into up to lr = 1e-4.)"""
    res, _, job = runs
    z, dp = res["zero1" + accum], res["dp" + accum]
    assert z["step"] == dp["step"] == (1 if not accum else 2)
    for a, b in zip(z["metrics"], dp["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert np.isfinite(a["loss"])
    _assert_params_close(z["params"], dp["params"])
    moved = max(float((z["params"][n] - job["state_dict"][n]).abs().max())
                for n in z["params"] if not n.startswith("vqvae."))
    assert moved > 1e-5
    for n, p in z["params"].items():
        if n.startswith("vqvae."):
            assert torch.equal(p, job["state_dict"][n]), n
    for n, b in z["buffers"].items():
        np.testing.assert_allclose(b.numpy(), dp["buffers"][n].numpy(),
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("run", ["zero1_resume", "zero1_accum2_resume"])
def test_zero1_checkpoint_resume_is_bit_exact(runs, run):
    """A model with other weights restored from the ZeRO-1 checkpoint (with
    grad_accum 2 it falls between micro-steps) and taking the remaining
    steps equals the uninterrupted run bit for bit."""
    r = runs[0][run]
    assert r["resumed_step"] == r["step"]
    for n, p in r["params"].items():
        assert torch.equal(r["resumed"]["params"][n], p), n
    for n, b in r["buffers"].items():
        assert torch.equal(r["resumed"]["buffers"][n], b), n
    assert [m["loss"] for m in r["resumed_metrics"]] == \
        [m["loss"] for m in r["metrics"][1:]]


def test_restore_for_inference_loads_zero1_checkpoint(runs):
    import os

    from echoscene_torch.parallel.dryrun import _model
    from echoscene_torch.train.checkpoint import restore_for_inference

    res, ckpt, job = runs
    sg = _model(job, "cpu", seed=3)
    assert restore_for_inference(os.path.join(ckpt[1], "model"),
                                 sg.module) == 0
    saved = res["zero1_resume"]["saved"]
    for n, p in sg.module.named_parameters():
        assert torch.equal(p.detach(), saved["params"][n]), n
    for n, b in sg.module.named_buffers():
        assert torch.equal(b, saved["buffers"][n]), n


def test_zero1_restore_over_other_rank_count_raises(runs, one_rank_group):
    import os

    from echoscene_torch.parallel.dryrun import _model, _state
    from echoscene_torch.train.checkpoint import restore_checkpoint

    _, ckpt, job = runs
    path = os.path.join(ckpt[1], "model")
    sg = _model(job, "cpu")
    with pytest.raises(ValueError, match="saved over 2 ranks"):
        restore_checkpoint(path, sg, _state(sg, "zero1"))
    with pytest.raises(ValueError, match="ZeRO-1 optimizer state"):
        restore_checkpoint(path, sg, _state(sg, "dp"))


def test_zero1_state_layout(runs, one_rank_group):
    """The flat state over one rank: moments of the trainable length, the
    clip mask on the shape denoiser's entries only, the idle accumulator
    one element, a full one under grad_accum 2; the step refuses an idle
    accumulator under grad_accum 2."""
    from echoscene_torch.models.sgdiff import trainable_parameters
    from echoscene_torch.parallel.dryrun import _model, _state
    from echoscene_torch.parallel.zero import zero1_train_step

    job = runs[2]
    sg = _model(job, "cpu")
    z = _state(sg, "zero1").optimizer
    params = trainable_parameters(sg.module)
    assert z.n == z.chunk == sum(p.numel() for _, p in params)
    assert z.acc.numel() == 1 and z.count == 0 and z.world == 1
    want_clip = torch.cat([torch.full((p.numel(),),
                                      n.startswith("shape_denoiser."))
                           for n, p in params])
    assert torch.equal(z.clip_mask, want_clip) and bool(z.train_mask.all())
    state = _state(sg, "zero1")
    sg.cfg.grad_accum = 2
    with pytest.raises(ValueError, match="idle accumulator"):
        zero1_train_step(sg, state, runs[2]["runs"][0]["shards"][0][0][0])
    assert _state(sg, "zero1").optimizer.acc.numel() == z.chunk
