"""`export_jax_checkpoint.py`: a JAX Orbax checkpoint into the port.

A tiny JAX training state (the JAX trainer's init from an args.json of
the JAX train CLI over a fake dataset, one optax step on random
gradients) is saved with echoscene_tpu's `save_checkpoint`, exported, and
restored with the port's `restore_checkpoint`: the parameters and batch
statistics equal JAX's (the bridge is exact), the AdamW moments and count
equal optax's, the step and epoch are kept; one further optimizer step on
the same gradients gives parameters within 1e-6 on both sides (the
optimizer tests' tolerance, test_torch_port_train.py).  A `--zero1`
checkpoint exports its parameters, step and epoch, without moments.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint", os.path.join(REPO, "export_jax_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _jax_exp(base, root, *extra):
    from test_torch_port_eval import TINY_DF, TINY_VQ, TINY_YAML
    from echoscene_tpu.train.cli import build_parser

    exp = base / "jax_exp"
    exp.mkdir()
    for name, text in (("tiny.yaml", TINY_YAML), ("df.yaml", TINY_DF),
                       ("vq.yaml", TINY_VQ)):
        (exp / name).write_text(text)
    margs = vars(build_parser().parse_args([
        "--dataset", root, "--exp", str(exp), "--with_SDF", "True",
        "--diff_yaml", str(exp / "tiny.yaml"), "--batchSize", "2",
        "--max_nodes", "24", "--max_triples", "64", "--sdf_res", "16",
        "--diffusion_bs", "12", "--clip_backend", "hash",
        "--compute_dtype", "float32", *extra]))
    (exp / "args.json").write_text(json.dumps(margs))
    return exp, margs


def _seeded_params(tool, cfg, ds):
    """JAX (params, batch_stats) of the port module with seeded weights,
    through echoscene_tpu's torch_import (the bridge is exact)."""
    from echoscene_tpu.convert.torch_import import \
        convert_echoscene_checkpoint
    from echoscene_torch.benchmarks import seeded_weights_
    from echoscene_torch.convert.from_jax import module_to_checkpoint
    from echoscene_torch.models.echo_scene import EchoSceneModule

    torch.manual_seed(0)
    module = EchoSceneModule(tool.port_config(cfg), len(ds.classes),
                             len(ds.pred_names))
    seeded_weights_(module, 0)
    numpy = lambda t: {k: numpy(v) if isinstance(v, dict) else v.numpy()
                       for k, v in t.items()}
    return convert_echoscene_checkpoint(
        numpy(module_to_checkpoint(module.state_dict())), cfg,
        gconv_num_layers=cfg.gconv_num_layers)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX experiment with a checkpoint at epoch 3 after one optimizer
    step, and the next step's gradients and parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from echoscene_tpu.data.fake import make_fake_dataset
    from echoscene_tpu.models.sgdiff import TrainState, make_optimizer
    from echoscene_tpu.train.checkpoint import save_checkpoint

    base = tmp_path_factory.mktemp("export")
    root = str(base / "data")
    make_fake_dataset(root, num_scenes=4, min_objs=3, max_objs=4, sdf_res=16,
                      with_sdf=True)
    exp, margs = _jax_exp(base, root)
    tool = _tool()
    cfg, ds = tool.jax_config(margs)
    jsg, _, template = tool.jax_template(cfg, ds)
    # seeded weights through the weight bridge (no init program to compile)
    params, stats = _seeded_params(tool, cfg, ds)
    tx = make_optimizer(cfg, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params),
                       epoch=jnp.zeros((), jnp.int32))
    assert (jax.tree.structure(state) == jax.tree.structure(template))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda x: (1e-2 * rng.standard_normal(
        np.shape(x))).astype(np.float32), state.params) for _ in range(2)]
    update = jax.jit(tx.update)
    upd, opt = update(grads[0], state.opt_state, state.params)
    state = state.replace(params=optax.apply_updates(state.params, upd),
                          opt_state=opt, step=state.step + 1,
                          epoch=state.epoch + 3)
    save_checkpoint(str(exp / "checkpoint" / "model3"), state)
    upd, _ = update(grads[1], state.opt_state, state.params)
    after = optax.apply_updates(state.params, upd)
    host = lambda t: jax.tree.map(np.asarray, t)
    return dict(tool=tool, exp=exp, margs=margs, cfg=cfg, ds=ds,
                state=host(state), grads=host(grads[1]), after=host(after),
                base=base)


def _port_sg(run):
    from echoscene_torch.models.sgdiff import SGDiff

    ds = run["ds"]
    return SGDiff(run["tool"].port_config(run["cfg"]), len(ds.classes),
                  len(ds.pred_names), device="cpu", iou_stats=ds.box_stats)


def _to_module(run, tree):
    from echoscene_torch.convert import from_jax

    return from_jax.checkpoint_to_module(from_jax.convert_echoscene_checkpoint(
        tree, run["state"].batch_stats, run["cfg"]))


def test_export_restores_and_steps_as_jax(jax_run, capsys):
    import optax

    from echoscene_torch.models.sgdiff import trainable_parameters
    from echoscene_torch.train.checkpoint import restore_checkpoint

    run = jax_run
    out = run["base"] / "port_exp"
    assert run["tool"].main(["--exp", str(run["exp"]),
                             "--out", str(out)]) == 0
    assert "moments at count 1 exported" in capsys.readouterr().out
    assert json.loads((out / "args.json").read_text()) == run["margs"]
    psg = _port_sg(run)
    state = restore_checkpoint(str(out / "checkpoint" / "model3"), psg,
                               psg.init_train_state())
    assert state.step == 1 and state.epoch == 3 and state.accum is None
    want = _to_module(run, run["state"].params)
    for n, p in psg.module.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(want[n]), n)
    # AdamW's moments and count are optax's
    adam = [a for a in __import__("jax").tree_util.tree_leaves(
        run["state"].opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(a, optax.ScaleByAdamState)][0]
    keep = lambda t: {k: v for k, v in t.items() if k != "vqvae"}
    mu, nu = (_to_module(run, keep(t)) for t in (adam.mu, adam.nu))
    named = trainable_parameters(psg.module)
    for n, p in named:
        st = state.optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == 1
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[n], n)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[n], n)
    # one further step on each side
    g = _to_module(run, run["grads"])
    psg.apply_gradients(state, [torch.from_numpy(np.array(g[n]))
                                for n, _ in named])
    after = _to_module(run, run["after"])
    for n, p in psg.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(after[n]),
                                   atol=1e-6, rtol=0, err_msg=n)


def test_export_of_a_zero1_checkpoint_leaves_the_moments_out(
        jax_run, tmp_path, capsys):
    import jax

    from echoscene_tpu.parallel.mesh import make_mesh
    from echoscene_tpu.parallel.zero import init_zero1_state
    from echoscene_tpu.train.checkpoint import save_checkpoint
    from echoscene_torch.train.checkpoint import restore_checkpoint

    run = jax_run
    exp, _ = _jax_exp(tmp_path, run["margs"]["dataset"], "--zero1")
    state = init_zero1_state(jax.tree.map(jax.numpy.asarray, run["state"]),
                             make_mesh((1,), ("data",), jax.devices()[:1]))
    save_checkpoint(str(exp / "checkpoint" / "model3"), state)
    out = tmp_path / "port_exp"
    run["tool"].main(["--exp", str(exp), "--out", str(out), "--epoch", "3"])
    assert "the AdamW moments were left out" in capsys.readouterr().out
    psg = _port_sg(run)
    restored = restore_checkpoint(str(out / "checkpoint" / "model3"), psg,
                                  psg.init_train_state())
    assert restored.step == 1 and restored.epoch == 3
    assert not restored.optimizer.state
    want = _to_module(run, run["state"].params)
    for n, p in psg.module.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(want[n]), n)
    with pytest.raises(SystemExit):
        run["tool"].main(["--exp", str(exp), "--out", str(exp)])
