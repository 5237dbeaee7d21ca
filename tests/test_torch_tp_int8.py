"""Tensor parallelism of the port's sampling twins under `sample_dtype:
int8` and `sample_conv: winograd` (echoscene_torch/parallel/tp.py,
nn/quant.py), on 2 CPU gloo ranks of a (data 1, model 2) mesh, against the
unsharded port and against JAX's GSPMD.

One module-scoped fixture spawns the ranks once (`_rank_job`) and runs JAX
once:

* (a) Q1's plain passes over the ranks' channel shards of one bf16 tensor
  (`quantize_amax_plain`, a MAX all-reduce of the word,
  `quantize_with_amax_plain`): the whole tensor's scale bit for bit, and
  int8 values that are the slices of the whole tensor's;
* (b) the row-split `Int8Conv3d` (input channels 80 -> 40 a rank, padded
  to 64): group weight scales and int8 weights bit-equal to the unsharded
  Int8Conv3d's, its int32 accumulators summed over the group equal to the
  unsharded ones, its bf16 output bit-equal;
* (c) a TPResBlock of the int8 twin (32 -> 48 channels, perturbed JAX
  weights, every convolution int8): bit-equal to the port's unsharded int8
  ResBlock (the shard's GroupNorm sums each group over the same contiguous
  values in the same order), and within the 2^-7 ResBlock rule of
  tests/test_torch_quant.py of JAX's int8 ResBlock;
* (d) `dp.dp_tp_sample` under `sample_dtype: int8` against JAX's
  `build_dp_tp_sample` with `sample_dtype = "int8"` on a (1, 2) mesh of
  virtual devices, from JAX's draws, DPM++ 3 layout / 2 shape steps: the
  int8 rule of tests/test_torch_quant.py (boxes within the bf16 twin rule,
  SDFs within twice JAX's own int8 twin's drift from its f32 module);
  the twin of the sharded module holds one row-split Int8Conv3d per
  tensor-parallel ResBlock;
* `dp.dp_tp_sample` under `sample_conv: winograd` against JAX's
  `build_dp_tp_sample` on a (1, 2) mesh under the bf16 twin rule of
  tests/test_torch_factored.py (as tests/test_torch_winograd.py holds the
  unsharded sample: SDFs under twice JAX's drift without its caps), and
  the row-split site runs `winograd_conv3d` with its shard's transformed
  weight;
* one shape-denoiser evaluation of each sharded twin against JAX's on the
  (1, 2) mesh (`shape_eps` under jit over the placed parameters), on the
  same perturbed weights and inputs: the Winograd twin under the whole
  bf16 twin rule, the int8 twin within twice JAX's int8 twin's drift from
  its f32 module.  The whole samples cannot show the shape denoiser's
  rounding: the VQ-VAE snaps each latent to its nearest code, so a
  denoiser output that moves by ~2% of its peak can leave the SDFs
  bit-equal;
* (e) on a card (`cuda` marker): Q1's split passes bit-equal to the fused
  Q1 and to the plain version, the int32 Q2 equal to its plain version's
  accumulators at a tp rank's input channels of the flagship's three
  row-split sites, and `dequantize` of those accumulators bit-equal to
  Q2's fused epilogue.
"""
import copy
import functools
import os
import tempfile
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
# jax is imported inside the tests that use it: the GPU machine has no jax
# and runs the `cuda` tests of this file with `-m cuda --noconftest`

BF16_DRIFTS = 2.0           # the bf16 twin rule (test_torch_factored.py)
BF16_MAX = 2.0 ** -4
BF16_MEAN = 2.0 ** -5
INT8_DRIFTS = 2.0           # SDFs: twice JAX's int8 twin's drift
RESBLOCK_MAX = 2.0 ** -7    # an int8 ResBlock against JAX's, of the peak


def _errors(got, want):
    """(max error of the peak, mean error of the mean magnitude)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    return (float(err.max() / np.abs(want).max()),
            float(err.mean() / np.abs(want).mean()))


def _conv(w, b):
    conv = torch.nn.Conv3d(w.shape[1], w.shape[0], w.shape[2:], padding=1)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    return conv


def _int8_resblock(block, row_split=None):
    """The int8 twin of a ResBlock as `inference_twin` makes it; with
    `row_split` (a tensor-parallel block's plan), `out_layers.3` in the
    row-split form."""
    from echoscene_torch.nn.quant import Int8Conv3d, jax_rounding_

    twin = copy.deepcopy(block).eval()
    twin.in_layers[2] = Int8Conv3d(twin.in_layers[2])
    twin.out_layers[3] = Int8Conv3d(twin.out_layers[3], row_split=row_split)
    if isinstance(twin.skip_connection, torch.nn.Conv3d):
        twin.skip_connection = Int8Conv3d(twin.skip_connection)
    keep = {id(p) for m in twin.modules() if isinstance(m, Int8Conv3d)
            for p in m.parameters()}
    keep |= jax_rounding_(twin)
    for p in twin.parameters():
        if id(p) not in keep:
            p.data = p.data.to(torch.bfloat16)
    return twin


def _resblock(sd):
    from echoscene_torch.nn.blocks import ResBlock

    block = ResBlock(32, 64, 48)
    block.load_state_dict(sd, strict=True)
    return block


@torch.no_grad()
def _rank_job(rank, world, job_path, out_dir):
    """One rank of the (1, 2) mesh: (a) to (d) of the module docstring on
    this rank's shards; writes its results to out_dir/rank{rank}.pt."""
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.sgdiff import SGDiff
    from echoscene_torch.nn.blocks import WinogradConv3d
    from echoscene_torch.nn.quant import Int8Conv3d, _group_max
    from echoscene_torch.parallel import tp
    from echoscene_torch.parallel.dp import dp_tp_sample
    from echoscene_torch.parallel.mesh import make_mesh

    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(1, world)
    plan = types.SimpleNamespace(group=mesh.model_group)
    mine = lambda t, dim: t.chunk(world, dim)[rank].contiguous()
    res = {}
    # (a) Q1's plain passes over the channel shards
    x = mine(job["q1_x"], 1)
    word = q8.quantize_amax(x)
    res["q1_own_word"] = word.clone()
    res["q1"] = q8.quantize_with_amax(x, _group_max(word, plan.group))
    # (b) the row-split Int8Conv3d
    w, b, xc = job["conv"]
    conv = Int8Conv3d(_conv(mine(w, 1), b), row_split=plan)
    res["conv_wq"], res["conv_w_scale"] = conv.wq, conv.w_scale
    res["conv_acc"] = conv.accumulate(mine(xc, 1))[0]
    res["conv_out"] = conv(mine(xc, 1))
    # (c) a tensor-parallel ResBlock of the int8 twin
    holder = torch.nn.Module()
    holder.shape_denoiser = torch.nn.ModuleList([_resblock(job["res_sd"])])
    tp.shard_module_(holder, mesh)
    block = holder.shape_denoiser[0]
    res["res_class"] = type(block).__name__
    res["res_out"] = _int8_resblock(block, block.tp)(*job["res_in"])
    # (d) dp x tp samples of the tiny config, int8 and Winograd
    for name, dtype, conv in (("int8", "int8", "direct"),
                              ("winograd", "bfloat16", "winograd")):
        cfg = copy.deepcopy(job["cfg"])
        cfg.sample_dtype, cfg.sample_conv = dtype, conv
        with torch.random.fork_rng(devices=[]):
            sg = SGDiff(cfg, job["num_objs"], job["num_preds"], device="cpu")
        sg.module.load_state_dict(job["state_dict"], strict=True)
        tp.shard_module_(sg.module, mesh)
        if name == "int8":
            twin = sg.inference_module()
            sd = twin.shape_denoiser
            res["tp_blocks"] = sum(isinstance(m, tp.TPResBlock)
                                   for m in sd.modules())
            res["row_split_convs"] = sum(
                isinstance(m.out_layers[3], Int8Conv3d)
                and m.out_layers[3].row_split is m.tp
                for m in sd.modules() if isinstance(m, tp.TPResBlock))
        else:
            twin = sg.inference_module()
            res["winograd_convs"] = sum(
                isinstance(m, WinogradConv3d)
                for m in twin.shape_denoiser.modules())
        del twin
        res[f"{name}_step"] = sg.inference_module().shape_eps(
            *job["step_args"]).float()
        res[f"{name}_sample"] = dp_tp_sample(
            sg, job["batch"], mesh, noise=job["noise"],
            shape_rows=job["rows"], with_manipulation=True)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _run_ranks(job, world=2):
    from echoscene_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory(prefix="echoscene_tp_int8_") as tmp:
        path = os.path.join(tmp, "job.pt")
        torch.save(job, path)
        spawn(_rank_job, world, args=(path, tmp), backend="gloo")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def tp_int8(tmp_path_factory):
    """JAX's tiny sample_fn in f32, and its dp x tp sample on a (1, 2) mesh
    under int8 and under Winograd, on the same perturbed weights and draws;
    JAX's int8 ResBlock; the port's ranks (`_rank_job`) and its unsharded
    counterparts of (a) to (c)."""
    import jax
    import jax.numpy as jnp

    from conftest import perturb_params
    from test_torch_port_sample import (_jax_config, _jax_fast_noise,
                                        _params_and_stats, _port_config,
                                        to_port_batch)
    from echoscene_tpu.data.collate import CollateSpec, collate_scenes
    from echoscene_tpu.data.fake import make_fake_dataset
    from echoscene_tpu.data.sgfront import SGFrontDataset
    from echoscene_tpu.models.echo_scene import EchoSceneModule as JM
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_tpu.models.sgdiff import shape_row_capacity
    from echoscene_tpu.nn.blocks import ResBlock as JResBlock
    from echoscene_tpu.parallel.dp import (build_dp_tp_sample,
                                           shard_params_for_model_parallel)
    from echoscene_tpu.parallel.mesh import make_mesh, stack_shards
    from echoscene_torch.convert import from_jax
    from echoscene_torch.models.echo_scene import rel_s_dims

    root = str(tmp_path_factory.mktemp("tp_int8_fake"))
    make_fake_dataset(root, num_scenes=4, min_objs=3, max_objs=4, sdf_res=16,
                      with_sdf=False)
    ds = SGFrontDataset(root, use_sdf=False, with_changes=True, seed=3,
                        sdf_res=16)

    def config(sample_dtype="float32", sample_conv="direct"):
        cfg = _jax_config(2)
        cfg.layout_diffusion.sampler = "dpmpp"
        cfg.layout_diffusion.sample_steps = 3
        cfg.shape_branch.sampler = "dpmpp"
        cfg.shape_branch.ddim_steps = 2
        cfg.sample_dtype = sample_dtype
        cfg.sample_conv = sample_conv
        return cfg

    cfg = config()
    spec = CollateSpec(max_nodes=cfg.max_nodes, max_triples=cfg.max_triples,
                       max_scenes=cfg.batch_scenes)
    batch = collate_scenes([ds[i] for i in range(3)], spec)
    num_objs, num_preds = len(ds.classes), len(ds.pred_names)
    n = batch.num_nodes
    rows = shape_row_capacity(batch)
    rng = jax.random.PRNGKey(9)
    jsg = JSGDiff(cfg, num_objs=num_objs, num_preds=num_preds)
    params, stats = _params_and_stats(jsg.module, batch,
                                      jnp.zeros((n, cfg.embedding_dim)))
    host = lambda out: {k: np.asarray(v, np.float32) for k, v in out.items()}
    want = {"float32": host(jax.jit(functools.partial(
        jsg.sample_fn, gen_shape=True, with_manipulation=True,
        shape_rows=rows))(params, stats, batch, rng))}
    mesh = make_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    placed = shard_params_for_model_parallel(params, mesh)
    # one shape step's inputs (tests/test_torch_winograd.py's)
    r = np.random.default_rng(3)
    sd = cfg.shape_branch.denoiser
    m = 8
    step_args = [
        r.standard_normal((m,) + (sd.image_size,) * 3
                          + (cfg.shape_branch.vqvae.embed_dim,)
                          ).astype(np.float32),
        np.full((m,), 7, np.int64),
        r.standard_normal((m, 1, rel_s_dims(_port_config(cfg))[-1])
                          ).astype(np.float32),
        np.asarray(batch.dec.triples)[:16].clip(0, m - 1),
        np.ones((m,), np.float32), np.ones((16,), np.float32)]

    def step(module, p):
        return np.asarray(jax.jit(lambda v: module.apply(
            v, *step_args, method=JM.shape_eps))(
                {"params": p, "batch_stats": stats}), np.float32)

    want["float32_step"] = step(jsg.module, params)
    for name, kw in (("int8", dict(sample_dtype="int8")),
                     ("winograd", dict(sample_dtype="bfloat16",
                                       sample_conv="winograd"))):
        tsg = JSGDiff(config(**kw), num_objs=num_objs, num_preds=num_preds)
        out = build_dp_tp_sample(tsg, mesh, gen_shape=True,
                                 with_manipulation=True, shape_rows=rows)(
            placed, stats, stack_shards([jax.device_get(batch)]), rng[None])
        want[name] = {k: v[0] for k, v in host(out).items()}
        want[f"{name}_step"] = step(tsg.module_infer, placed)

    # (c): JAX's int8 ResBlock on perturbed weights
    r = np.random.default_rng(6)
    xr = r.standard_normal((2, 4, 6, 6, 32)).astype(np.float32)
    emb = r.standard_normal((2, 64)).astype(np.float32)
    jx = jnp.asarray(xr).astype(jnp.bfloat16)
    jparams = perturb_params(jax.jit(JResBlock(
        channels=32, out_channels=48).init)(jax.random.PRNGKey(0), jx,
                                             jnp.asarray(emb)))["params"]
    want["resblock"] = np.asarray(JResBlock(
        channels=32, out_channels=48, dtype="int8").apply(
            {"params": jparams}, jx, jnp.asarray(emb)),
        np.float32).transpose(0, 4, 1, 2, 3)
    res_sd = from_jax.convert_resblock(jax.tree.map(np.asarray, jparams),
                                       "b")
    res_sd = from_jax.to_state_dict({k[2:]: v for k, v in res_sd.items()})
    res_in = (torch.from_numpy(xr.transpose(0, 4, 1, 2, 3)).bfloat16(),
              torch.from_numpy(emb))

    # (a), (b): seeded tensors whose abs-max lies in rank 1's shard
    g = np.random.default_rng(11)
    q1_x = torch.from_numpy(g.standard_normal((2, 80, 4, 6, 6)).astype(
        np.float32)).bfloat16()
    q1_x[1, 70, 2, 3, 3] = -9.5
    w = torch.from_numpy((g.standard_normal((40, 80, 3, 3, 3)) / 30).astype(
        np.float32))
    w[:, 60:] *= 3          # the larger weights on rank 1's channels
    b = torch.from_numpy(g.standard_normal(40).astype(np.float32) / 10)
    xc = torch.from_numpy(2 * g.standard_normal((2, 80, 4, 6, 6)).astype(
        np.float32)).bfloat16()

    pcfg = _port_config(cfg)
    job = {"cfg": pcfg, "num_objs": num_objs, "num_preds": num_preds,
           "state_dict": from_jax.to_state_dict(from_jax.checkpoint_to_module(
               from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
           "batch": to_port_batch(batch), "rows": rows,
           "noise": _jax_fast_noise(rng, n, cfg), "q1_x": q1_x,
           "step_args": [torch.from_numpy(a) for a in step_args],
           "conv": (w, b, xc), "res_sd": res_sd, "res_in": res_in}
    ranks = _run_ranks(job)
    return want, ranks, job


# --- (a) Q1 split over the channel shards -------------------------------------
def test_split_q1_plain_gives_the_whole_tensors_quantize(tp_int8):
    from echoscene_torch.kernels import int8_conv as q8

    _, ranks, job = tp_int8
    x = job["q1_x"]
    want_q, want_s = q8.quantize_plain(x)
    words = [r["q1_own_word"].view(torch.float32).item() for r in ranks]
    assert words[0] < words[1] == 9.5     # the abs-max is rank 1's
    c = x.shape[1] // 2
    for i, r in enumerate(ranks):
        q, s = r["q1"]
        assert torch.equal(s, want_s)
        assert q.shape[-1] == q8.padded_channels(c)
        assert torch.equal(q[..., :c], want_q[..., i * c:(i + 1) * c])
        assert not q[..., c:].any()


# --- (b) the row-split Int8Conv3d ---------------------------------------------
def _unsharded_conv(job):
    from echoscene_torch.nn.quant import Int8Conv3d

    w, b, xc = job["conv"]
    return Int8Conv3d(_conv(w, b)), xc


def test_row_split_int8_conv_weight_scales_match_unsharded(tp_int8):
    _, ranks, job = tp_int8
    full, _ = _unsharded_conv(job)
    c = job["conv"][0].shape[1] // 2
    for i, r in enumerate(ranks):
        assert torch.equal(r["conv_w_scale"], full.w_scale)
        assert torch.equal(r["conv_wq"][..., :c],
                           full.wq[..., i * c:(i + 1) * c])


def test_row_split_int8_conv_accumulators_match_unsharded(tp_int8):
    from echoscene_torch.kernels import int8_conv as q8

    _, ranks, job = tp_int8
    full, xc = _unsharded_conv(job)
    xq, _ = q8.quantize_plain(xc)
    want = q8.int8_conv3d_acc_plain(xq, full.wq, full.stride, full.pads)
    assert want.abs().max() > 2 ** 16
    for r in ranks:
        assert r["conv_acc"].dtype == torch.int32
        assert torch.equal(r["conv_acc"], want)


def test_row_split_int8_conv_output_is_bit_equal(tp_int8):
    _, ranks, job = tp_int8
    full, xc = _unsharded_conv(job)
    with torch.no_grad():
        want = full(xc)
    for r in ranks:
        assert r["conv_out"].dtype == torch.bfloat16
        assert torch.equal(r["conv_out"], want)


# --- (c) a TPResBlock of the int8 twin ----------------------------------------
def test_tp_int8_resblock_is_bit_equal_to_unsharded(tp_int8):
    """The shard's GroupNorm sums each group over the same contiguous
    values as the whole tensor's, so no ulp is lost anywhere."""
    _, ranks, job = tp_int8
    with torch.no_grad():
        want = _int8_resblock(_resblock(job["res_sd"]))(*job["res_in"])
    for r in ranks:
        assert r["res_class"] == "TPResBlock"
        assert torch.equal(r["res_out"], want)


def test_tp_int8_resblock_matches_jax(tp_int8):
    want, ranks, _ = tp_int8
    w = want["resblock"]
    assert np.abs(w).mean() > 1e-2
    for r in ranks:
        err = np.abs(r["res_out"].float().numpy() - w)
        assert err.max() <= RESBLOCK_MAX * np.abs(w).max()


# --- (d) the int8 dp x tp sample against JAX's GSPMD --------------------------
def test_tp_int8_twin_has_a_row_split_conv_per_block(tp_int8):
    """The int8 twin of the sharded module: a row-split Int8Conv3d at each
    TPResBlock's out_layers.3; the Winograd twin: WinogradConv3d at both
    convolutions of each."""
    _, ranks, _ = tp_int8
    for r in ranks:
        assert r["tp_blocks"] > 0
        assert r["row_split_convs"] == r["tp_blocks"]
        assert r["winograd_convs"] >= 2 * r["tp_blocks"]


def test_int8_dp_tp_sample_boxes_match_jax(tp_int8):
    want, ranks, _ = tp_int8
    for r in ranks:
        got = r["int8_sample"]
        for k in ("sizes", "translations", "angles"):
            drift = _errors(want["int8"][k], want["float32"][k])
            errs = _errors(got[k][0], want["int8"][k])
            print(f"{k}: port tp int8 vs JAX tp int8 {errs}; JAX int8 vs "
                  f"its f32 {drift}")
            for e, d, cap in zip(errs, drift, (BF16_MAX, BF16_MEAN)):
                assert e <= min(BF16_DRIFTS * d, cap), (k, errs, drift)
        assert np.array_equal(got["keep"][0], want["int8"]["keep"])


def test_int8_dp_tp_sample_shapes_match_jax(tp_int8):
    want, ranks, _ = tp_int8
    w8 = want["int8"]["shapes"]
    assert np.abs(w8).max() > 1e-2
    drift = _errors(w8, want["float32"]["shapes"])
    for r in ranks:
        errs = _errors(r["int8_sample"]["shapes"][0], w8)
        print(f"SDFs: port tp int8 vs JAX tp int8 {errs}; JAX int8 vs its "
              f"f32 {drift}")
        for e, d in zip(errs, drift):
            assert e <= INT8_DRIFTS * d, (errs, drift)
    # the model group's ranks agree
    assert np.array_equal(ranks[0]["int8_sample"]["shapes"],
                          ranks[1]["int8_sample"]["shapes"])


# --- Winograd under tensor parallelism ----------------------------------------
@pytest.mark.parametrize("key", ["sizes", "translations", "angles",
                                 "shapes"])
def test_winograd_dp_tp_sample_matches_jax(tp_int8, key):
    """Boxes under the whole bf16 twin rule; SDFs within twice JAX's drift
    without its caps, as tests/test_torch_winograd.py holds the unsharded
    Winograd sample (a whole bf16 chain and decode drift past them)."""
    want, ranks, _ = tp_int8
    drift = _errors(want["winograd"][key], want["float32"][key])
    caps = (BF16_MAX, BF16_MEAN) if key != "shapes" else (np.inf, np.inf)
    for r in ranks:
        errs = _errors(r["winograd_sample"][key][0], want["winograd"][key])
        print(f"{key}: port tp Winograd twin vs JAX's {errs}; JAX's tp "
              f"Winograd twin vs its f32 module {drift}")
        for e, d, cap in zip(errs, drift, caps):
            assert e <= min(BF16_DRIFTS * d, cap), (key, errs, drift)
    if key == "shapes":
        assert np.abs(want["winograd"][key]).max() > 1e-2


@pytest.mark.parametrize("name", ["winograd", "int8"])
def test_tp_twin_shape_step_matches_jax(tp_int8, name):
    """One shape-denoiser evaluation of the port's sharded twin against
    JAX's on the (1, 2) mesh: Winograd under the whole bf16 twin rule, int8
    within twice JAX's int8 twin's drift from its f32 module."""
    want, ranks, _ = tp_int8
    w = want[f"{name}_step"]
    drift = _errors(w, want["float32_step"])
    caps = ((BF16_MAX, BF16_MEAN) if name == "winograd"
            else (np.inf, np.inf))
    factor = BF16_DRIFTS if name == "winograd" else INT8_DRIFTS
    for r in ranks:
        errs = _errors(r[f"{name}_step"].numpy(), w)
        print(f"{name} shape step: port tp twin vs JAX's tp twin {errs}; "
              f"JAX's tp twin vs its f32 module {drift}")
        for e, d, cap in zip(errs, drift, caps):
            assert e <= min(factor * d, cap), (errs, drift)


def test_tp_row_split_runs_winograd(monkeypatch):
    """The Winograd twin of a sharded module: each TPResBlock's row-split
    `out_layers.3` goes through `winograd_conv3d` with its shard's
    transformed weight and no bias (the bias is added once after the sum
    over the group), its column-split `in_layers.2` through the
    WinogradConv3d itself."""
    from echoscene_torch.benchmarks import seeded_weights_
    from echoscene_torch.kernels import winograd
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.echo_scene import EchoSceneModule
    from echoscene_torch.models.sgdiff import inference_twin
    from echoscene_torch.nn.blocks import WinogradConv3d
    from echoscene_torch.parallel import tp
    from echoscene_torch.parallel.mesh import Mesh

    torch.manual_seed(0)
    module = EchoSceneModule(tiny_config(), 9, 16)
    seeded_weights_(module, 0)
    full = copy.deepcopy(module.shape_denoiser)
    tp.shard_module_(module, Mesh(1, 2, 0, 1))
    twin = inference_twin(module, torch.bfloat16, winograd=True)
    blocks = [m for m in twin.shape_denoiser.modules()
              if isinstance(m, tp.TPResBlock)]
    assert blocks
    block = blocks[0]
    name = next(n for n, m in twin.shape_denoiser.named_modules()
                if m is block)
    conv = block.out_layers[3]
    assert isinstance(conv, WinogradConv3d)
    # the shard's transform: rank 1's half of the input channels
    w_full = dict(full.named_modules())[name].out_layers[3].weight
    half = w_full.shape[1] // 2
    assert torch.equal(conv.u, winograd.transform_weights(
        w_full[:, half:]).to(torch.bfloat16))
    calls = []

    def spy(x, w, b=None, u=None):
        calls.append((x.shape[1], b, u))
        return winograd.winograd_conv3d(x, w, b, u)

    monkeypatch.setattr(tp, "winograd_conv3d", spy)
    monkeypatch.setattr(tp._Exit, "apply", lambda x, group: x.float())
    c = block.in_layers[0].num_channels
    x = torch.randn(2, c, 4, 4, 4).bfloat16()
    emb = torch.randn(2, block.emb_layers[1].in_features).bfloat16()
    with torch.no_grad():
        block(x, emb)
    assert len(calls) == 1
    channels, bias, u = calls[0]
    assert channels == conv.in_channels == half
    assert bias is None and u is conv.u


# --- (e) on a card --------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_split_q1_matches_fused_and_plain(card, dtype):
    """Q1's two passes as two calls: the word, the int8 values and the
    scale bit-equal to the fused Q1 and to the plain passes, on a whole
    tensor and on a tp rank's channel shard with the group's word."""
    from echoscene_torch.kernels import int8_conv as q8

    gen = torch.Generator(device=card).manual_seed(4)
    for shape in ((4, 224, 16, 16, 16), (3, 112, 16, 16, 16),
                  (5, 37, 3, 5, 7), (4, 336, 16, 4, 4)):
        x = (3 * torch.randn(shape, generator=gen, device=card)).to(dtype)
        word = q8.quantize_amax(x)
        assert torch.equal(word, q8.quantize_amax_plain(x))
        got = q8.quantize_with_amax(x, word)
        fused = q8.quantize_act(x)
        plain = q8.quantize_plain(x)
        torch.cuda.synchronize()
        for want in (fused, plain):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        # a shard with a larger word from the other rank
        c = shape[1] // 2
        shard = x[:, :c].contiguous()
        other = (x.float().abs().amax() * 1.5).reshape(1).view(torch.int32)
        got = q8.quantize_with_amax(shard, other)
        want = q8.quantize_with_amax_plain(shard, other)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("c,spatial", [(224, (16, 16, 16)),
                                       (448, (16, 8, 8)),
                                       (672, (16, 4, 4))])
def test_cuda_int8_conv_acc_matches_plain(card, c, spatial):
    """Q2's int32 epilogue at a tp rank's input channels (c / 2, padded to
    32) of a row-split site: the accumulators equal the plain version's
    exactly, one launch, and `dequantize` of them is bit-equal to Q2's
    fused epilogue."""
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.nn.quant import quantize_weight

    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((4, c // 2) + spatial, generator=gen,
                    device=card).to(torch.bfloat16)
    xq, xs = q8.quantize_act(x)
    wq, ws = quantize_weight(torch.randn((c, c // 2, 3, 3, 3), generator=gen,
                                         device=card))
    bias = torch.randn(c, generator=gen, device=card)
    before = q8.LAUNCHES["int8_conv3d_acc"]
    acc = q8.int8_conv3d_acc(xq, wq)
    torch.cuda.synchronize()
    assert q8.LAUNCHES["int8_conv3d_acc"] == before + 1
    assert acc.dtype == torch.int32
    assert torch.equal(acc, q8.int8_conv3d_acc_plain(xq, wq))
    fused = q8.int8_conv3d(xq, wq, xs, ws, bias)
    torch.cuda.synchronize()
    assert torch.equal(q8.dequantize(acc, xs, ws, bias), fused)
