"""The port's evaluation path (echoscene_torch/eval, native.py) against JAX's.

CPU: chamfer takes the plain Gram form (kernel K4 runs on CUDA tensors
only), EMD is exact (scipy) or the auction, both on the CPU.  Tolerances:
chamfer values rtol 1e-5 / atol 1e-6 (same arithmetic, other summation
order); exact EMD and the metric dicts 1e-5.  The auction EMD is held to JAX
at 1e-5 on clouds whose distances are exact in f32 (collinear lattice
points): on random clouds the auction is chaotic, and JAX's own jitted and
eager runs of it differ by up to a few percent, so there the port is held
bid for bid to a NumPy transcription of JAX's loop fed the same distances
and eps.
The port's eval CLI then runs end to end at a tiny configuration on a fake
dataset, followed by the two metric CLIs on its outputs.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from echoscene_torch import native as p_native
from echoscene_torch.eval import pointcloud_metrics as P

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _clouds(rng, b=6, n=64):
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, n, 3)).astype(np.float32))


def _lattice(rng, b=6, n=64):
    """Points k * (1, 2, 2), k integer: every distance is an exact integer."""
    k = rng.integers(-40, 41, size=(b, n, 1)).astype(np.float32)
    return k * np.array([1, 2, 2], np.float32)


def _sphere_sdf(res=24, r=0.5, center=(0, 0, 0)):
    """tests/test_native_and_eval.py:18-22."""
    c = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                    + (z - center[2]) ** 2) - r).astype(np.float32)


def _assert_metrics_equal(got, want, rtol=RTOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-12,
                                   err_msg=k)


# --- point-cloud metrics ---------------------------------------------------
@pytest.mark.parametrize("n,m", [(64, 64), (100, 37)])
def test_chamfer_distance_matches_jax(rng, n, m):
    from echoscene_tpu.eval.pointcloud_metrics import chamfer_distance

    a = rng.normal(size=(6, n, 3)).astype(np.float32)
    b = rng.normal(size=(6, m, 3)).astype(np.float32)
    got = P.chamfer_distance(a, b, device="cpu")
    np.testing.assert_allclose(got, chamfer_distance(a, b), rtol=RTOL,
                               atol=ATOL)
    # tensors are used where they lie
    np.testing.assert_array_equal(
        P.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b)), got)


def test_pairwise_cd_emd_matches_jax(rng):
    from echoscene_tpu.eval.pointcloud_metrics import pairwise_cd_emd

    s, r = _clouds(rng, 5, 48)
    for bs in (2, 8):
        want = pairwise_cd_emd(s, r, batch_size=bs)
        got = P.pairwise_cd_emd(s, r, batch_size=bs, device="cpu")
        for g, w in zip(got, want):
            assert g.shape == w.shape == (5, 5)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_compute_all_metrics_emd_exact_matches_jax(rng):
    from echoscene_tpu.eval import pointcloud_metrics as J

    s, r = _clouds(rng)
    _assert_metrics_equal(
        P.compute_all_metrics(s, r, batch_size=4, emd_fn=P.emd_exact,
                              device="cpu"),
        J.compute_all_metrics(s, r, batch_size=4, emd_fn=J.emd_exact))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_all_metrics_emd_auction_matches_jax(seed):
    """On exact-distance clouds (collinear lattice points, ties included)
    the port's auction runs JAX's algorithm bid for bid."""
    from echoscene_tpu.eval import pointcloud_metrics as J

    r = np.random.default_rng(seed)
    s, ref = _lattice(r), _lattice(r)
    np.testing.assert_allclose(P.emd_auction(s, ref, device="cpu"),
                               J.emd_auction(s, ref), rtol=RTOL)
    _assert_metrics_equal(
        P.compute_all_metrics(s, ref, batch_size=4, emd_fn=P.emd_auction,
                              device="cpu"),
        J.compute_all_metrics(s, ref, batch_size=4, emd_fn=J.emd_auction))


def _auction_numpy(d, eps, iters=50):
    """JAX's `_auction_emd_single` loop (pointcloud_metrics.py:71-96),
    transcribed in NumPy with its (n, n) masked winner matrix, on a given
    f32 distance matrix and eps."""
    n = d.shape[0]
    prices = np.zeros(n, np.float32)
    owner = np.full(n, -1)
    rows = np.arange(n)
    for _ in range(iters):
        cost = d + prices[None, :]
        best_j = np.argmin(cost, axis=1)
        bid_inc = np.sort(cost, axis=1)[:, 1] - np.min(cost, axis=1) + eps
        colwise = np.where(best_j[:, None] == rows[None, :],
                           cost[rows, best_j][:, None], np.float32(np.inf))
        win_row = np.argmin(colwise, axis=0)
        has_bid = np.isfinite(np.min(colwise, axis=0))
        owner = np.where(has_bid, win_row, owner)
        prices = np.where(has_bid, prices + bid_inc[win_row], prices)
    owner = np.where(owner < 0, np.argmin(d, axis=0), owner)
    return d[owner, np.arange(n)]


def test_emd_auction_matches_jax_loop_on_random_clouds(rng):
    """Random clouds (near-tied bids): the port's scatter-min winner
    selection reproduces JAX's masked-matrix argmin bid for bid, given the
    same distances and eps."""
    a, b = _clouds(rng, b=4, n=96)
    got = P.emd_auction(a, b, device="cpu")
    for i in range(len(a)):
        x = [a[i][:, None, k] - b[i][None, :, k] for k in range(3)]
        d = np.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
        eps = np.float32(0.02) * np.float32(d.astype(np.float64).mean())
        want = _auction_numpy(d, eps)
        assert got[i] == pytest.approx(float(want.mean()), rel=1e-6)


def test_jsd_matches_jax(rng):
    from echoscene_tpu.eval.pointcloud_metrics import (
        jsd_between_point_cloud_sets)

    s = (rng.random((4, 256, 3)).astype(np.float32) - 0.5) * 0.9
    r = (rng.random((4, 256, 3)).astype(np.float32) - 0.5) * 0.7
    for res in (12, 28):
        got = P.jsd_between_point_cloud_sets(s, r, resolution=res)
        assert got == pytest.approx(jsd_between_point_cloud_sets(
            s, r, resolution=res), rel=RTOL, abs=1e-12)
    assert abs(P.jsd_between_point_cloud_sets(s, s, resolution=12)) < 1e-9


# --- consistency -----------------------------------------------------------
def test_consistency_from_sdfs_matches_jax():
    from echoscene_tpu.eval import consistency as J
    from echoscene_torch.eval import consistency as C

    sdfs = {1: _sphere_sdf(), 2: _sphere_sdf(), 3: _sphere_sdf(r=0.3),
            4: _sphere_sdf(r=0.4, center=(0.1, 0, 0))[..., None]}
    groups = [[1, 2], [1, 3], [2, 3, 4], [5, 1]]
    cats = {1: "chair", 2: "table"}
    want = J.consistency_from_sdfs(sdfs, groups, cats, n_points=2000)
    got = C.consistency_from_sdfs(sdfs, groups, cats, n_points=2000,
                                  device="cpu")
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=RTOL, atol=ATOL)
    assert got[0][1] < 1e-6 < got[1][1]
    clouds = [p_native.sdf_to_point_cloud(sdfs[i], 2000, normalize=False)
              for i in (1, 3)]
    assert C.pair_chamfer(*clouds, device="cpu") == pytest.approx(
        got[1][1], rel=RTOL)
    agg, jagg = C.aggregate_consistency(got), J.aggregate_consistency(want)
    assert agg.keys() == jagg.keys()
    for k in agg:
        assert agg[k] == pytest.approx(jagg[k], rel=RTOL, abs=ATOL)
    assert C.consistency_from_sdfs(sdfs, [[1]], device="cpu") == []
    # the CLIP option (pixel proxy): the same pair distances as JAX's
    from echoscene_tpu.eval.clip_image import ClipImageEncoder as JClip
    from echoscene_torch.eval.clip_image import ClipImageEncoder as PClip
    jclip, pclip = [], []
    J.consistency_from_sdfs(sdfs, groups, cats, n_points=2000,
                            clip_encoder=JClip("pixel"), clip_results=jclip)
    C.consistency_from_sdfs(sdfs, groups, cats, n_points=2000,
                            clip_encoder=PClip("pixel"), clip_results=pclip,
                            device="cpu")
    assert [c for c, _ in pclip] == [c for c, _ in jclip] == [
        c for c, _ in got]
    np.testing.assert_allclose([v for _, v in pclip], [v for _, v in jclip],
                               atol=1e-6, rtol=0)


# --- native library --------------------------------------------------------
def test_native_matches_jax_bit_for_bit():
    from echoscene_tpu import native as J

    assert p_native.available() and J.available()
    g = np.linspace(-1, 1, 21, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sdf = (np.sqrt((x - 0.1) ** 2 + 1.3 * y ** 2 + z ** 2) - 0.55
           + 0.08 * np.sin(4 * x)).astype(np.float32)
    for a, b in zip(p_native.marching_cubes(sdf), J.marching_cubes(sdf)):
        np.testing.assert_array_equal(a, b)
    for norm in (True, False):
        np.testing.assert_array_equal(
            p_native.sdf_to_point_cloud(sdf, 500, seed=3, normalize=norm),
            J.sdf_to_point_cloud(sdf, 500, seed=3, normalize=norm))
    r = np.random.default_rng(4)
    a = r.normal(size=(3, 80, 3)).astype(np.float32)
    b = r.normal(size=(3, 80, 3)).astype(np.float32)
    np.testing.assert_array_equal(p_native.chamfer_batch(a, b),
                                  J.chamfer_batch(a, b))
    np.testing.assert_array_equal(p_native.emd_batch(a, b),
                                  J.emd_batch(a, b))
    np.testing.assert_allclose(p_native.chamfer_batch(a, b),
                               P.chamfer_distance(a, b, device="cpu"),
                               rtol=1e-4, atol=1e-5)


def test_native_numpy_fallbacks_match_jax():
    from echoscene_tpu import native as J

    sdf = _sphere_sdf(17, r=0.45, center=(0.05, -0.1, 0))
    v, t = p_native._marching_tetrahedra_numpy(sdf, 0.0)
    jv, jt = J._marching_tetrahedra_numpy(sdf, 0.0)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p_native._sample_mesh_numpy(v, t, 300, 7),
                                  J._sample_mesh_numpy(jv, jt, 300, 7))


# --- constraint metrics ----------------------------------------------------
def _vocab():
    from echoscene_torch.data.fake import (FAKE_FINE_CLASSES, FAKE_MAPPING,
                                           FAKE_RELATIONSHIPS)
    return {"object_idx_to_name": [FAKE_MAPPING[c] + "\n"
                                   for c in FAKE_FINE_CLASSES],
            "pred_idx_to_name": [p + "\n"
                                 for p in ["in"] + FAKE_RELATIONSHIPS]}


def _scene(seed, n=7, t=30):
    r = np.random.default_rng(seed)
    boxes = np.concatenate([r.uniform(0.2, 2.0, (n, 3)),
                            r.uniform(-2, 2, (n, 3)),
                            r.uniform(-np.pi, np.pi, (n, 1))], 1)
    triples = np.stack([r.integers(0, n, t), r.integers(0, 16, t),
                        r.integers(0, n, t)], 1)
    keep = (r.random(n) > 0.3).astype(np.float32)
    return boxes.astype(np.float32), triples, keep


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validate_constrains_match_jax(seed):
    from echoscene_tpu.eval import metrics as J
    from echoscene_torch.eval import metrics as M

    boxes, triples, keep = _scene(seed)
    preds = _vocab()["pred_idx_to_name"]
    for strict in (True, False):
        for keep_ in (None, keep):
            assert (M.validate_constrains(triples, boxes, keep_, preds,
                                          strict=strict)
                    == J.validate_constrains(triples, boxes, keep_, preds,
                                             strict=strict))
        assert (M.validate_constrains_changes(triples, boxes, keep, preds,
                                              strict=strict)
                == J.validate_constrains_changes(triples, boxes, keep, preds,
                                                 strict=strict))
    for i in range(len(boxes) - 1):
        assert M.box3d_iou(boxes[i], boxes[i + 1], True) == J.box3d_iou(
            boxes[i], boxes[i + 1], True)


def test_pointcloud_overlap_matches_jax(rng):
    from echoscene_tpu.eval import metrics as J
    from echoscene_torch.eval import metrics as M

    boxes, triples, _ = _scene(3, n=4, t=5)
    pcs = [rng.normal(size=(40, 3)).astype(np.float32) for _ in range(4)]
    objs = [1, 2, 3, 6]
    v = _vocab()
    assert (M.pointcloud_overlap(pcs, objs, boxes, triples,
                                 v["object_idx_to_name"],
                                 v["pred_idx_to_name"])
            == J.pointcloud_overlap(pcs, objs, boxes, triples,
                                    v["object_idx_to_name"],
                                    v["pred_idx_to_name"]))


# --- SceneEvaluator.score_scene --------------------------------------------
class _DS:
    vocab = _vocab()


class _Ex:
    def __init__(self, seed):
        self.boxes, self.triples, _ = _scene(seed, n=6, t=12)
        self.boxes = np.clip(self.boxes / 2.5, -1, 1)   # scaled boxes
        self.objs = np.asarray([1, 3, 3, 6, 8, 0])
        self.num_nodes = 6
        self.instance_ids = [4, 2, 7, 1, 3]
        self.scan_id = f"scene_{seed}"


def _out_slice(seed):
    r = np.random.default_rng(seed + 10)
    return {"sizes": r.uniform(-1, 1, (6, 3)).astype(np.float32),
            "translations": r.uniform(-1, 1, (6, 3)).astype(np.float32),
            "angles": r.uniform(-np.pi, np.pi, (6, 1)).astype(np.float32),
            "keep": np.asarray([1, 0, 1, 1, 0, 1], np.float32),
            "shapes": r.normal(size=(6, 8, 8, 8, 1)).astype(np.float32)}


@pytest.mark.parametrize("etype", ["none", "relationship"])
@pytest.mark.parametrize("bin_angle", [False, True])
def test_score_scene_matches_jax(tmp_path, etype, bin_angle):
    from echoscene_tpu.eval.evaluator import SceneEvaluator as JEval
    from echoscene_tpu.eval.metrics import new_accuracy_dict as jnew
    from echoscene_torch.eval.evaluator import SceneEvaluator as PEval
    from echoscene_torch.eval.metrics import new_accuracy_dict as pnew

    if bin_angle:   # the (2, >=6) mean / std file of the legacy path
        stats = np.asarray([[1.0, 0.9, 1.1, 0.1, 0.2, -0.1, 0.0],
                            [0.5, 0.4, 0.6, 1.5, 0.3, 1.4, 1.0]], np.float32)
    else:
        stats = np.asarray([0.05, 0.05, 0.05, 3.5, 3.0, 3.5, -3, -3, -3,
                            3, 3, 3, -np.pi, np.pi], np.float32)
    kw = dict(gen_shape=True, dump_sdfs=True, export_3d=True,
              bin_angle=bin_angle)
    jev = JEval(None, None, None, stats, store_path=str(tmp_path / "j"), **kw)
    pev = PEval(None, None, stats, store_path=str(tmp_path / "p"), **kw)
    accs = {}
    for name, ev, new in (("j", jev, jnew), ("p", pev, pnew)):
        acc, unch = new(), new()
        for seed in (0, 1):
            out = _out_slice(seed)
            if bin_angle:
                out["angles"] = np.random.default_rng(seed).normal(
                    size=(6, 24)).astype(np.float32)
            ev.score_scene(_DS(), _Ex(seed), out, etype, acc, unch)
        accs[name] = (acc, unch)
    assert accs["p"] == accs["j"]
    assert sum(len(v) for v in accs["p"][0].values()) > 0
    for seed in (0, 1):
        sid = f"scene_{seed}"
        with np.load(tmp_path / "p" / f"{sid}.npz") as p, \
                np.load(tmp_path / "j" / f"{sid}.npz") as j:
            assert sorted(p.files) == sorted(j.files) == [
                "categories", "instance_ids", "sdfs"]
            for k in j.files:
                assert p[k].dtype == j[k].dtype
                np.testing.assert_array_equal(p[k], j[k])
        rel = os.path.join("export_3d", f"{etype}_{sid}.json")
        with open(tmp_path / "p" / rel) as p, open(tmp_path / "j" / rel) as j:
            assert json.load(p) == json.load(j)


@pytest.mark.parametrize("etype", ["none", "addition"])
def test_evaluator_run_groups_and_skips_like_jax(tmp_path, etype):
    """`run`'s grouping, requeue and over-capacity skips, scoring and
    report, port against JAX, with both samplers stubbed to return each
    batch's ground-truth boxes (so no model is needed)."""
    import types

    import jax
    from echoscene_tpu.data.clip_text import ClipTextEncoder as JClip
    from echoscene_tpu.data.collate import CollateSpec as JSpec
    from echoscene_tpu.data.sgfront import SGFrontDataset as JDS
    from echoscene_tpu.eval.evaluator import SceneEvaluator as JEval
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.eval.evaluator import SceneEvaluator

    root = make_fake_dataset(str(tmp_path / "data"), num_scenes=14,
                             min_objs=3, max_objs=8, with_sdf=False, seed=4)
    kw = dict(split="test", shuffle_objs=False, with_changes=etype != "none",
              eval_mode=etype != "none", eval_type=etype, seed=47)
    spec_kw = dict(max_nodes=8, max_triples=30, max_scenes=3, diffusion_bs=8)
    stats = np.asarray([0.05, 0.05, 0.05, 3.5, 3.0, 3.5, -3, -3, -3, 3, 3, 3,
                        -np.pi, np.pi], np.float32)

    def outputs(boxes, change):
        return {"sizes": boxes[:, :3], "translations": boxes[:, 3:6],
                "angles": boxes[:, 6:7], "keep": 1.0 - change}

    class _SG:
        device = torch.device("cpu")

        def sample_fn(self, batch, generator, **_):
            return outputs(batch.boxes, batch.change_flags)

    pev = SceneEvaluator(_SG(), CollateSpec(**spec_kw), stats,
                         store_path=str(tmp_path / "p"), eval_batch=3)
    pacc = pev.run(SGFrontDataset(root, clip=ClipTextEncoder("hash"), **kw),
                   etype, 0, None)[:2]
    jev = JEval(None, types.SimpleNamespace(params=None, batch_stats=None),
                JSpec(**spec_kw), stats, store_path=str(tmp_path / "j"),
                eval_batch=3)
    jev._sample = lambda p, s, b, k, manip, rows: outputs(
        np.asarray(b.boxes), np.asarray(b.change_flags))
    jacc = jev.run(JDS(root, clip=JClip("hash"), **kw), etype, 0,
                   jax.random.PRNGKey(0))[:2]
    assert pacc == jacc
    assert pev.skipped_scenes == jev.skipped_scenes != []
    name = f"{etype}_accuracy_analysis.txt"
    assert ((tmp_path / "p" / name).read_text()
            == (tmp_path / "j" / name).read_text())


def test_evaluator_raises_on_unported_options(tmp_path):
    """dp_devices > 1 still raises (the multi-GPU slice); render_dir is
    ported: the evaluator makes the directory, and the four render types
    are held to JAX's in tests/test_torch_port_images.py."""
    from echoscene_torch.eval.evaluator import SceneEvaluator

    with pytest.raises(NotImplementedError):
        SceneEvaluator(None, None, None, store_path=str(tmp_path),
                       dp_devices=2)
    ev = SceneEvaluator(None, None, None, store_path=str(tmp_path),
                        render_dir=str(tmp_path / "r"), render_type="onlybox",
                        export_glb=True)
    assert (tmp_path / "r").is_dir()
    assert (ev.render_dir, ev.render_type, ev.export_glb) == (
        str(tmp_path / "r"), "onlybox", True)


# --- the eval CLI end to end, then the metric CLIs -------------------------
TINY_YAML = """
layout_branch:
    denoiser_kwargs:
        in_channels: 8
        out_channels: 8
        model_channels: 16
        channel_mult: [1, 1]
        num_res_blocks: 1
        attention_resolutions: [2]
        num_heads: 4
        concat_dim: 32
        crossattn_dim: 32
        use_checkpoint: false
    diffusion_kwargs:
        time_num: 6
shape_branch:
    df_cfg: df.yaml
    ddim_steps: 3
    vq_cfg: vq.yaml
"""
TINY_DF = """
model:
  params:
    timesteps: 12
unet:
  params:
    image_size: 4
    model_channels: 8
    num_res_blocks: 1
    attention_resolutions: [2]
    channel_mult: [1, 2]
    num_heads: 2
    context_dim: 32
    use_checkpoint: false
"""
TINY_VQ = """
model:
  params:
    embed_dim: 3
    n_embed: 16
    ddconfig:
      ch: 4
      ch_mult: [1, 2, 4]
      resolution: 16
"""


def _write_obj(path, verts, tris):
    with open(path, "w") as f:
        for v in verts:
            f.write("v {} {} {}\n".format(*v))
        for t in tris:
            f.write("f {} {} {}\n".format(*(t + 1)))


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.eval import cli

    base = tmp_path_factory.mktemp("port_eval_cli")
    data = make_fake_dataset(str(base / "data"), num_scenes=2, min_objs=3,
                             max_objs=4, with_sdf=False, seed=2)
    exp = base / "exp"
    exp.mkdir()
    for name, text in (("tiny.yaml", TINY_YAML), ("df.yaml", TINY_DF),
                       ("vq.yaml", TINY_VQ)):
        (exp / name).write_text(text)
    margs = {"dataset": data, "room_type": "bedroom", "with_SDF": False,
             "use_scene_rels": True, "large": False,
             "diff_yaml": str(exp / "tiny.yaml"),
             "network_type": "echoscene", "with_CLIP": True,
             "replace_latent": True, "residual": False,
             "clip_backend": "hash"}
    (exp / "args.json").write_text(json.dumps(margs))
    store = base / "eval"
    argv = ["--exp", str(exp), "--gen_shape", "--dump_sdfs", "--export_3d",
            "--store_path", str(store), "--eval_batch", "2",
            "--max_nodes", "24", "--max_triples", "64",
            "--sample_dtype", "float32", "--device", "cpu"]
    results = cli.main(argv)
    return base, exp, store, argv, results


def test_eval_cli_end_to_end_cpu(eval_run):
    from echoscene_torch.data.sgfront import SGFrontDataset

    base, _, store, _, results = eval_run
    assert sum(len(v) for v in results["none"].values()) > 0
    report = (store / "none_accuracy_analysis.txt").read_text()
    num = r"(?:\d+\.\d\d|nan)"
    assert re.fullmatch(
        rf"acc & L/R: {num} & F/B: {num} & Bi/Sm: {num} & Ta/Sh: {num} "
        rf"& Stand: {num} & Close: {num} & Symm: {num}\. Total: &{num}\n"
        rf"means of mean: {num}\n\n", report), report
    ds = SGFrontDataset(str(base / "data"), split="test", shuffle_objs=False)
    assert len(ds) == 2
    for i in range(len(ds)):
        ex = ds[i]
        with np.load(store / f"{ex.scan_id}.npz") as d:
            assert d["sdfs"].shape == (ex.num_nodes, 16, 16, 16)
            assert d["sdfs"].dtype == np.float32
            assert np.isfinite(d["sdfs"]).all()
            assert list(d["instance_ids"]) == ex.instance_ids + [-1]
        assert (store / "export_3d" / f"none_{ex.scan_id}.json").exists()


def test_eval_cli_raises_on_unported_options(eval_run, tmp_path):
    """--dp_devices 2 and --sample_dtype int8 still raise; --render_dir
    and the render types run: a 256^2 render and a .glb per scene, with
    retrieval reading a size table and its OBJ meshes."""
    from PIL import Image
    from echoscene_torch.eval import cli
    from echoscene_torch.eval.render import box_mesh, export_obj

    base, _, _, argv, _ = eval_run
    for extra in (["--dp_devices", "2"], ["--sample_dtype", "int8"]):
        with pytest.raises(NotImplementedError):
            cli.main(argv + extra)
    with pytest.raises(ValueError, match="--mesh_db"):
        cli.main(argv + ["--render_type", "retrieval"])
    names = {n.strip() for n in open(os.path.join(
        str(base / "data"), "classes_bedroom.txt"))}
    table = {n: {f"{n}-0": [0.5, 0.6, 0.5]} for n in names}
    for n in names:
        os.makedirs(tmp_path / "3D-FUTURE-model" / f"{n}-0")
        export_obj(str(tmp_path / "3D-FUTURE-model" / f"{n}-0" /
                       "raw_model.obj"),
                   *box_mesh([0.5, 0.6, 0.5, 0, 0, 0, 0]))
    (tmp_path / "cat.json").write_text(json.dumps(table))
    i = argv.index("--store_path")
    fast = (argv[:i + 1] + [str(tmp_path / "s")] + argv[i + 2:]
            + ["--layout_sampler", "dpmpp", "--layout_steps", "3",
               "--shape_sampler", "dpmpp", "--shape_steps", "2",
               "--export_glb"])
    for rt, extra in (("echoscene", []),
                      ("retrieval", ["--mesh_db", str(tmp_path / "cat.json")])):
        out = tmp_path / rt
        cli.main(fast + ["--render_dir", str(out), "--render_type", rt]
                 + extra)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        glbs = [f for f in os.listdir(out) if f.endswith(f"_{rt}.glb")]
        assert len(pngs) == len(glbs) == 2
        for f in pngs:
            img = np.asarray(Image.open(out / f).convert("RGB"))
            assert img.shape == (256, 256, 3)
            assert len(np.unique(img.reshape(-1, 3), axis=0)) > 2
    assert os.listdir(tmp_path / "retrieval" / "object_meshes")


def test_eval_cli_fast_samplers_cpu(eval_run, tmp_path):
    """The eval CLI on the CPU with DPM++ layout and shape samplers: the
    report is written, the dumped SDFs are finite."""
    from echoscene_torch.eval import cli

    _, _, _, argv, _ = eval_run
    i = argv.index("--store_path")
    argv = argv[:i + 1] + [str(tmp_path)] + argv[i + 2:]
    results = cli.main(argv + ["--layout_sampler", "dpmpp", "--layout_steps",
                               "5", "--shape_sampler", "dpmpp",
                               "--shape_steps", "3", "--limit", "1"])
    assert sum(len(v) for v in results["none"].values()) > 0
    assert (tmp_path / "none_accuracy_analysis.txt").read_text().startswith(
        "acc & L/R:")
    dumps = [f for f in tmp_path.iterdir() if f.suffix == ".npz"]
    assert len(dumps) == 1
    with np.load(dumps[0]) as d:
        assert np.isfinite(d["sdfs"]).all() and np.abs(d["sdfs"]).max() > 0


def test_metric_clis_run_on_eval_outputs(eval_run):
    from echoscene_torch.eval import consistency_cli, mmd_cli

    base, _, store, _, _ = eval_run
    anns = {}
    for f in sorted(os.listdir(store)):
        if f.endswith(".npz"):
            with np.load(store / f) as d:
                iids = [int(i) for i in d["instance_ids"] if i >= 0]
            anns[f[:-4]] = [iids[:2], iids[1:3]]
    (base / "cons.json").write_text(json.dumps(anns))
    agg = consistency_cli.main(["--annotations", str(base / "cons.json"),
                                "--generated_dir", str(store),
                                "--num_points", "200", "--device", "cpu"])
    assert set(agg) >= {"total"} and np.isfinite(agg["total"])

    for name, radii in (("gen", (0.3, 0.5, 0.6)), ("ref", (0.35, 0.4, 0.7))):
        for cat in ("bed", "chair"):
            d = base / name / cat
            d.mkdir(parents=True)
            for k, r in enumerate(radii):
                v, t = p_native.marching_cubes(_sphere_sdf(12, r))
                _write_obj(d / f"{k}.obj", v, t)
    res = mmd_cli.main(["--generated_dir", str(base / "gen"),
                        "--reference_dir", str(base / "ref"),
                        "--num_points", "64", "--device", "cpu",
                        "--with_jsd"])
    assert sorted(res) == ["bed", "chair"]
    for r in res.values():
        assert {"lgan_mmd-CD", "lgan_cov-EMD", "1-NN-CD-acc", "jsd"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
