"""The port's image metrics of the eval path against JAX's.

Same inputs, made from a numpy seed, through the JAX function and the
port's, on the CPU.  Tolerances: FID-InceptionV3 features within 1e-4 of
their peak (full-width random weights from one state dict; other
convolution orders); the random-conv proxy within 1e-5 on JAX's weights
handed over; FID / KID within 1e-9 relative on the same features; retrieval
vertices within 1e-6; renders, DOT text, box stats and the tool outputs
equal; CLIP image features within 1e-7 (pixel proxy) and 1e-5 (a tiny
random transformers model saved to a temporary directory); consistency CLIP
distances within 1e-6.  jax is imported inside the JAX comparisons, so that
on the GPU machine, which has no jax,
    python -m pytest tests/test_torch_port_images.py -m cuda --noconftest
runs the `cuda` tests: the Inception module on the card against the CPU
with a PNG round trip through save_png and PIL, and the transformers CLIP
image backend on the card against the CPU.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from echoscene_torch.eval import fid as P_fid
from echoscene_torch.eval import inception_fid as P_inc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_RTOL = 1e-4     # Inception features, of their peak


def _read_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _script(name):
    """A module of scripts/ loaded by path (the scripts are not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state_dict(seed=0):
    """A full-width pytorch-fid state dict of random weights (numpy)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for s in P_inc.conv_specs():
        kh, kw = s["k"]
        fan_in = s["cin"] * kh * kw
        n = s["name"]
        sd[f"{n}.conv.weight"] = rng.normal(
            0, np.sqrt(2.0 / fan_in),
            size=(s["cout"], s["cin"], kh, kw)).astype(np.float32)
        sd[f"{n}.bn.weight"] = rng.uniform(0.5, 1.5, s["cout"]).astype(
            np.float32)
        sd[f"{n}.bn.bias"] = rng.normal(0, 0.1, s["cout"]).astype(np.float32)
        sd[f"{n}.bn.running_mean"] = rng.normal(0, 0.1, s["cout"]).astype(
            np.float32)
        sd[f"{n}.bn.running_var"] = rng.uniform(0.5, 1.5, s["cout"]).astype(
            np.float32)
    return sd


def _assert_feats(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FEAT_RTOL, err


@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """One state dict, JAX's params from it, and JAX's jitted `_forward`
    features of a (2, 75, 75, 3) input in [-1, 1]."""
    import jax
    import jax.numpy as jnp
    from echoscene_tpu.eval import inception_fid as J

    sd = _state_dict()
    params = J.convert_state_dict(sd)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 75, 75, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(J._forward)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    return sd, params, x, want, tmp_path_factory.mktemp("inception")


def _pytorch_fid_module(sd):
    """A scripted module whose state dict nests pytorch-fid's keys under
    `blocks.` (as the clean-fid TorchScript export nests them)."""
    root = torch.nn.Module()
    root.blocks = torch.nn.Module()
    for s in P_inc.conv_specs():
        parent = root.blocks
        for part in s["name"].split("."):
            if not hasattr(parent, part):
                setattr(parent, part, torch.nn.Module())
            parent = getattr(parent, part)
        parent.conv = torch.nn.Conv2d(s["cin"], s["cout"], s["k"],
                                      bias=False)
        parent.bn = torch.nn.BatchNorm2d(s["cout"], eps=1e-3)

    class Wrap(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.blocks = inner.blocks

        def forward(self, x):
            return x

    m = Wrap(root)
    m.load_state_dict({f"blocks.{k}": torch.from_numpy(v)
                       for k, v in sd.items()}, strict=False)
    return torch.jit.script(m)


@pytest.mark.parametrize("loader", ["state_dict", "torchscript", "npz",
                                    "fidjax_npz"])
def test_fid_inception_matches_jax_forward(inception, loader):
    from echoscene_tpu.eval import inception_fid as J

    sd, params, x, want, tmp = inception
    if loader == "state_dict":
        p = P_inc.convert_state_dict(sd)
    elif loader == "torchscript":
        path = str(tmp / "pt_inception.pt")
        _pytorch_fid_module(sd).save(path)
        p = P_inc.load_params(path)
    elif loader == "npz":
        path = str(tmp / "inception.npz")
        np.savez(path, **params)
        p = P_inc.load_params(path)
    else:
        # JAX converts a .pth once and caches <path>.fidjax.npz; the port
        # reads that cache (the .pth is garbage after JAX has read it)
        path = str(tmp / "weights.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        J.load_params(path)
        assert os.path.exists(path + ".fidjax.npz")
        with open(path, "wb") as f:
            f.write(b"not a checkpoint")
        p = P_inc.load_params(path)
    net = P_inc.FIDInceptionV3().load_params(p).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    _assert_feats(got, want)
    n = sum(t.numel() for t in net.parameters())
    assert n == 21_785_568   # conv weights + folded scale / bias


def test_inception_extractor_uint8_to_299_matches_jax(inception):
    """The full extractor, uint8 (N, 256, 256, 3) -> resize to 299 ->
    [-1, 1] -> features, port against JAX's `jax_inception_extractor`
    (through `get_extractor('inception:<npz>')` on both sides)."""
    from echoscene_tpu.eval.fid import get_extractor as j_get

    _, params, _, _, tmp = inception
    path = str(tmp / "extractor.npz")
    np.savez(path, **params)
    imgs = np.random.default_rng(2).integers(0, 256, (2, 256, 256, 3)).astype(
        np.uint8)
    ext = P_fid.get_extractor(f"inception:{path}", device="cpu")
    assert isinstance(ext, P_inc.InceptionExtractor)
    got = ext(imgs)
    want = j_get(f"inception:{path}")(imgs)
    assert got.shape == (2, 2048)
    _assert_feats(got, want)


def test_inception_conv_flops():
    assert P_inc.conv_flops(299) == 11_422_336_192


def test_random_conv_proxy_matches_jax_on_its_weights():
    """JAX's proxy weights (fid.py:33-38) handed over; an odd image size
    exercises XLA's asymmetric SAME padding and the -inf pool padding."""
    import jax
    from echoscene_tpu.eval.fid import random_conv_extractor as j_rc

    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    ws = [np.array(jax.random.normal(ks[0], (5, 5, 3, 32)) * (1 / np.sqrt(75))),
          np.array(jax.random.normal(ks[1], (5, 5, 32, 64))
                   * (1 / np.sqrt(800))),
          np.array(jax.random.normal(ks[2], (3, 3, 64, 128))
                   * (1 / np.sqrt(576))),
          np.array(jax.random.normal(ks[3], (256, 768)) * (1 / np.sqrt(256)))]
    imgs = np.random.default_rng(3).integers(0, 256, (3, 63, 63, 3)).astype(
        np.uint8)
    want = j_rc()(imgs)
    got = P_fid.random_conv_extractor(weights=ws, device="cpu")(imgs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the port's own draw: seeded, (N, 768), and no FID of the paper
    a = P_fid.random_conv_extractor(device="cpu")(imgs)
    b = P_fid.get_extractor("random", device="cpu")(imgs)
    assert a.shape == (3, 768) and np.array_equal(a, b)


@pytest.mark.parametrize("n", [(40, 30), (12, 25)])
def test_frechet_and_kid_match_jax(n):
    from echoscene_tpu.eval import fid as J

    rng = np.random.default_rng(4)
    f1 = rng.normal(size=(n[0], 16)).astype(np.float32)
    f2 = (rng.normal(size=(n[1], 16)) * 1.2 + 0.3).astype(np.float32)
    for got, want in ((P_fid.frechet_distance(f1, f2),
                       J.frechet_distance(f1, f2)),
                      (P_fid.kid_score(f1, f2, subset_size=10),
                       J.kid_score(f1, f2, subset_size=10))):
        assert got == pytest.approx(want, rel=1e-9, abs=0)


class _TinyNet(torch.nn.Module):
    """A home-made scripted feature network: (N, 3, 299, 299) -> (N, 8)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 7, stride=4)

    def forward(self, x):
        return torch.relu(self.conv(x)).mean(dim=(2, 3))


@pytest.fixture(scope="module")
def render_dirs(tmp_path_factory):
    """Two directories of 256^2 renders, the real set written by JAX's
    save_png, the generated one by the port's; and a tiny TorchScript
    feature network."""
    from echoscene_tpu.eval.render import save_png as j_save
    from echoscene_torch.eval.render import save_png as p_save

    base = tmp_path_factory.mktemp("renders")
    rng = np.random.default_rng(5)
    for d, save, names in (
            ("real", j_save, ["Bedroom-1", "MasterBedroom-2", "Library-3",
                              "SecondBedroom-4", "LivingRoom-5"]),
            ("fake", p_save, ["Bedroom-6", "MasterBedroom-7", "Library-8",
                              "Bedroom-9"])):
        for name in names:
            img = np.cumsum(rng.integers(0, 9, (256, 256, 3)), 1).astype(
                np.uint8)
            save(img, str(base / d / f"{name}.png"))
    torch.manual_seed(0)
    net = str(base / "tiny.pt")
    torch.jit.script(_TinyNet()).save(net)
    return base, net


def test_load_image_dir_matches_jax(render_dirs):
    from echoscene_tpu.eval import fid as J

    base, _ = render_dirs
    for d in ("real", "fake"):
        for filt in (None, P_fid.ROOM_FILTERS["bedroom"]):
            np.testing.assert_array_equal(
                P_fid.load_image_dir(str(base / d), filt),
                J.load_image_dir(str(base / d), filt))
    assert P_fid.ROOM_FILTERS == J.ROOM_FILTERS


@pytest.mark.parametrize("room_type", ["all", "bedroom"])
def test_compute_fid_kid_matches_jax(render_dirs, room_type):
    from echoscene_tpu.eval import fid as J

    base, net = render_dirs
    args = (str(base / "real"), str(base / "fake"), room_type,
            f"torchscript:{net}")
    got = P_fid.compute_fid_kid(*args, batch=2, device="cpu")
    want = J.compute_fid_kid(*args, batch=2)
    assert got["n_real"] == want["n_real"] and got["n_fake"] == want["n_fake"]
    for k in ("fid", "kid"):
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0)


def test_fid_cli_matches_jax_script(render_dirs, capsys):
    from echoscene_torch.eval import fid_cli

    base, net = render_dirs
    argv = ["--path_to_real_renderings", str(base / "real"),
            "--path_to_synthesized_renderings", str(base / "fake"),
            "--room_type", "bedroom", "--extractor", f"torchscript:{net}"]
    want = _script("compute_fid_scores_3dfront").main(argv)
    capsys.readouterr()
    got = fid_cli.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got.keys() == want.keys()
    assert (got["n_real"], got["n_fake"]) == (want["n_real"], want["n_fake"])
    for k in ("fid", "kid"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0)


def test_get_extractor_falls_back_to_torchscript(render_dirs):
    """'inception:' on a scripted net that holds no FID-Inception weights
    runs it as TorchScript, as JAX's get_extractor does."""
    _, net = render_dirs
    ext = P_fid.get_extractor(f"inception:{net}", device="cpu")
    assert not isinstance(ext, P_inc.InceptionExtractor)
    out = ext(np.zeros((2, 64, 64, 3), np.uint8))
    assert out.shape == (2, 8)


def test_save_png_matches_jax(tmp_path):
    """The port's save_png writes JAX's file, byte for byte, into a
    directory it makes."""
    from echoscene_tpu.eval.render import save_png as j_save
    from echoscene_torch.eval.render import save_png as p_save

    img = np.random.default_rng(6).integers(0, 256, (11, 9, 3)).astype(
        np.uint8)
    j_save(img, str(tmp_path / "j" / "r.png"))
    p_save(img, str(tmp_path / "p" / "r.png"))
    data = (tmp_path / "p" / "r.png").read_bytes()
    assert data == (tmp_path / "j" / "r.png").read_bytes()
    np.testing.assert_array_equal(_read_png(tmp_path / "p" / "r.png"), img)


# --- retrieval (tests/test_retrieval.py fixtures) ----------------------------
def _cube(sx, sy, sz):
    v = np.array([[x, y, z] for x in (0, sx) for y in (0, sy)
                  for z in (0, sz)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6]], np.int32)
    return v, f


@pytest.fixture(scope="module")
def mesh_dbs(tmp_path_factory):
    """tests/test_retrieval.py's fake 3D-FUTURE table and txt2shape results,
    written once; the two packages read the same files."""
    from echoscene_torch.eval.render import export_obj, export_ply

    root = tmp_path_factory.mktemp("future")
    table = {"bed": {}, "table": {}, "chair": {}}
    sizes = {"bed": [(2.0, 0.5, 1.6), (1.2, 0.4, 1.0)],
             "table": [(0.8, 0.7, 0.8)], "chair": [(0.5, 0.9, 0.5)]}
    for cat, szs in sizes.items():
        for k, s in enumerate(szs):
            jid = f"{cat}-{k}"
            table[cat][jid] = list(s)
            d = root / "3D-FUTURE-model" / jid
            d.mkdir(parents=True)
            export_obj(str(d / "raw_model.obj"), *_cube(*s))
    with open(root / "cat_jid_trainval.json", "w") as f:
        json.dump(table, f)
    for cat, n in [("bed", 2), ("table", 1), ("lamp", 1), ("chair", 1)]:
        d = root / "results" / cat
        d.mkdir(parents=True)
        for k in range(n):
            export_ply(str(d / f"res{k}.ply"), *_cube(1.0 + k, 1.0, 1.0))
    return root


CLASSES = ["_scene_", "bed", "table", "floor", "unknown_cat", "lamp"]
OBJS = [1, 2, 0, 3, 4, 5, 1]
BOXES7 = np.array([
    [2.0, 0.5, 1.6, 0, 0, 0, 0.0],
    [0.8, 0.7, 0.8, 1.5, 0, 1.5, 0.3],
    [1, 1, 1, 0, 0, 0, 0],            # _scene_: skipped
    [4, 0.1, 4, 0, 0, 0, 0],          # floor: skipped
    [1, 1, 1, -1, 0, -1, 0],          # no table entry: box fallback
    [0.4, 0.6, 0.4, -1.5, 0, 1.0, 1.2],
    [1.1, 0.45, 0.9, 1.0, 0, -1.5, -0.7],
], np.float32)


def _same_soup(got, want):
    (gv, gt, gc), (wv, wt, wc) = got, want
    np.testing.assert_allclose(gv, wv, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gc, wc)


def _same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


@pytest.mark.parametrize("without_lamp", [True, False])
def test_retrieval_matches_jax(mesh_dbs, tmp_path, without_lamp):
    from echoscene_tpu.eval import retrieval as J
    from echoscene_torch.eval import retrieval as R

    table = str(mesh_dbs / "cat_jid_trainval.json")
    jdb, pdb = J.SizeDatabase(table), R.SizeDatabase(table)
    for label, size in (("bed", [1.9, 0.5, 1.5]), ("bed", [1.1, 0.35, 1.0]),
                        ("table", [9, 9, 9]), ("no_such_cat", [1, 1, 1])):
        assert pdb.closest(label, size) == jdb.closest(label, size)
    obj = str(mesh_dbs / "3D-FUTURE-model" / "bed-0" / "raw_model.obj")
    for got, want in zip(R.read_obj(obj), J.read_obj(obj)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(R.place_retrieved(_cube(1, 2, 3)[0], BOXES7[1]),
                               J.place_retrieved(_cube(1, 2, 3)[0], BOXES7[1]),
                               atol=1e-6, rtol=0)
    kw = dict(without_lamp=without_lamp)
    _same_soup(R.assemble_scene_retrieval(OBJS, BOXES7, CLASSES, pdb,
                                          mesh_dir=str(tmp_path / "p"), **kw),
               J.assemble_scene_retrieval(OBJS, BOXES7, CLASSES, jdb,
                                          mesh_dir=str(tmp_path / "j"), **kw))
    _same_files(tmp_path / "p", tmp_path / "j")
    np.testing.assert_array_equal(
        R.render_scene_retrieval(OBJS, BOXES7, CLASSES, pdb, **kw),
        J.render_scene_retrieval(OBJS, BOXES7, CLASSES, jdb, **kw))

    res = str(mesh_dbs / "results")
    jdb, pdb = J.MeshResultsDir(res), R.MeshResultsDir(res)
    assert pdb.files("bed") == jdb.files("bed")
    assert pdb.pick("no_such_cat", 0) is None
    _same_soup(R.assemble_scene_txt2shape(OBJS, BOXES7, CLASSES, pdb,
                                          mesh_dir=str(tmp_path / "pt"), **kw),
               J.assemble_scene_txt2shape(OBJS, BOXES7, CLASSES, jdb,
                                          mesh_dir=str(tmp_path / "jt"), **kw))
    _same_files(tmp_path / "pt", tmp_path / "jt")
    np.testing.assert_array_equal(
        R.render_scene_txt2shape(OBJS, BOXES7, CLASSES, pdb, **kw),
        J.render_scene_txt2shape(OBJS, BOXES7, CLASSES, jdb, **kw))
    with pytest.raises(FileNotFoundError):
        R.MeshResultsDir(str(tmp_path / "missing"))


# --- SceneEvaluator renders ----------------------------------------------------
def _render_vocab():
    from echoscene_torch.data.fake import (FAKE_FINE_CLASSES, FAKE_MAPPING,
                                           FAKE_RELATIONSHIPS)
    return {"object_idx_to_name": [FAKE_MAPPING[c] + "\n"
                                   for c in FAKE_FINE_CLASSES],
            "pred_idx_to_name": [p + "\n"
                                 for p in ["in"] + FAKE_RELATIONSHIPS]}


class _DS:
    vocab = _render_vocab()


class _Ex:
    def __init__(self, seed):
        r = np.random.default_rng(seed)
        self.boxes = np.concatenate([r.uniform(-0.6, 0.6, (6, 6)),
                                     r.uniform(-np.pi, np.pi, (6, 1))],
                                    1).astype(np.float32)
        self.triples = np.stack([r.integers(0, 6, 10), r.integers(0, 16, 10),
                                 r.integers(0, 6, 10)], 1)
        self.objs = np.asarray([1, 3, 3, 6, 8, 0])
        self.num_nodes = 6
        self.instance_ids = [4, 2, 7, 1, 3]
        self.scan_id = f"scene_{seed}"


def _sphere_grids(n=6, res=10):
    c = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    return np.stack([r - 0.3 - 0.1 * i for i in range(n)])[..., None]


@pytest.mark.parametrize("render_type", ["echoscene", "onlybox", "retrieval",
                                         "txt2shape"])
@pytest.mark.parametrize("etype", ["none", "relationship"])
def test_score_scene_renders_match_jax(tmp_path, mesh_dbs, render_type,
                                       etype):
    """Both evaluators render the same out_slice: equal pixels (the scene
    and, for manipulated eval, the overlay) and .glb files that read back
    to the same geometry."""
    from echoscene_tpu.eval import retrieval as JR
    from echoscene_tpu.eval.evaluator import SceneEvaluator as JEval
    from echoscene_tpu.eval.metrics import new_accuracy_dict
    from echoscene_torch.eval import retrieval as PR
    from echoscene_torch.eval.evaluator import SceneEvaluator as PEval
    from echoscene_torch.eval.metrics import new_accuracy_dict as pnew
    from echoscene_torch.eval.render import read_glb

    fake_names = {n.strip() for n in _DS.vocab["object_idx_to_name"]}
    table = {n: {f"{n}-0": [0.8, 0.7, 0.8]} for n in fake_names}
    with open(tmp_path / "table.json", "w") as f:
        json.dump(table, f)
    for n in fake_names:
        d = tmp_path / "3D-FUTURE-model" / f"{n}-0"
        d.mkdir(parents=True)
        src = mesh_dbs / "3D-FUTURE-model" / "chair-0" / "raw_model.obj"
        (d / "raw_model.obj").write_bytes(src.read_bytes())
    stats = np.asarray([0.05, 0.05, 0.05, 3.5, 3.0, 3.5, -3, -3, -3, 3, 3, 3,
                        -np.pi, np.pi], np.float32)
    dbs = {}
    for name, R in (("j", JR), ("p", PR)):
        dbs[name] = dict(mesh_db=R.SizeDatabase(str(tmp_path / "table.json")),
                         txt2shape_db=R.MeshResultsDir(
                             str(mesh_dbs / "results")))
    kw = dict(gen_shape=True, render_type=render_type, export_glb=True)
    jev = JEval(None, None, None, stats, store_path=str(tmp_path / "js"),
                render_dir=str(tmp_path / "j"), **dbs["j"], **kw)
    pev = PEval(None, None, stats, store_path=str(tmp_path / "ps"),
                render_dir=str(tmp_path / "p"), **dbs["p"], **kw)
    r = np.random.default_rng(9)
    out = {"sizes": r.uniform(-0.5, 0.5, (6, 3)).astype(np.float32),
           "translations": r.uniform(-0.6, 0.6, (6, 3)).astype(np.float32),
           "angles": r.uniform(-np.pi, np.pi, (6, 1)).astype(np.float32),
           "keep": np.asarray([1, 0, 1, 1, 0, 1], np.float32),
           "shapes": _sphere_grids()}
    for ev, new in ((jev, new_accuracy_dict), (pev, pnew)):
        ev.score_scene(_DS(), _Ex(0), out, etype, new(), new())
    names = ["scene_0.png", f"scene_0_{render_type}.glb"]
    if etype != "none":
        names.append("scene_0_mani.png")
    for f in names:
        assert (tmp_path / "p" / f).exists(), f
    for f in names[::2]:
        got = _read_png(tmp_path / "p" / f)
        want = _read_png(tmp_path / "j" / f)
        assert got.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2
    glb = [read_glb(str(tmp_path / d / names[1])) for d in ("p", "j")]
    for a, b in zip(*glb):
        np.testing.assert_array_equal(a, b)
    meshes = tmp_path / "p" / "object_meshes" / "scene_0"
    if render_type in ("retrieval", "txt2shape"):
        _same_files(meshes, tmp_path / "j" / "object_meshes" / "scene_0")
    else:
        assert not meshes.exists()


# --- CLIP image features and the consistency CLIP option ---------------------
def test_clip_pixel_proxy_matches_jax():
    from echoscene_tpu.eval.clip_image import ClipImageEncoder as J
    from echoscene_tpu.eval.clip_image import pair_clip_distance as jd
    from echoscene_torch.eval.clip_image import ClipImageEncoder as P
    from echoscene_torch.eval.clip_image import pair_clip_distance as pd

    rng = np.random.default_rng(7)
    je, pe = J("pixel"), P("pixel")
    for shape in ((224, 224, 3), (37, 50, 4), (20, 20)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_allclose(pe.encode(img), je.encode(img),
                                   atol=1e-7, rtol=0)
    a, b = (rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
            for _ in range(2))
    assert pd(pe, a, b) == pytest.approx(jd(je, a, b), abs=1e-7)
    with pytest.raises(ValueError):
        P("no_such_backend")


@pytest.fixture(scope="module")
def tiny_clip(tmp_path_factory):
    """A random CLIP vision tower + image processor saved as a snapshot
    directory (no download)."""
    from transformers import (CLIPImageProcessor, CLIPVisionConfig,
                              CLIPVisionModelWithProjection)

    d = tmp_path_factory.mktemp("clip") / "clip-vit-base-patch32"
    torch.manual_seed(0)
    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=37,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8, projection_dim=16)
    CLIPVisionModelWithProjection(cfg).save_pretrained(str(d))
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}).save_pretrained(
                           str(d))
    return d


def test_clip_transformers_backend_matches_jax(tiny_clip, monkeypatch):
    from echoscene_tpu.eval.clip_image import ClipImageEncoder as J
    from echoscene_torch.eval.clip_image import ClipImageEncoder as P

    img = np.random.default_rng(8).integers(0, 256, (48, 40, 3)).astype(
        np.uint8)
    want = J("transformers", str(tiny_clip)).encode(img)
    got = P("transformers", str(tiny_clip), device="cpu").encode(img)
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # 'auto' resolves through the shared registry in both packages
    monkeypatch.setenv("ECHOSCENE_WEIGHTS_DIR", str(tiny_clip.parent))
    assert J("auto").backend == P("auto", device="cpu").backend == \
        "transformers"
    # no transformers package: a clear ImportError, never the pixel proxy
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        P("auto", device="cpu")


def test_consistency_clip_results_match_jax():
    from echoscene_tpu.eval import consistency as J
    from echoscene_tpu.eval.clip_image import ClipImageEncoder as JE
    from echoscene_torch.eval import consistency as C
    from echoscene_torch.eval.clip_image import ClipImageEncoder as PE

    grids = _sphere_grids(4, 16)[..., 0]
    sdfs = {i: grids[i] for i in range(4)}
    groups = [[0, 1, 2], [3, 0]]
    cats = {0: "bed", 1: "bed", 2: "bed", 3: "chair"}
    jres, pres = [], []
    want = J.consistency_from_sdfs(sdfs, groups, cats, n_points=300,
                                   clip_encoder=JE("pixel"),
                                   clip_results=jres)
    got = C.consistency_from_sdfs(sdfs, groups, cats, n_points=300,
                                  clip_encoder=PE("pixel"),
                                  clip_results=pres, device="cpu")
    assert [c for c, _ in got] == [c for c, _ in want]
    assert [c for c, _ in pres] == [c for c, _ in jres] and len(pres) == 4
    np.testing.assert_allclose([v for _, v in pres], [v for _, v in jres],
                               atol=1e-6, rtol=0)
    assert max(v for _, v in pres) > 0


def test_consistency_cli_clip_block_matches_jax_script(tmp_path, capsys):
    from echoscene_torch.eval import consistency_cli

    grids = _sphere_grids(3, 16)[..., 0]
    np.savez(tmp_path / "s0.npz", sdfs=grids, instance_ids=[5, 6, -1],
             categories=["bed", "bed", "_scene_"])
    (tmp_path / "a.json").write_text(json.dumps({"s0": [[5, 6]]}))
    argv = ["--annotations", str(tmp_path / "a.json"), "--generated_dir",
            str(tmp_path), "--num_points", "300", "--clip", "pixel"]
    want = _script("consistency_check").main(argv)
    capsys.readouterr()
    got = consistency_cli.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got.keys() == want.keys() and got["clip"].keys() == \
        want["clip"].keys()
    for k in got["clip"]:
        assert got["clip"][k] == pytest.approx(want["clip"][k], abs=1e-6)
    assert got["total"] == pytest.approx(want["total"], rel=1e-5, abs=1e-6)


# --- graph DOT ---------------------------------------------------------------
GRAPHS_YAML = """
Scenes:
  7:
    nodes: [bed, nightstand, lamp]
    relships: [[1, 0, left], [2, 1, standing on], [0, 1, right]]
    manipulations:
      - [chair, add, [[0, close by], [1, left]]]
      - ['', rel, [1, 0, left, right]]
      - ['', rel, [0, 1, right, [1, 2, front]]]
  8:
    nodes: [desk, chair]
    relships: [[1, 0, front]]
"""


def test_graph_viz_matches_jax(tmp_path):
    from echoscene_tpu.eval import graph_viz as J
    from echoscene_torch.eval import graph_viz as G

    classes = ["_scene_\n", "bed\n", "chair\n", "lamp\n"]
    preds = ["in\n", "left\n", "right\n", "standing on\n"]
    triples = np.array([[0, 1, 1], [2, 3, 1], [1, 2, 0]])
    for kw in ({}, dict(changed_nodes=[1], changed_triples=[0, 2],
                        title="mani")):
        assert (G.scene_graph_dot([1, 2, 3], triples, classes, preds, **kw)
                == J.scene_graph_dot([1, 2, 3], triples, classes, preds,
                                     **kw))
    (tmp_path / "g.yaml").write_text(GRAPHS_YAML)
    for manip in (False, True):
        got = G.load_scene_graphs_yaml(str(tmp_path / "g.yaml"), manip)
        assert got == J.load_scene_graphs_yaml(str(tmp_path / "g.yaml"),
                                               manip)
        for sid, scene in got.items():
            assert G.loaded_graph_dot(scene, sid) == J.loaded_graph_dot(
                scene, sid)
    rel = {"scans": [{"objects": {"1": "bed", "2": "lamp"},
                      "relationships": [[1, 2, 3, "left"]]}]}
    (tmp_path / "r.json").write_text(json.dumps(rel))
    (tmp_path / "o.json").write_text(json.dumps(
        {"objects": {"1": "desk"}, "triples": [[1, "front", 1]]}))
    for f in ("r.json", "o.json"):
        assert (G.load_graph_json(str(tmp_path / f))
                == J.load_graph_json(str(tmp_path / f)))
    dot = G.scene_graph_dot([1, 2], triples[:1], classes, preds)
    G.save_dot(dot, str(tmp_path / "p" / "g.dot"))
    J.save_dot(dot, str(tmp_path / "j" / "g.dot"))
    _same_files(tmp_path / "p", tmp_path / "j")


# --- tools: GT renders, box stats, the weights registry ----------------------
@pytest.mark.parametrize("with_sdf", [False, True])
def test_gt_renders_match_jax_script(tmp_path, with_sdf):
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.eval import gt_renders

    data = make_fake_dataset(str(tmp_path / "data"), num_scenes=4,
                             min_objs=3, max_objs=4, sdf_res=16,
                             with_sdf=with_sdf, seed=1)
    extra = ["--with_sdf", "--sdf_res", "16"] if with_sdf else []
    for name, main in (("j", _script("collect_gt_sdf_images").main),
                       ("p", gt_renders.main)):
        main(["--dataset", data, "--out", str(tmp_path / name)] + extra)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p")) and len(files) == 2
    for f in files:
        assert ((tmp_path / "p" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes())


def test_box_stats_match_jax_script(tmp_path):
    from echoscene_torch.data import box_stats
    from echoscene_torch.data.fake import make_fake_dataset

    data = make_fake_dataset(str(tmp_path / "data"), num_scenes=4,
                             with_sdf=False, seed=3)
    for name, main in (("j", _script("compute_box_stats").main),
                       ("p", box_stats.main)):
        main(["--dataset", data, "--out", str(tmp_path / f"{name}.txt")])
    assert ((tmp_path / "p.txt").read_text()
            == (tmp_path / "j.txt").read_text())
    assert np.loadtxt(tmp_path / "p.txt").shape == (14,)


@pytest.mark.parametrize("env_set", [True, False])
def test_weights_registry_matches_jax(tmp_path, monkeypatch, env_set):
    from echoscene_tpu import weights as J
    from echoscene_torch import weights as W
    from echoscene_torch.data import clip_text

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if env_set:
        monkeypatch.setenv("ECHOSCENE_WEIGHTS_DIR", str(tmp_path / "w"))
    else:
        monkeypatch.delenv("ECHOSCENE_WEIGHTS_DIR", raising=False)
    assert W.weights_dir() == J.weights_dir()
    assert W.status() == J.status()
    assert clip_text.ClipTextEncoder("auto").backend == "hash"
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "config.json").write_text("{}")
    dst = W.install_clip(str(snap))
    assert clip_text.clip_text_dir() == W.clip_text_dir() == \
        J.clip_text_dir() == dst
    src = tmp_path / "pt_inception-2015-12-05.pt"
    src.write_bytes(b"weights")
    assert W.install_inception(str(src)) == W.inception_weights() == \
        J.inception_weights()
    np.savez(tmp_path / "inception.npz", x=np.zeros(1))
    assert W.install_inception(str(tmp_path / "inception.npz")) == \
        J.inception_weights()
    for bad in (lambda: W.install_inception("https://example.invalid/w.pt"),
                lambda: W.install_clip("http://example.invalid/clip"),
                lambda: W.install_clip(str(src))):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(FileNotFoundError):
        W.install_inception(str(tmp_path / "missing.pt"))


def test_weights_cli_installs_and_smokes(tmp_path, monkeypatch, capsys):
    """`python -m echoscene_torch.weights`: installs from local paths,
    prints the status, and `--smoke` runs the installed Inception (random
    full-width weights) on the CPU."""
    from echoscene_torch import weights as W

    monkeypatch.setenv("ECHOSCENE_WEIGHTS_DIR", str(tmp_path / "w"))
    rep = W.main(["--smoke", "--device", "cpu"])
    assert rep["inception"] is None and "skipped" in rep["inception_smoke"]
    npz = tmp_path / "inception.npz"
    sd = _state_dict(1)
    np.savez(npz, **P_inc.convert_state_dict(sd))
    rep = W.main(["--inception", str(npz), "--smoke", "--device", "cpu"])
    assert rep["inception"] == str(tmp_path / "w" / "inception" /
                                   "inception.npz")
    assert rep["inception_smoke"] == "ok (2, 2048)"
    assert rep["clip_smoke"] == "skipped (not installed)"
    assert isinstance(P_fid.get_extractor("auto", device="cpu"),
                      P_inc.InceptionExtractor)
    capsys.readouterr()


# --- on the card ---------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_inception_matches_cpu_and_png_round_trip(tmp_path):
    """The FID-InceptionV3 module at full width on the card against the
    same module on the CPU (uint8 256^2 -> 299, TF32 off), within 1e-4 of
    the features' peak; and a render written by save_png and read back by
    PIL on the card's machine."""
    from echoscene_torch.eval.render import save_png

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = P_inc.convert_state_dict(_state_dict(2))
    imgs = np.random.default_rng(3).integers(0, 256, (4, 256, 256, 3)).astype(
        np.uint8)
    got = P_inc.InceptionExtractor(params, "cuda")(imgs)
    want = P_inc.InceptionExtractor(params, "cpu")(imgs)
    assert np.isfinite(got).all()
    _assert_feats(got, want)
    save_png(imgs[0], str(tmp_path / "r" / "r.png"))
    np.testing.assert_array_equal(_read_png(tmp_path / "r" / "r.png"),
                                  imgs[0])


@pytest.mark.cuda
def test_cuda_clip_transformers_matches_cpu(tiny_clip):
    """The transformers CLIP image backend with its encoder on the card
    against the same snapshot on the CPU (TF32 off), within 1e-5."""
    from echoscene_torch.eval.clip_image import ClipImageEncoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    card = ClipImageEncoder("transformers", str(tiny_clip), device="cuda")
    cpu = ClipImageEncoder("transformers", str(tiny_clip), device="cpu")
    assert next(card._hf[1].parameters()).device.type == "cuda"
    for shape in ((48, 40, 3), (224, 224, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        got = card.encode(img)
        assert got.shape == (16,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, cpu.encode(img), atol=1e-5, rtol=0)
