"""The port's generation service (echoscene_torch/serve) against JAX's.

`request_to_example` builds the same arrays and raises the same errors as
JAX's; `generate` on a list of requests gives JAX's results within 1e-4
(tiny f32 config, the same weights carried over by convert/from_jax.py, and
the port's sampler fed the draws JAX's service makes: its key split once per
dispatch, service.py:185, :521, then sgdiff.py:349, :393-395); the splice
store keeps untouched objects bit for bit; the micro-batcher, the HTTP
endpoint, warmup and row buckets behave as JAX's tests/test_serve.py holds
JAX's to; the meshes equal JAX's.  Everything runs on the CPU.
"""
import dataclasses
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_sample import (_jax_config, _jax_fast_noise,
                                    _params_and_stats, _port_config)

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """Classes, relationships, box stats and predicate count of a fake
    dataset (JAX's reader; the port's gives the same vocabulary)."""
    from echoscene_tpu.data.fake import make_fake_dataset
    from echoscene_tpu.data.sgfront import SGFrontDataset

    root = str(tmp_path_factory.mktemp("serve_fake"))
    make_fake_dataset(root, num_scenes=3, min_objs=3, max_objs=4, sdf_res=16,
                      with_sdf=False)
    ds = SGFrontDataset(root, use_sdf=False, with_changes=False, seed=1,
                        sdf_res=16)
    return types.SimpleNamespace(classes=ds.classes, rel_dict=ds.rel_dict,
                                 stats=ds.box_stats,
                                 num_preds=len(ds.pred_names))


def _names(v):
    return [n for n in v.classes if n != "_scene_"]


def _request(v, idx=0, k=3):
    names, preds = _names(v), list(v.rel_dict)
    return {"objects": names[:k],
            "triples": [[0, preds[0], 1], [1, preds[-1], k - 1]],
            "id": f"q{idx}"}


def _spec(cls, cfg):
    return cls(max_nodes=cfg.max_nodes, max_triples=cfg.max_triples,
               max_scenes=4, diffusion_bs=cfg.diffusion_bs, with_sdf=False)


@pytest.fixture(scope="module")
def port_service(vocab):
    """A port service on the CPU: tiny f32 config, DPM++ 6 / 3 steps,
    seeded weights."""
    from echoscene_torch.benchmarks import seeded_weights_
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff
    from echoscene_torch.serve.service import GenerationService

    cfg = tiny_config()
    cfg.sample_dtype = "float32"
    cfg.layout_diffusion.sampler = "dpmpp"
    cfg.layout_diffusion.sample_steps = 6
    cfg.shape_branch.sampler = "dpmpp"
    cfg.shape_branch.ddim_steps = 3
    sg = SGDiff(cfg, len(vocab.classes), vocab.num_preds, device="cpu")
    seeded_weights_(sg.module, 0)
    return GenerationService(sg, _spec(CollateSpec, cfg), vocab.stats,
                             vocab.classes, vocab.rel_dict,
                             clip=ClipTextEncoder("hash"), gen_shape=True)


def _manipulations(v):
    names, preds = _names(v), list(v.rel_dict)
    return {"plain": None,
            "addition": {"type": "addition", "object": names[1],
                         "triples": [[-1, preds[2], 0], [2, preds[3], -1]]},
            "relationship": {"type": "relationship", "index": 1,
                             "predicate": preds[4]}}


@pytest.mark.parametrize("kind", ["plain", "addition", "relationship"])
def test_request_to_example_matches_jax(vocab, kind):
    """Every array of the example (decoder and encoder views, masks,
    change flags, CLIP features) equals JAX's."""
    from echoscene_tpu.data.clip_text import ClipTextEncoder as JClip
    from echoscene_tpu.serve.service import request_to_example as jr2e
    from echoscene_torch.data.clip_text import ClipTextEncoder as PClip
    from echoscene_torch.serve.service import request_to_example as pr2e

    req = _request(vocab, 5, k=4)
    manip = _manipulations(vocab)[kind]
    want = jr2e(req, vocab.classes, vocab.rel_dict, JClip("hash"),
                manipulation=manip)
    got = pr2e(req, vocab.classes, vocab.rel_dict, PClip("hash"),
               manipulation=manip)
    assert got.manipulation_type == want.manipulation_type == (
        "none" if kind == "plain" else kind)
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def test_request_to_example_raises_as_jax(vocab):
    from echoscene_tpu.data.clip_text import ClipTextEncoder as JClip
    from echoscene_tpu.serve.service import request_to_example as jr2e
    from echoscene_torch.data.clip_text import ClipTextEncoder as PClip
    from echoscene_torch.serve.service import request_to_example as pr2e

    names, preds = _names(vocab), list(vocab.rel_dict)
    two = names[:2]
    bad = [({"objects": ["no_such_class"]}, {}),
           ({"objects": two, "triples": [[0, "no_such_rel", 1]]}, {}),
           ({"objects": []}, {}),
           ({"objects": two}, {"use_scene_rels": False}),
           ({"objects": two, "triples": [[0, preds[0], 5]]}, {}),
           ({"objects": two}, {"manipulation": {"type": "move"}}),
           ({"objects": two, "triples": [[0, preds[0], 1]]},
            {"manipulation": {"type": "relationship", "index": 3,
                              "predicate": preds[0]}}),
           ({"objects": two, "triples": [[0, preds[0], 1]]},
            {"manipulation": {"type": "relationship", "index": 0,
                              "predicate": "nope"}}),
           ({"objects": two}, {"manipulation": {"type": "addition",
                                                "object": "nope"}})]
    for req, kw in bad:
        errors = []
        for fn, clip in ((jr2e, JClip("hash")), (pr2e, PClip("hash"))):
            with pytest.raises(Exception) as e:
                fn(req, vocab.classes, vocab.rel_dict, clip, **kw)
            errors.append(e.type)
        assert errors[0] == errors[1], (req, kw, errors)
        assert errors[0] in (KeyError, ValueError, IndexError)


class _JaxDraws:
    """The draws JAX's service hands its sampler: its key split once per
    dispatch, then sample_fn's own splits (fast layout sampler)."""

    def __init__(self, seed, cfg):
        self.key = jax.random.PRNGKey(seed)
        self.cfg = cfg
        self.calls = 0

    def __call__(self, n):
        self.key, sk = jax.random.split(self.key)
        self.calls += 1
        return _jax_fast_noise(sk, n, self.cfg)


def test_generate_matches_jax(vocab):
    """Two requests in one dispatch: ids, descaled sizes / translations,
    angles and SDFs within 1e-4 of JAX's service."""
    from echoscene_tpu.data.clip_text import ClipTextEncoder as JClip
    from echoscene_tpu.data.collate import CollateSpec as JSpec
    from echoscene_tpu.data.collate import collate_scenes as jcollate
    from echoscene_tpu.models.sgdiff import SGDiff as JSGDiff
    from echoscene_tpu.serve.service import GenerationService as JService
    from echoscene_tpu.serve.service import request_to_example as jr2e
    from echoscene_torch.convert import from_jax
    from echoscene_torch.data.clip_text import ClipTextEncoder as PClip
    from echoscene_torch.data.collate import CollateSpec as PSpec
    from echoscene_torch.models.sgdiff import SGDiff as PSGDiff
    from echoscene_torch.serve.service import GenerationService as PService

    cfg = _jax_config(2)
    cfg.layout_diffusion.sampler = "dpmpp"
    cfg.layout_diffusion.sample_steps = 6
    cfg.shape_branch.sampler = "dpmpp"
    cfg.shape_branch.ddim_steps = 3
    reqs = [_request(vocab, 0, k=3), _request(vocab, 1, k=4)]
    jsg = JSGDiff(cfg, num_objs=len(vocab.classes), num_preds=vocab.num_preds)
    batch = jcollate([jr2e(reqs[0], vocab.classes, vocab.rel_dict,
                           JClip("hash"))], _spec(JSpec, cfg))
    params, stats = _params_and_stats(
        jsg.module, batch, jnp.zeros((batch.num_nodes, cfg.embedding_dim)))
    jsvc = JService(jsg, types.SimpleNamespace(params=params,
                                               batch_stats=stats),
                    _spec(JSpec, cfg), vocab.stats, vocab.classes,
                    vocab.rel_dict, clip=JClip("hash"), gen_shape=True,
                    seed=0, result_format="arrays")
    want = jsvc.generate(reqs)

    psg = PSGDiff(_port_config(cfg), len(vocab.classes), vocab.num_preds,
                  device="cpu")
    psg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(
            from_jax.convert_echoscene_checkpoint(params, stats, cfg))),
        strict=True)
    draws = _JaxDraws(0, cfg)
    sample_fn = psg.sample_fn
    psg.sample_fn = lambda batch, generator=None, **kw: sample_fn(
        batch, generator, noise=draws(batch.num_nodes), **kw)
    psvc = PService(psg, _spec(PSpec, cfg), vocab.stats, vocab.classes,
                    vocab.rel_dict, clip=PClip("hash"), gen_shape=True,
                    seed=0, result_format="arrays")
    got = psvc.generate(reqs)
    assert draws.calls == 1
    assert psvc.compiled_variants() == jsvc.compiled_variants()
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and g["sdf_shape"] == w["sdf_shape"]
        for key in ("sizes", "translations", "angles", "sdfs"):
            np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]),
                                       atol=ATOL, err_msg=key)
    assert np.abs(np.asarray(want[1]["sdfs"])).max() > 1e-2


def test_splice_keeps_untouched_objects(port_service, vocab):
    """generate -> an addition and a relationship change against earlier
    results: untouched objects keep the previous response's boxes and SDFs
    bit for bit, changed ones are sampled anew; the splice and the stored
    request equal JAX's static helpers on the same inputs."""
    from echoscene_tpu.serve.service import GenerationService as JService

    svc = port_service
    manips = _manipulations(vocab)
    base = svc.generate([_request(vocab, 20, k=4)])[0]
    n_base = len(base["sizes"])
    add = svc.generate([{"previous": base["id"], "id": "q21",
                         "manipulation": manips["addition"]}])[0]
    rel = svc.generate([{"previous": "q21", "id": "q22",
                         "manipulation": manips["relationship"]}])[0]
    assert add["manipulation"] == "addition"
    assert add["keep"] == [1.0] * n_base + [0.0]
    assert len(add["sizes"]) == len(add["sdfs"]) == n_base + 1
    s, _, o = _request(vocab, 20, k=4)["triples"][1]
    assert [j for j, k in enumerate(rel["keep"]) if k == 0.0] == [s, o]
    for out, prev in ((add, base), (rel, add)):
        for j, k in enumerate(out["keep"]):
            for field in ("sizes", "translations", "angles", "sdfs"):
                if k == 1.0:
                    assert out[field][j] == prev[field][j], (field, j)
    assert rel["sizes"][s] != add["sizes"][s]
    assert np.isfinite(np.asarray(add["sdfs"][n_base])).all()

    res = {f: [[float(j)] * 2 for j in range(4)]
           for f in ("sizes", "translations", "sdfs")}
    res["angles"] = [0.5, 1.5, 2.5, 3.5]
    prev = {f: [[-1.0] * 2] * 3 for f in ("sizes", "translations", "sdfs")}
    prev["angles"] = [-1.0] * 3
    keep = [1.0, 0.0, 1.0, 1.0]
    spliced = []
    for cls in (JService, type(svc)):
        r = json.loads(json.dumps(res))
        cls._splice_previous(r, prev, keep)
        spliced.append(r)
    assert spliced[0] == spliced[1]
    req = _request(vocab, 1, k=4)
    for m in manips.values():
        assert (type(svc).effective_request(req, m)
                == JService.effective_request(req, m))


def test_generate_validates_all_before_running(port_service, vocab):
    """One oversize request fails the whole call before any generation, and
    an unknown previous id raises."""
    svc = port_service
    before = svc.compiled_variants()
    big = {"objects": _names(vocab) * 4, "triples": [], "id": "big"}
    with pytest.raises(ValueError):
        svc.generate([_request(vocab, 0), big])
    with pytest.raises(KeyError):
        svc.generate([{"previous": "nope", "manipulation": {
            "type": "relationship", "index": 0, "predicate": "left"}}])
    assert svc.compiled_variants() == before


def test_result_formats_and_meshes(port_service, vocab):
    """arrays mode returns numpy payloads; meshes are welded, indexed and
    fitted to their boxes; json mode returns lists."""
    from echoscene_torch.serve.service import GenerationService

    svc = port_service
    mesh_svc = GenerationService(svc.sg, svc.spec, svc.stats, svc.classes,
                                 svc.rel_dict, clip=svc.clip, gen_shape=True,
                                 return_meshes=True, result_format="arrays")
    (r,) = mesh_svc.generate([_request(vocab, 30)])
    assert len(r["meshes"]) == 3
    for m in r["meshes"]:
        assert m["vertices"].dtype == np.float32
        assert m["faces"].dtype == np.int32
        if len(m["faces"]):
            assert m["faces"].max() < len(m["vertices"])
            assert len(m["vertices"]) < 3 * len(m["faces"])
    (j,) = svc.generate([_request(vocab, 31)])
    assert isinstance(j["sdfs"], list) and j["sdf_shape"] == [3, 16, 16, 16]
    with pytest.raises(ValueError):
        GenerationService(svc.sg, svc.spec, svc.stats, svc.classes,
                          svc.rel_dict, result_format="msgpack")
    # dp over cuda:0 .. N-1 raises where fewer cards are visible (here:
    # none)
    with pytest.raises(ValueError, match="CUDA devices visible"):
        GenerationService(svc.sg, svc.spec, svc.stats, svc.classes,
                          svc.rel_dict, dp_devices=2)


def test_microbatcher_coalesces_and_isolates(port_service, vocab):
    """Concurrent submits share dispatches; a malformed request fails alone
    (individual retry), not its neighbours; a closed batcher refuses."""
    from echoscene_torch.serve.batcher import MicroBatcher

    mb = MicroBatcher(port_service, max_wait_ms=250.0)
    try:
        futs = [mb.submit(_request(vocab, 100 + i)) for i in range(4)]
        results = [f.result(timeout=600) for f in futs]
        assert [r["id"] for r in results] == [f"q{100 + i}" for i in range(4)]
        st = mb.stats()
        assert st["requests"] == 4 and st["batches"] < 4
        assert st["mean_batch_size"] > 1.0
        good1 = mb.submit(_request(vocab, 200))
        bad = mb.submit({"objects": ["not-a-class"], "id": "qbad"})
        good2 = mb.submit(_request(vocab, 201))
        assert good1.result(timeout=600)["id"] == "q200"
        assert good2.result(timeout=600)["id"] == "q201"
        with pytest.raises(KeyError):
            bad.result(timeout=600)
        assert mb.stats()["isolated_failures"] >= 1
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(_request(vocab, 300))


def test_microbatcher_close_strands_no_futures():
    """close() fails queued futures instead of leaving clients hanging."""
    from echoscene_torch.serve.batcher import MicroBatcher

    class SlowService:
        spec = types.SimpleNamespace(max_scenes=4)

        def generate(self, reqs):
            time.sleep(0.3)
            return [{"id": r.get("id")} for r in reqs]

    mb = MicroBatcher(SlowService(), max_wait_ms=5.0)
    f1 = mb.submit({"id": "a"})
    time.sleep(0.05)                     # the worker is inside generate()
    f2 = mb.submit({"id": "b"})
    mb.close(timeout=5.0)
    assert f1.result(timeout=5.0)["id"] == "a"
    if f2.done() and f2.exception() is None:
        assert f2.result()["id"] == "b"
    else:
        with pytest.raises(RuntimeError):
            f2.result(timeout=1.0)
    with pytest.raises(RuntimeError):
        mb.submit({"id": "c"})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_http_round_trip(port_service, vocab):
    """POST /generate returns the results; a malformed request gets a 400
    with an error message."""
    from echoscene_torch.serve.cli import run_http

    port = _free_port()
    threading.Thread(target=run_http,
                     args=(port_service, "127.0.0.1", port, 10.0),
                     daemon=True).start()
    url = f"http://127.0.0.1:{port}/generate"
    payload = json.dumps([_request(vocab, 7)]).encode()
    for _ in range(50):
        try:
            resp = urllib.request.urlopen(urllib.request.Request(
                url, data=payload,
                headers={"Content-Type": "application/json"}), timeout=120)
            break
        except urllib.error.URLError:
            time.sleep(0.1)
    body = json.loads(resp.read())
    assert [r["id"] for r in body["results"]] == ["q7"]
    assert len(body["results"][0]["sdfs"]) == 3
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps([{"objects": ["nope"]}]).encode()),
            timeout=60)
    assert e.value.code == 400
    assert "KeyError" in json.loads(e.value.read())["error"]


def test_warmup_then_mixed_sizes_add_no_variant(port_service, vocab):
    """warmup runs the (rows, manip) ladder; requests of 1-4 objects and a
    manipulation afterwards run no new variant, and row buckets pin rows."""
    from echoscene_torch.data.collate import collate_scenes
    from echoscene_torch.serve.service import (GenerationService,
                                               request_to_example)

    svc = port_service
    warm = GenerationService(svc.sg, svc.spec, svc.stats, svc.classes,
                             svc.rel_dict, clip=svc.clip, gen_shape=True,
                             row_buckets=(4, 8))
    assert warm.row_buckets == (4, 8, svc.spec.max_nodes)
    assert warm.warmup(verbose=False) == 6
    before = warm.compiled_variants()
    assert before == sorted((r, m) for m in (False, True) for r in (4, 8, 24))
    names, preds = _names(vocab), list(vocab.rel_dict)
    reqs = [{"objects": names[:k], "id": f"m{k}",
             "triples": [[0, preds[0], k - 1]] if k > 1 else []}
            for k in (1, 2, 3, 4)]
    out = warm.generate(reqs)
    out += warm.generate([{"previous": "m2", "id": "m5", "manipulation": {
        "type": "addition", "object": names[0],
        "triples": [[-1, preds[0], 0]]}}])
    assert len(out) == 5 and all(r is not None for r in out)
    assert warm.compiled_variants() == before
    for k in (1, 3, 7):
        ex = request_to_example({"objects": names[:1] * k}, warm.classes,
                                warm.rel_dict, warm.clip)
        assert warm._rows(collate_scenes([ex], warm.spec)) == (
            4 if k + 1 <= 4 else 8)


def test_meshes_match_jax():
    """`sdf_to_canonical_mesh`, `fit_verts_to_box` and `assemble_scene`
    equal JAX's (numpy and the same native library)."""
    from echoscene_tpu.eval import render as jr
    from echoscene_torch.eval import render as pr

    c = np.linspace(-1, 1, 20, dtype=np.float32)
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)
    sdf = (np.linalg.norm(p / [0.6, 0.4, 0.5], axis=-1) - 1.0) * 0.4
    want, got = jr.sdf_to_canonical_mesh(sdf), pr.sdf_to_canonical_mesh(sdf)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    box7 = [1.2, 0.8, 0.6, 0.3, 0.0, -0.7, 0.9]
    np.testing.assert_array_equal(pr.fit_verts_to_box(got[0], box7),
                                  jr.fit_verts_to_box(want[0], box7))
    boxes7 = np.asarray([box7, [0.5, 0.5, 0.5, -1.0, 0.0, 1.0, -0.3]],
                        np.float32)
    sdfs = np.stack([sdf, np.zeros_like(sdf)])
    names = ["_scene_", "bed", "chair"]
    for g, w in zip(pr.assemble_scene([1, 2], boxes7, names, sdfs,
                                      highlight=[True, False]),
                    jr.assemble_scene([1, 2], boxes7, names, sdfs,
                                      highlight=[True, False])):
        np.testing.assert_array_equal(g, w)


def test_service_from_experiment_and_cli(tmp_path):
    """The batch-mode CLI on the CPU rebuilds the model from args.json,
    serves fresh seed-0 weights with --epoch -1 and writes the results;
    with no checkpoint and no --epoch it refuses to serve."""
    from test_torch_port_eval import TINY_DF, TINY_VQ, TINY_YAML
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.serve import cli
    from echoscene_torch.serve.service import service_from_experiment

    data = make_fake_dataset(str(tmp_path / "data"), num_scenes=2,
                             min_objs=3, max_objs=4, with_sdf=False, seed=2)
    exp = tmp_path / "exp"
    exp.mkdir()
    for name, text in (("tiny.yaml", TINY_YAML), ("df.yaml", TINY_DF),
                       ("vq.yaml", TINY_VQ)):
        (exp / name).write_text(text)
    (exp / "args.json").write_text(json.dumps({
        "dataset": data, "room_type": "bedroom", "use_scene_rels": True,
        "large": False, "diff_yaml": str(exp / "tiny.yaml"),
        "network_type": "echoscene", "with_CLIP": True,
        "replace_latent": True, "residual": False, "clip_backend": "hash"}))
    with pytest.raises(FileNotFoundError):
        service_from_experiment(str(exp), device="cpu")
    svc = service_from_experiment(str(exp), epoch=-1, device="cpu",
                                  max_nodes=24, max_triples=64)
    names = [n for n in svc.classes if n != "_scene_"]
    reqs = tmp_path / "reqs.json"
    reqs.write_text(json.dumps([{"objects": names[:3], "id": "a",
                                 "triples": [[0, list(svc.rel_dict)[0], 1]]}]))
    out = tmp_path / "out.json"
    results = cli.main([
        "--exp", str(exp), "--epoch", "-1", "--gen_shape",
        "--requests", str(reqs), "--out", str(out), "--device", "cpu",
        "--sample_dtype", "float32", "--layout_sampler", "dpmpp",
        "--layout_steps", "4", "--shape_sampler", "dpmpp", "--shape_steps",
        "2", "--max_nodes", "24", "--max_triples", "64"])
    saved = json.loads(out.read_text())["results"]
    assert [r["id"] for r in saved] == [r["id"] for r in results] == ["a"]
    assert np.isfinite(np.asarray(saved[0]["sizes"])).all()
    assert saved[0]["sdf_shape"] == [3, 16, 16, 16]
