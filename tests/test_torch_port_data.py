"""The port's data layer (echoscene_torch/data) against the JAX package's.

One fake SG-FRONT fixture (written by both `make_fake_dataset`s, which must
agree file for file), read by both `SGFrontDataset`s and collated by both
`collate_scenes`: every field of every example and every array of every
collated batch must be equal (the port's index arrays are int64 where JAX's
are int32; values are compared).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from echoscene_torch.data import clip_text as p_clip
from echoscene_torch.data import collate as p_collate
from echoscene_torch.data import fake as p_fake
from echoscene_torch.data import sgfront as p_sg

torch.set_num_threads(1)
SDF_RES = 8


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from echoscene_tpu.data.fake import make_fake_dataset

    base = tmp_path_factory.mktemp("port_data")
    jroot = make_fake_dataset(str(base / "jax"), num_scenes=6, min_objs=3,
                              max_objs=6, sdf_res=SDF_RES, with_sdf=True,
                              seed=1)
    proot = p_fake.make_fake_dataset(str(base / "port"), num_scenes=6,
                                     min_objs=3, max_objs=6, sdf_res=SDF_RES,
                                     with_sdf=True, seed=1)
    return jroot, proot


def _walk(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def test_fake_dataset_matches_jax(roots):
    import h5py

    jroot, proot = roots
    jf, pf = _walk(jroot), _walk(proot)
    assert jf.keys() == pf.keys()
    for rel in jf:
        if rel.endswith(".h5"):
            with h5py.File(jf[rel]) as a, h5py.File(pf[rel]) as b:
                np.testing.assert_array_equal(a["pc_sdf_sample"][:],
                                              b["pc_sdf_sample"][:])
            continue
        with open(jf[rel]) as a, open(pf[rel]) as b:
            ta, tb = a.read(), b.read()
        if rel.endswith(".json"):
            assert json.loads(ta.replace(jroot, "ROOT")) == json.loads(
                tb.replace(proot, "ROOT")), rel
        else:
            assert ta == tb, rel


READERS = {
    "train": dict(split="train_scans", use_sdf=True, with_changes=True,
                  seed=3),
    "eval_relationship": dict(split="test", shuffle_objs=False,
                              with_changes=True, eval_mode=True,
                              eval_type="relationship", seed=47),
    "eval_addition": dict(split="test", shuffle_objs=False,
                          with_changes=True, eval_mode=True,
                          eval_type="addition", seed=47),
    "eval_none": dict(split="test", shuffle_objs=False, with_changes=False,
                      seed=47, use_sdf=True),
}


def _pair(roots, kw):
    from echoscene_tpu.data.clip_text import ClipTextEncoder
    from echoscene_tpu.data.sgfront import SGFrontDataset

    jroot, _ = roots
    kw = dict(kw, sdf_res=SDF_RES)
    return (SGFrontDataset(jroot, clip=ClipTextEncoder("hash"), **kw),
            p_sg.SGFrontDataset(jroot, clip=p_clip.ClipTextEncoder("hash"),
                                **kw))


@pytest.mark.parametrize("mode", sorted(READERS))
def test_dataset_examples_match_jax(roots, mode):
    jds, pds = _pair(roots, READERS[mode])
    assert len(jds) == len(pds)
    assert pds.vocab == jds.vocab and pds.classes == jds.classes
    assert pds.pred_names == jds.pred_names
    np.testing.assert_array_equal(pds.box_stats, jds.box_stats)
    kinds = set()
    for i in range(2 * len(jds)):       # twice: the random streams advance
        je, pe = jds[i], pds[i]
        assert (je is None) == (pe is None)
        if je is None:
            continue
        kinds.add(pe.manipulation_type)
        for f in ("scan_id", "manipulation_type", "sdf_paths",
                  "instance_ids"):
            assert getattr(pe, f) == getattr(je, f), f
        for f in ("objs", "objs_grained", "triples", "boxes", "text_feats",
                  "rel_feats", "enc_triples", "enc_rel_feats",
                  "enc_node_mask", "enc_triple_mask", "change_flags"):
            a, b = getattr(pe, f), getattr(je, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    if mode == "train":
        assert kinds == {"none", "relationship", "addition"}


def _assert_batch_equal(pb, jb):
    for view in ("enc", "dec"):
        for f in ("objs", "triples", "obj_mask", "triple_mask", "text_feats",
                  "rel_feats"):
            np.testing.assert_array_equal(
                getattr(getattr(pb, view), f).numpy(),
                np.asarray(getattr(getattr(jb, view), f)),
                err_msg=f"{view}.{f}")
    for f in ("objs_grained", "obj_to_scene", "triple_to_scene", "boxes",
              "change_flags", "enc_obj_mask"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert pb.num_scenes == jb.num_scenes
    assert (pb.shapes is None) == (jb.shapes is None)
    if jb.shapes is not None:
        js, ps = jb.shapes, pb.shapes
        assert int(ps.num_valid) == int(js.num_valid)
        assert ps.mp_valid == js.mp_valid
        np.testing.assert_array_equal(ps.sdf.numpy(), np.asarray(js.sdf))
        assert (ps.indices is None) == (js.indices is None)
        if js.indices is not None:
            np.testing.assert_array_equal(ps.indices.numpy(),
                                          np.asarray(js.indices))


@pytest.mark.parametrize("sampling", [None, "greedy", "random", "balance"])
def test_collate_matches_jax(roots, sampling):
    """This is ROADMAP item 10's test: the port's collate gives the JAX
    collate's arrays on the same examples (no SDFs, or SDF grids read by
    each reader's `load_sdf` with each shape-row selection)."""
    from echoscene_tpu.data.collate import CollateSpec, collate_scenes

    jds, pds = _pair(roots, READERS["train"])
    kw = dict(max_nodes=24, max_triples=64, max_scenes=3, diffusion_bs=9,
              sdf_res=SDF_RES, with_sdf=sampling is not None,
              shape_sampling=sampling or "greedy")
    jspec, pspec = CollateSpec(**kw), p_collate.CollateSpec(**kw)
    for start in (0, 3):
        jex = [jds[i] for i in range(start, start + 4)]
        pex = [pds[i] for i in range(start, start + 4)]
        jb = collate_scenes(jex, jspec, sdf_loader=jds.load_sdf,
                            rng=np.random.default_rng(5))
        pb = p_collate.collate_scenes(pex, pspec, sdf_loader=pds.load_sdf,
                                      rng=np.random.default_rng(5))
        _assert_batch_equal(pb, jb)
        if sampling is not None:
            assert float(pb.shapes.sdf.abs().sum()) > 0
    one = p_collate.single_scene_batch(pex[0], pspec, pds.load_sdf)
    assert int(one.dec.obj_mask.sum()) == pex[0].num_nodes


def test_collate_drops_scenes_over_capacity(roots):
    _, pds = _pair(roots, READERS["eval_none"])
    ex = pds[0]
    tight = p_collate.CollateSpec(max_nodes=ex.num_nodes - 1)
    assert p_collate.collate_scenes([ex], tight) is None


def test_clip_hash_matches_jax():
    from echoscene_tpu.data.clip_text import ClipTextEncoder

    texts = ["bed left table", "room", "chair in room"]
    np.testing.assert_array_equal(
        p_clip.ClipTextEncoder("hash").encode_many(texts),
        ClipTextEncoder("hash").encode_many(texts))
    with pytest.raises(ValueError):
        p_clip.ClipTextEncoder("nonsense")


def test_load_sdf_without_h5py_raises_clearly(roots, monkeypatch):
    """The card machine has no h5py: reading a grid there must say so."""
    _, pds = _pair(roots, READERS["eval_none"])
    path = next(p for e in (pds[i] for i in range(len(pds)))
                for p in e.sdf_paths if p and os.path.exists(p))
    missing = p_sg.SGFrontDataset(roots[0], split="test", use_sdf=True,
                                  clip=p_clip.ClipTextEncoder("hash"),
                                  sdf_res=SDF_RES)
    assert missing.load_sdf(path + ".absent").shape == (SDF_RES,) * 3 + (1,)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        missing.load_sdf(path)
