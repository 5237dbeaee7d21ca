"""Evaluation CLI, the eval_3dfront.py analogue.

Port of echoscene_tpu/eval/cli.py (reference scripts/eval_3dfront.py:
234-412), with the same flags plus `--device` (default `cuda`):

    python -m echoscene_torch.eval.cli --exp EXP --dataset DATA \
        --gen_shape --dump_sdfs --store_path OUT [--device cpu]

Rebuilds the model from the experiment's args.json, iterates the test split
group by group, generates layouts (and shapes), descales to world units and
scores the scene-graph constraint accuracy; writes
`<eval_type>_accuracy_analysis.txt` in the reference line format (:307-328).
Manipulated eval (relationship / addition) keeps GT boxes for untouched nodes
(:191-202) and scores changed and unchanged triples separately.

`--epoch -1` (the default) samples from fresh weights drawn from seed 0, as
JAX initialises from PRNGKey(0); `--epoch E` restores the parameters and
batch-norm statistics of <exp>/checkpoint/model<E> (`restore_for_inference`,
the training CLI's checkpoints).  The layout and shape samplers of JAX's
CLI all run (`--layout_sampler ddpm|ddim|dpmpp`, `--shape_sampler
ddim|dpmpp`).  `--render_dir R` writes each scene's 256^2 top-down render
(`R/<scan_id>.png`, the FID generated set) in one of the four render types
(`--render_type echoscene|onlybox|retrieval|txt2shape`; retrieval reads
`--mesh_db` cat_jid_trainval.json and the 3D-FUTURE meshes beside it or in
`--model_dir`, txt2shape reads `--txt2shape_dir <dir>/<label>/*.ply`),
`--export_glb` a .glb beside each, and manipulated eval an overlay
`<scan_id>_mani.png`.  `--dp_devices N` generates N groups at a time on
`cuda:0 .. cuda:N-1` (parallel/dp.py `DPSampler`, one thread and stream a
card) and raises when fewer cards are visible.  `--sample_dtype int8`
samples with int8 W8A8 shape-UNet convolutions (nn/quant.py; with
`--layout_sampler dpmpp --layout_steps 50 --shape_sampler dpmpp
--shape_steps 20` it is bench.py's fast profile).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from .evaluator import SceneEvaluator
from .retrieval import MeshResultsDir, SizeDatabase


def evaluate(args):
    from ..data.clip_text import ClipTextEncoder
    from ..data.collate import CollateSpec
    from ..data.sgfront import SGFrontDataset
    from ..models.config import load_config
    from ..models.sgdiff import SGDiff

    with open(os.path.join(args.exp, "args.json")) as f:
        margs = json.load(f)
    clip = ClipTextEncoder(margs.get("clip_backend", "hash"))
    # eval-time room filter override (eval_3dfront.py:35)
    room_type = args.room_type or margs["room_type"]

    def make_ds(etype):
        return SGFrontDataset(
            root=args.dataset or margs["dataset"], split="test",
            room_type=room_type, shuffle_objs=False,
            use_sdf=margs["with_SDF"], use_scene_rels=margs["use_scene_rels"],
            with_changes=etype != "none", eval_mode=etype != "none",
            eval_type=etype, large=margs["large"], clip=clip, seed=47,
            sdf_res=margs.get("sdf_res", 64),
            bin_angle=margs.get("bin_angle", False))

    cfg = load_config(margs["diff_yaml"], network_type=margs["network_type"],
                      with_clip=margs["with_CLIP"])
    cfg.replace_latent = margs["replace_latent"]
    cfg.residual = margs["residual"]
    # sampler overrides (protocol default: full DDPM + DDIM-100)
    if args.layout_sampler:
        cfg.layout_diffusion.sampler = args.layout_sampler
    if args.layout_steps:
        cfg.layout_diffusion.sample_steps = args.layout_steps
    if args.shape_sampler:
        cfg.shape_branch.sampler = args.shape_sampler
    if args.shape_steps:
        cfg.shape_branch.ddim_steps = args.shape_steps
    if args.sample_dtype:
        cfg.sample_dtype = args.sample_dtype
    ds0 = make_ds("none")
    cfg.layout_diffusion.train_stats_file = ds0.box_stats_path

    # padded capacities for an eval_batch-scene generation call
    spec = CollateSpec(max_nodes=args.max_nodes, max_triples=args.max_triples,
                       max_scenes=args.eval_batch, diffusion_bs=args.max_nodes,
                       with_sdf=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sg = SGDiff(cfg, num_objs=len(ds0.classes),
                    num_preds=len(ds0.pred_names), device=args.device)
    if args.epoch >= 0:
        from ..train.checkpoint import restore_for_inference
        restore_for_inference(os.path.join(
            args.exp, "checkpoint", f"model{args.epoch}"), sg.module)

    mesh_db = txt2shape_db = None
    if args.render_type == "retrieval":
        if not args.mesh_db:
            raise ValueError("--render_type retrieval requires --mesh_db "
                             "(cat_jid_trainval[_small].json)")
        mesh_db = SizeDatabase(args.mesh_db, model_dir=args.model_dir)
    elif args.render_type == "txt2shape":
        if not args.txt2shape_dir:
            raise ValueError("--render_type txt2shape requires "
                             "--txt2shape_dir (per-category results: "
                             "<dir>/<label>/*.ply)")
        txt2shape_db = MeshResultsDir(args.txt2shape_dir)

    bin_angle = margs.get("bin_angle", False)
    evaluator = SceneEvaluator(
        sg, spec, ds0.box_stats_msd if bin_angle else ds0.box_stats,
        gen_shape=args.gen_shape, store_path=args.store_path,
        render_dir=args.render_dir, dump_sdfs=args.dump_sdfs,
        eval_batch=args.eval_batch, dp_devices=args.dp_devices,
        render_type=args.render_type, mesh_db=mesh_db,
        txt2shape_db=txt2shape_db, bin_angle=bin_angle,
        export_3d=args.export_3d, export_glb=args.export_glb)

    generator = torch.Generator(device=sg.device).manual_seed(47)
    results = {}
    for etype in args.eval_types.split(","):
        etype = etype.strip()
        acc, _unchanged, generator = evaluator.run(make_ds(etype), etype,
                                                   args.limit, generator)
        results[etype] = acc
    return results


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--exp", required=True)
    p.add_argument("--dataset", default=None)
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--eval_types", default="none",
                   help="comma list: none,relationship,addition")
    p.add_argument("--gen_shape", action="store_true")
    p.add_argument("--store_path", default="./eval_out")
    p.add_argument("--max_nodes", type=int, default=48)
    p.add_argument("--max_triples", type=int, default=160)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--eval_batch", type=int, default=1,
                   help="scenes per generation call (size max_nodes to fit)")
    p.add_argument("--dump_sdfs", action="store_true",
                   help="save generated SDF grids per scene "
                        "(consistency CLI input)")
    p.add_argument("--render_dir", default=None,
                   help="save top-down renders (FID generated set)")
    p.add_argument("--render_type", default="echoscene",
                   choices=["echoscene", "retrieval", "onlybox", "txt2shape"],
                   help="echoscene = generated SDF meshes; retrieval = "
                        "3D-FUTURE meshes by predicted size (helpers/util.py:"
                        "86-138); onlybox = solid box layout render; "
                        "txt2shape = pre-generated per-category result "
                        "meshes fitted to predicted boxes (helpers/util.py:"
                        "334-374)")
    p.add_argument("--mesh_db", default=None,
                   help="cat_jid_trainval[_small].json for --render_type "
                        "retrieval")
    p.add_argument("--model_dir", default=None,
                   help="3D-FUTURE-model directory (default: next to "
                        "--mesh_db)")
    p.add_argument("--txt2shape_dir", default=None,
                   help="results root for --render_type txt2shape "
                        "(<dir>/<label>/*.ply)")
    p.add_argument("--layout_sampler", default=None,
                   choices=["ddpm", "ddim", "dpmpp"],
                   help="override layout sampler (default: full DDPM chain)")
    p.add_argument("--layout_steps", type=int, default=0,
                   help="steps for the fast layout samplers")
    p.add_argument("--shape_sampler", default=None,
                   choices=["ddim", "dpmpp"],
                   help="override shape sampler (default: DDIM)")
    p.add_argument("--shape_steps", type=int, default=0,
                   help="override shape sampler step count")
    p.add_argument("--dp_devices", type=int, default=1,
                   help="generate this many groups at a time, one a card "
                        "(cuda:0 .. N-1)")
    p.add_argument("--sample_dtype", default=None,
                   choices=["float32", "bfloat16", "int8"],
                   help="override sampling precision")
    p.add_argument("--room_type", default=None,
                   help="override the training room filter at eval time "
                        "(eval_3dfront.py:35; default: args.json)")
    p.add_argument("--export_3d", action="store_true",
                   help="per-scene JSON dump of generated boxes + shape refs")
    p.add_argument("--export_glb", action="store_true",
                   help="export a .glb scene next to each render "
                        "(render_full :313 / render_box :228)")
    p.add_argument("--device", default="cuda",
                   help="device the model samples on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    return evaluate(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
