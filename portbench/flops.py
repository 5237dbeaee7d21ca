"""Logical operations of one generation call, counted by
`torch.utils.flop_counter.FlopCounterMode` over the reference on the meta
device (products only: 2 per multiply-add), split by the arithmetic the
configuration states: the W8A8 torso convolutions (`bounds`' count) run in
int8, everything else in bf16."""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import bounds, model_config
from .reference.model import EchoScene, Numerics


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@torch.no_grad()
def generation_ops(cfg: Dict, nodes: int, triples: int, rows: int,
                   steps: Dict[str, int], chunk: int) -> Dict[str, float]:
    """{"bf16": ops, "int8": ops} of one call: the context once, each
    chain's denoiser `steps` times, `steps["chunks"]` decode chunks."""
    int8 = cfg["sample_dtype"] == "int8"
    m = model_config.reference_model(cfg)
    with torch.device("meta"):
        model = EchoScene(m, Numerics("f32", int8)).eval()
        model.set_factored(True)
        g = m["graph"]
        clip = g["clip_dim"]
        graph = {"objs": torch.zeros(nodes, dtype=torch.long),
                 "triples": torch.zeros(triples, 3, dtype=torch.long),
                 "obj_mask": torch.ones(nodes),
                 "triple_mask": torch.ones(triples),
                 "text_feats": torch.zeros(nodes, clip),
                 "rel_feats": torch.zeros(triples, clip),
                 "enc_obj_mask": torch.ones(nodes),
                 "change_flags": torch.zeros(nodes)}
        ctx_ops = _count(lambda: model.encode_context(
            graph, torch.zeros(nodes, g["embedding_dim"])))
        ctx = model.encode_context(graph, torch.zeros(nodes,
                                                      g["embedding_dim"]))
        masks = (graph["triples"], graph["obj_mask"][:rows],
                 graph["triple_mask"])
        t = torch.zeros(rows, dtype=torch.long)
        ld = m["layout_denoiser"]
        layout = _count(lambda: model.layout_eps(
            torch.zeros(rows, ld["in_channels"]), t, ctx["obj_embed"][:rows],
            *masks))
        sd = m["shape_denoiser"]
        r = sd["image_size"]
        z = torch.zeros(rows, r, r, r, sd["in_channels"])
        shape = _count(lambda: model.shape_eps(
            z, t, ctx["uc_s"][:rows, None, :], *masks))
        decode = _count(lambda: model.decode_latent(z[:chunk]))
    total = (ctx_ops + steps["layout"] * layout + steps["shape"] * shape
             + steps["chunks"] * decode)
    q = (bounds.torso_step_bound_ms(sd, rows)["int8_ops"] * steps["shape"]
         if int8 else 0.0)
    return {"bf16": total - q, "int8": q}


def peak_seconds(ops: Dict[str, float]) -> float:
    """The least time the chip's peaks allow for `ops`."""
    return ops["bf16"] / bounds.PEAK_BF16_FLOPS + \
        ops["int8"] / bounds.PEAK_INT8_OPS


def train_ops(cfg: Dict, mix: Dict) -> Dict[str, float]:
    """{"bf16": ops, "int8": 0} of one train step: the reference's loss
    forward and its backward on the meta device, nothing recomputed."""
    from . import scenes
    from .reference import train as T
    m = model_config.reference_model(cfg)
    nodes, triples = scenes.capacities(mix)
    rows = mix["shape_rows"]
    res = mix["sdf_resolution"]
    sd = m["shape_denoiser"]
    r = sd["image_size"]
    g = m["graph"]
    with torch.device("meta"):
        model = EchoScene(m).train()
        model.vqvae.eval()
        tables = T.Tables(cfg, "meta")
        graph = {"objs": torch.zeros(nodes, dtype=torch.long),
                 "triples": torch.zeros(triples, 3, dtype=torch.long),
                 "obj_mask": torch.ones(nodes),
                 "triple_mask": torch.ones(triples),
                 "text_feats": torch.zeros(nodes, g["clip_dim"]),
                 "rel_feats": torch.zeros(triples, g["clip_dim"]),
                 "enc_obj_mask": torch.ones(nodes),
                 "change_flags": torch.zeros(nodes),
                 "obj_to_scene": torch.zeros(nodes, dtype=torch.long),
                 "boxes": torch.zeros(nodes, 7)}
        draws = {"change": torch.zeros(nodes, g["embedding_dim"]),
                 "t_scene": torch.zeros(mix["scenes"] + 1, dtype=torch.long),
                 "noise_box": torch.zeros(nodes, 8),
                 "t_shape": torch.zeros(rows, dtype=torch.long),
                 "noise_shape": torch.zeros(rows, r, r, r,
                                            sd["in_channels"])}
        sdf = torch.zeros(rows, res, res, res, 1)

        def step():
            total = T.loss(model, tables, graph, sdf, rows, draws)
            torch.autograd.grad(total, [p for _, p in T.trainable(model)],
                                allow_unused=True)
        ops = _count(step)
    return {"bf16": float(ops), "int8": 0.0}


def vqvae_train_ops(cfg: Dict, mix: Dict) -> Dict[str, float]:
    """{"bf16": ops, "int8": 0} of one VQ-VAE train step at the mix's batch:
    the reference's loss forward and its backward on the meta device,
    nothing recomputed.  The products are float32; they are taken against
    the bf16 peak, which no float32 arithmetic passes."""
    from .reference import vqvae as V
    res = mix["sdf_resolution"]
    with torch.device("meta"):
        model = V.VQVAE(V.model_dict(cfg))
        x = torch.zeros(mix["batch"], res, res, res, 1)

        def step():
            total = V.loss(model, x, cfg["codebook_weight"])
            torch.autograd.grad(total, list(model.parameters()))
        ops = _count(step)
    return {"bf16": float(ops), "int8": 0.0}
