"""The correctness check: what the window's kept calls produced, against
the float32 reference run after the window on the same inputs.

Each number is a worst-row gap: over the rows (objects) of an output,
max_r |p_r - q_r| / sqrt(mean_r |q_r|^2), where p is the program's output,
q the reference's and |.| the Euclidean norm of a row.  Half a batch left
out, one object's output altered, or a step that returns its input, all
read near 1 or above; rounding reads far below.

  * `context`: `encode_context` on the harness's own graph batch, the
    largest gap of its four outputs (the node stream, the manipulator GCN's
    latent and the two rel_s_mlp conditionings);
  * `layout_step`, `shape_step`: the denoiser call of each chain at a step
    c drawn from the seed, on the program's chain state and timestep of
    that call, with the conditioning the reference works out itself;
  * `layout_update`, `shape_update`: the program's chain state at step
    c + 1 against the reference's DPM-Solver++(2M) update
    (`reference/sampler.py`, float64, its own sub-schedule) from the
    program's state and prediction at c and prediction at c - 1;
  * `layout_chain`: the first call's boxes as the host got them (sizes,
    translations, sine and cosine of the angle; the real rows) against the
    reference's whole layout chain from the program's first layout state:
    every denoiser call and update of the chain, and the outputs' way to
    the host;
  * `decode_chunk`: one VQ decode chunk, drawn from the seed, on the
    program's latents of that chunk.

The shape chain's states and the latents are the program's own: the
reference follows the program step by step there (a float32 shape chain at
the timed rows would take longer than the window).  A call the check keeps
that never came reads infinity.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from . import model_config
from .reference import sampler
from .reference.model import EchoScene, Numerics, norm_scale_names
from .weights import draw_, spec_of

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("context", "layout_step", "layout_update", "layout_chain",
           "shape_step", "shape_update", "decode_chunk")
TRAIN_NUMBERS = ("first_loss", "first_grad_median", "first_grad_norms",
                 "change")


def limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def worst_row_gap(p: Optional[torch.Tensor], q: torch.Tensor) -> float:
    if p is None or p.shape != q.shape:
        return math.inf
    p = p.double().reshape(p.shape[0], -1)
    q = q.double().reshape(q.shape[0], -1).to(p.device)
    scale = q.pow(2).sum(1).mean().sqrt().clamp_min(1e-30)
    return float((p - q).norm(dim=1).max() / scale)


def weight_spec(cfg: Dict):
    with torch.device("meta"):
        ref = EchoScene(model_config.reference_model(cfg))
    return spec_of(ref, norm_scale_names(ref))


def plain_f32() -> None:
    """The reference's precision: float32 products without TF32, set here
    whatever the program set before."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def reference(cfg: Dict, seed: int, device, mode: str = "f32") -> EchoScene:
    """The reference model on `device` with the seed's weights, in eval
    mode, with the sampling twin's factored upsamples and, where the
    configuration samples in bf16 (or int8), the VQ codebook as the
    sampling twin holds it: rounded to bf16.  The nearest-code choice is a
    discrete decision, and the reference makes it on the same codebook."""
    plain_f32()
    model = EchoScene(model_config.reference_model(cfg),
                      Numerics(mode, cfg["sample_dtype"] == "int8"))
    model = model.to(device).eval()
    draw_(dict(model.named_parameters()), weight_spec(cfg), seed, device)
    model.set_factored(True)
    if cfg["sample_dtype"] != "float32":
        book = model.vqvae.quantize.embedding.weight
        with torch.no_grad():
            book.copy_(book.to(torch.bfloat16).float())
    return model


def box_rows(vec8: torch.Tensor) -> torch.Tensor:
    """(rows, 8) layout samples as compared: sizes, translations, and the
    angle's sine and cosine (the angle as atan2 makes it)."""
    a = torch.atan2(vec8[:, 6:7], vec8[:, 7:8])
    return torch.cat([vec8[:, :6], torch.sin(a), torch.cos(a)], 1)


def host_box_rows(host: Dict, real: int) -> Optional[torch.Tensor]:
    if not all(k in host for k in ("sizes", "translations", "angles")):
        return None
    a = torch.from_numpy(np.asarray(host["angles"], np.float64))[:real]
    return torch.cat([torch.from_numpy(np.asarray(host[k], np.float64))[
        :real] for k in ("sizes", "translations")] + [torch.sin(a),
                                                        torch.cos(a)], 1)


def _call(rec, part: str, i: int) -> Optional[Dict]:
    return rec.kept[part].get(i)


@torch.no_grad()
def reference_outputs(model: EchoScene, cfg: Dict, graph: Dict, rec,
                      rows: int, device,
                      dtype: torch.dtype = torch.float64) -> Dict:
    """What `model` gives for each number on the kept calls' inputs; the
    chains' updates in `dtype` (float64 for the reference)."""
    g = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
         for k, v in graph.items()}
    change = torch.zeros(g["objs"].shape[0], cfg["graph"]["embedding_dim"],
                         device=device)
    ctx = model.encode_context(g, change)
    masks = (g["triples"], g["obj_mask"][:rows], g["triple_mask"])
    obj, cond = ctx["obj_embed"][:rows], ctx["uc_s"][:rows, None, :]
    chains = {
        "layout_eps": (sampler.Chain(
            sampler.layout_alphas_cumprod(cfg),
            cfg["layout_branch"]["diffusion_kwargs"]["sample_steps"]),
            lambda x, t: model.layout_eps(x, t, obj, *masks)),
        "shape_eps": (sampler.Chain(
            sampler.shape_alphas_cumprod(cfg),
            cfg["shape_branch"]["ddim_steps"]),
            lambda z, t: model.shape_eps(z, t, cond, *masks))}
    out: Dict = {"context": ctx}
    for part, name in (("layout_eps", "layout"), ("shape_eps", "shape")):
        chain, denoise = chains[part]
        c = rec.keep["update"][part]
        call, before = _call(rec, part, c), _call(rec, part, c - 1)
        if call is None or (c > 0 and before is None):
            out[name + "_step"] = out[name + "_update"] = None
            continue
        x, t = call["args"][:2]
        out[name + "_step"] = denoise(x.float(), t.long())
        prev = (chain.x0(c - 1, before["args"][0].to(device),
                         before["out"].to(device), dtype)
                if c > 0 else None)
        out[name + "_update"] = chain.update(c, x.to(device),
                                             call["out"].to(device), prev,
                                             dtype)
    first = _call(rec, "layout_eps", 0)
    out["layout_chain"] = None
    if first is not None:
        chain, denoise = chains["layout_eps"]
        vec = sampler.run_chain(chain, denoise, first["args"][0].to(device))
        out["layout_chain"] = box_rows(vec[:g["real_nodes"]])
    chunk = next(iter(rec.kept["decode_latent"].values()), None)
    out["decode_chunk"] = (None if chunk is None else
                           model.decode_latent(chunk["args"][0].float()))
    return out


def produced(rec, host: Dict, real: int) -> Dict:
    """What the program produced for each number."""
    def out(part, i, arg=None):
        call = _call(rec, part, i)
        if call is None:
            return None
        return call["out"] if arg is None else call["args"][arg]
    c_l, c_s = rec.keep["update"]["layout_eps"], rec.keep["update"][
        "shape_eps"]
    chunk = next(iter(rec.kept["decode_latent"].values()), None)
    return {"context": out("encode_context", 0),
            "layout_step": out("layout_eps", c_l),
            "layout_update": out("layout_eps", c_l + 1, 0),
            "layout_chain": host_box_rows(host, real),
            "shape_step": out("shape_eps", c_s),
            "shape_update": out("shape_eps", c_s + 1, 0),
            "decode_chunk": None if chunk is None else chunk["out"]}


def numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """The worst-row gaps of `got` (the program's outputs, or the
    control's) against the reference's `ref`; a missing output reads
    infinity."""
    out = {}
    for k in NUMBERS:
        if ref[k] is None:
            out[k] = math.inf
        elif k == "context":
            out[k] = (math.inf if got[k] is None else
                      max(worst_row_gap(got[k].get(n), ref[k][n])
                          for n in ("obj_embed", "latent", "uc_s", "c_s")))
        else:
            out[k] = worst_row_gap(got[k], ref[k])
    return out


# ----------------------------------------------------------------------
# training cells

ROUNDOFF_LEAF = 1e-3     # leaves whose reference gradient is below this
                         # share of the median leaf's move by round-off


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves) -> list:
    """Each leaf's |program norm - reference norm| over the larger of that
    leaf's reference norm and the median leaf's (a leaf the program never
    gave reads infinity)."""
    med = float(torch.tensor([ref[n] for n in leaves]).median())
    return [abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], med)
            for n in leaves]


def norms_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves) -> float:
    """The relative gap of the vector of leaf norms."""
    p = torch.tensor([prog.get(n, math.inf) for n in leaves],
                     dtype=torch.float64)
    q = torch.tensor([ref[n] for n in leaves], dtype=torch.float64)
    return float((p - q).norm() / q.norm())


def reference_training(run, mode: str = "f32") -> Dict:
    """The reference's checked steps on the run's feed and draws: losses,
    the first gradient's norm before the clip and the change after the last
    step, per parameter."""
    from .reference import train as T
    cfg, dev = run.cfg, run.device
    plain_f32()
    model = EchoScene(model_config.reference_model(cfg),
                      Numerics(mode, False)).to(dev)
    draw_(dict(model.named_parameters()), weight_spec(cfg), run.seed, dev)
    model.set_remat(True)
    model.train()
    model.vqvae.eval()
    named = T.trainable(model)
    p0 = [p.detach().clone() for _, p in named]
    opt = T.AdamW([p for _, p in named])
    tables = T.Tables(cfg, dev)
    losses, first = [], None
    for i in range(run.mix["checked_steps"]):
        k = i % len(run.graphs)
        g = {n: (v.to(dev) if isinstance(v, torch.Tensor) else v)
             for n, v in run.graphs[k].items()}
        total = T.loss(model, tables, g, run.sdfs[k], run.valid[k],
                       run.draws(i))
        grads = T.gradients(model, total)
        losses.append(float(total.detach()))
        if i == 0:
            first = {n: float(gr.norm()) for (n, _), gr in zip(named, grads)}
        T.clip_(model, grads)
        opt.step(grads, T.learning_rate(cfg, i))
        del total, grads
    change = {n: float((p.detach() - q).norm())
              for (n, p), q in zip(named, p0)}
    return {"losses": losses, "first_grad": first, "change": change}


def training_numbers(run, ref: Optional[Dict] = None) -> Dict[str, float]:
    """The checked steps' numbers (leaves whose reference gradient is
    round-off left out):

      * `first_loss`: the first step's loss's relative gap (later steps'
        losses carry Adam's moves of round-off gradients, PERF.md);
      * `first_grad_median`: the median leaf's gap of the first gradient's
        norms (the worst leaf's is the noise of small batch-norm leaves,
        PERF.md);
      * `first_grad_norms`: the relative gap of the vector of the first
        gradient's leaf norms (the large leaves);
      * `change`: the worst leaf's gap of the change after the checked
        steps."""
    ref = ref or reference_training(run)
    med = float(torch.tensor(list(ref["first_grad"].values())).median())
    leaves = [n for n, v in ref["first_grad"].items()
              if v >= ROUNDOFF_LEAF * med]
    return {"first_loss": abs(run.losses[0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "first_grad_median": float(np.median(
                leaf_gaps(run.first_grad, ref["first_grad"], leaves))),
            "first_grad_norms": norms_gap(run.first_grad, ref["first_grad"],
                                          leaves),
            "change": max(leaf_gaps(run.change, ref["change"], leaves))}
