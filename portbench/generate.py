"""The driver of `generate` traffic: a closed loop of whole generation
calls, each made as the program's evaluator makes it
(`SGDiff.sample_fn(batch, generator, gen_shape=True,
shape_rows=shape_row_capacity(batch))`, outputs copied to the host).

Spans come from the benchmark's own code.  `sample_fn` builds its sampling
module with `sg.inference_module()`; the driver wraps that method of the
instance, so the twin is still built inside every call, and hands back the
twin inside a `Proxy` that, around `encode_context`, `layout_eps`,
`shape_eps` and `decode_latent`:

  * in a traced run, opens a `portbench.<name>` profiler range and records
    CUDA events (the twin build is timed on the host clock with a
    synchronise on either side);
  * in the first call of every run, keeps the calls that the correctness
    check compares with the reference after the window, with their inputs
    and outputs: the context, three consecutive calls of each chain (the
    middle one drawn from the seed), the first layout call and one decode
    chunk.  The first call's outputs on the host are kept too.

Each call decodes in chunks of DECODE_CHUNK rows, handed to `sample_fn`
(the program's default, the evaluator's value), so that the warm-up, the
kept chunk and the metrics count the chunks that run.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Set

import torch

from . import check, model_config, scenes
from .trace import PREFIX, traced

PARTS = ("encode_context", "layout_eps", "shape_eps", "decode_latent")
DECODE_CHUNK = 8


def span(on: bool, name: str):
    """A `portbench.<name>` profiler range in a traced run, nothing
    otherwise."""
    return (torch.profiler.record_function(PREFIX + name) if on
            else contextlib.nullcontext())


class Recorder:
    """What the proxy records: call counts, CUDA event pairs (traced runs)
    and the kept calls (`keep`: part -> indices of the calls to keep, while
    `armed`; `kept`: part -> index -> inputs and output)."""

    def __init__(self, trace: bool, keep: Dict[str, Set[int]]):
        self.trace = trace
        self.keep = keep
        self.armed = False
        self.counts: Dict[str, int] = {p: 0 for p in PARTS}
        self.events: Dict[str, List] = {p: [] for p in PARTS}
        self.kept: Dict[str, Dict[int, Dict]] = {p: {} for p in PARTS}
        self.twin_build_s: List[float] = []

    def call(self, part: str, fn, args):
        i = self.counts[part]
        self.counts[part] = i + 1
        if not self.trace:
            out = fn(*args)
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with span(True, part):
                start.record()
                out = fn(*args)
                end.record()
            self.events[part].append((start, end))
        if self.armed and i in self.keep.get(part, ()):
            self.kept[part][i] = {"args": [_clone(a) for a in args],
                                  "out": _clone(out)}
        return out

    def span_ms(self, part: str) -> List[float]:
        return [s.elapsed_time(e) for s, e in self.events[part]]


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return None


class Proxy:
    """The twin, its four parts recorded (module docstring)."""

    def __init__(self, twin, rec: Recorder):
        self._twin, self._rec = twin, rec

    def encode_context(self, *args):
        return self._rec.call("encode_context", self._twin.encode_context,
                              args)

    def layout_eps(self, *args):
        return self._rec.call("layout_eps", self._twin.layout_eps, args)

    def shape_eps(self, *args):
        return self._rec.call("shape_eps", self._twin.shape_eps, args)

    def decode_latent(self, *args):
        return self._rec.call("decode_latent", self._twin.decode_latent,
                              args)

    def __getattr__(self, name):
        return getattr(self._twin, name)


def scene_batch(g: Dict, device):
    """The program's SceneBatch of a generated graph batch (both views the
    same graph)."""
    from echoscene_torch.core.graphbatch import GraphBatch, SceneBatch
    view = GraphBatch(objs=g["objs"], triples=g["triples"],
                      obj_mask=g["obj_mask"], triple_mask=g["triple_mask"],
                      text_feats=g["text_feats"], rel_feats=g["rel_feats"])
    return SceneBatch(enc=view, dec=view, objs_grained=g["objs"].clone(),
                      obj_to_scene=g["obj_to_scene"],
                      triple_to_scene=g["triple_to_scene"], boxes=g["boxes"],
                      change_flags=g["change_flags"],
                      enc_obj_mask=g["enc_obj_mask"],
                      num_scenes=g["num_scenes"]).to(device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_program(cfg: Dict, mix: Dict, seed: int, device, spec):
    """The program's SGDiff for `mix`'s batches, its weights drawn from
    `seed`."""
    from echoscene_torch.models.sgdiff import SGDiff
    from .weights import draw_
    n_cap, t_cap = scenes.capacities(mix)
    pcfg = model_config.program_config(cfg, mix["scenes"], n_cap, t_cap)
    g = cfg["graph"]
    sg = SGDiff(pcfg, g["num_objs"], g["num_preds"], device=device)
    draw_(dict(sg.module.named_parameters()), spec, seed, device)
    return sg


def keep_indices(cfg: Dict, seed: int, rows: int) -> Dict[str, Set[int]]:
    """Which calls the correctness check compares: the context; the first
    layout call (the start of the layout chain) and, in each chain, calls
    c - 1, c, c + 1 around a second-order step c (neither the first nor
    the last) drawn from the seed: the update from c to c + 1 takes c - 1's
    prediction; one decode chunk of a call at `rows` rows."""
    rng = scenes.rng_for(seed, 3)
    layout = cfg["layout_branch"]["diffusion_kwargs"]["sample_steps"]
    c_l = 1 + int(rng.integers(layout - 2))
    c_s = 1 + int(rng.integers(cfg["shape_branch"]["ddim_steps"] - 2))
    chunks = -(-rows // DECODE_CHUNK)
    return {"encode_context": {0},
            "layout_eps": {0, c_l - 1, c_l, c_l + 1},
            "shape_eps": {c_s - 1, c_s, c_s + 1},
            "decode_latent": {int(rng.integers(chunks))},
            "update": {"layout_eps": c_l, "shape_eps": c_s}}


@torch.no_grad()
def warm_up(sg, batches: Dict[int, object], seed: int) -> None:
    """One call of each part on a fresh twin, the chains' at each row count
    the window meets (`batches`: rows -> a batch of those rows): every
    kernel the window runs is built and every shape it takes is seen."""
    from echoscene_torch.models.sgdiff import compact_graph
    dev = sg.device
    cfg = sg.cfg
    twin = sg.inference_module()
    gen = torch.Generator(device=dev).manual_seed(scenes.torch_seed(seed, 4))
    r = cfg.shape_branch.denoiser.image_size
    for rows, batch in sorted(batches.items()):
        ctx = twin.encode_context(
            batch, torch.zeros((batch.num_nodes, cfg.embedding_dim),
                               device=dev), False)
        triples, obj_mask, tri_mask = compact_graph(batch, rows)
        x = torch.randn((rows, cfg.layout_denoiser.in_channels),
                        generator=gen, device=dev)
        z = torch.randn((rows, r, r, r, cfg.shape_branch.vqvae.embed_dim),
                        generator=gen, device=dev)
        t = torch.full((rows,), 500, dtype=torch.long, device=dev)
        twin.layout_eps(x, t, ctx["obj_embed"][:rows], triples, obj_mask,
                        tri_mask)
        twin.shape_eps(z, t, ctx["uc_s"][:rows, None, :], triples, obj_mask,
                       tri_mask)
    twin.decode_latent(z[:DECODE_CHUNK])
    sync(dev)


class Generation:
    """One run of a `generate` cell: set-up, the window, and what the
    metrics and the check read afterwards."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, spec,
                 trace: bool):
        from echoscene_torch.models.sgdiff import shape_row_capacity
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.trace = trace
        self.sg = build_program(cfg, mix, seed, device, spec)
        g = cfg["graph"]
        # one batch of each stratum: the row counts the window meets
        self.graphs = [scenes.graph_batch(mix, g["num_objs"], g["num_preds"],
                                          seed, i)
                       for i in range(len(scenes.batch_totals(mix)))]
        warm: Dict[int, object] = {}
        for graph in self.graphs:
            batch = scene_batch(graph, self.device)
            warm.setdefault(shape_row_capacity(batch, mix["row_multiple"]),
                            batch)
        self.rows = shape_row_capacity(scene_batch(self.graphs[0],
                                                   self.device),
                                       mix["row_multiple"])
        warm_up(self.sg, warm, seed)
        self.host: Dict = {}
        self.rec = Recorder(trace, keep_indices(cfg, seed, self.rows))
        build = self.sg.inference_module

        def inference_module(device=None):
            if trace:
                sync(self.device)
                t0 = time.perf_counter()
                with span(True, "twin_build"):
                    twin = build(device)
                sync(self.device)
                self.rec.twin_build_s.append(time.perf_counter() - t0)
            else:
                twin = build(device)
            return Proxy(twin, self.rec)

        self.sg.inference_module = inference_module
        self.call_s: List[float] = []
        self.trace_data = None

    def one_call(self, index: int):
        """Generation `index` of the seed's stream, outputs on the host."""
        from echoscene_torch.models.sgdiff import shape_row_capacity
        g = self.cfg["graph"]
        graph = (self.graphs[index] if index < len(self.graphs) else
                 scenes.graph_batch(self.mix, g["num_objs"], g["num_preds"],
                                    self.seed, index))
        gen = torch.Generator(device=self.device).manual_seed(
            scenes.torch_seed(self.seed, 5, index))
        t0 = time.perf_counter()
        batch = scene_batch(graph, self.device)
        out = self.sg.sample_fn(batch, gen, gen_shape=True,
                                decode_chunk=DECODE_CHUNK,
                                shape_rows=shape_row_capacity(
                                    batch, self.mix["row_multiple"]))
        with span(self.trace, "host_copy"):
            host = {k: v.float().cpu().numpy() for k, v in out.items()}
        self.call_s.append(time.perf_counter() - t0)
        if self.rec.armed:
            self.host = {k: v for k, v in host.items() if k != "shapes"}
        return host

    def window(self, seconds: float) -> None:
        """Whole calls back to back while the next one, as long as the last,
        still ends inside the window; the first is the one the check keeps.
        A traced run traces that first call alone."""
        self.rec.armed = True
        if self.trace:
            _, self.trace_data = traced(lambda: self.one_call(0),
                                        self.device)
            self.rec.armed = False
            return
        t0 = time.perf_counter()
        index = 0
        while True:
            self.one_call(index)
            self.rec.armed = False
            index += 1
            if time.perf_counter() - t0 + self.call_s[-1] > seconds:
                break
        print("portbench: calls of " + ", ".join(
            f"{t:.3f}" for t in self.call_s) + " s", file=sys.stderr)

    def attempted(self) -> int:
        return len(self.call_s)

    def end_to_end(self, setup_s: float) -> Dict[str, float]:
        return {"gen_scenes_per_s": self.mix["scenes"] * len(self.call_s)
                / sum(self.call_s), "setup_s": setup_s}

    def steps(self) -> Dict[str, int]:
        lb = self.cfg["layout_branch"]["diffusion_kwargs"]
        return {"layout": lb["sample_steps"],
                "shape": self.cfg["shape_branch"]["ddim_steps"],
                "chunks": -(-self.rows // DECODE_CHUNK)}

    def release(self) -> None:
        """Free the program before the reference runs."""
        del self.sg
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The kept calls against the reference (the program must be
        released first)."""
        model = check.reference(self.cfg, self.seed, self.device)
        ref = check.reference_outputs(model, self.cfg, self.graphs[0],
                                      self.rec, self.rows, self.device)
        return check.numbers(check.produced(self.rec, self.host,
                                            self.graphs[0]["real_nodes"]),
                             ref)


def calibration_line(workload: str, cfg: Dict, mix: Dict, seed: int, spec,
                     also: Set[str], dev: str = "cuda:0") -> Dict:
    """One seed's readings (`calibrate.py`): one generation call as a
    run's window makes it and the control (the reference in float8 / int4
    at its sites, the chains' updates in bfloat16) against the reference;
    with "int8" in `also`, the program with its own int8 path switched on
    (`sample_dtype: int8`) too."""
    t0 = time.perf_counter()
    run = Generation(cfg, mix, seed, dev, spec, False)
    run.window(0.0)
    graph, rows, real = run.graphs[0], run.rows, run.graphs[0]["real_nodes"]
    sound = (run.rec, check.produced(run.rec, run.host, real))
    own = None
    if "int8" in also:
        run.sg.cfg.sample_dtype = "int8"
        run.rec, run.host = Recorder(False, run.rec.keep), {}
        run.rec.armed = True
        run.one_call(0)
        own = (run.rec, check.produced(run.rec, run.host, real))
    run.release()
    del run
    t1 = time.perf_counter()
    ref = check.reference(cfg, seed, dev)
    want = check.reference_outputs(ref, cfg, graph, sound[0], rows, dev)
    sync(dev)
    t2 = time.perf_counter()
    ctl = check.reference(cfg, seed, dev, "control")
    line = {"workload": workload, "seed": seed,
            "program": check.numbers(sound[1], want),
            "control": check.numbers(check.reference_outputs(
                ctl, cfg, graph, sound[0], rows, dev, torch.bfloat16), want),
            "program_s": t1 - t0, "reference_s": t2 - t1}
    del ctl
    if own is not None:
        line["program_int8"] = check.numbers(own[1], check.reference_outputs(
            ref, cfg, graph, own[0], rows, dev))
    del ref
    if dev != "cpu":
        torch.cuda.empty_cache()
    return line


Driver = Generation
weight_spec = check.weight_spec
NUMBERS = check.NUMBERS
CALIBRATION_SEEDS = {"int8": "also the program with its own int8 path "
                             "switched on (sample_dtype int8)"}
