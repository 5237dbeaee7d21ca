"""The layout denoiser's CUDA graphs (`EchoSceneModule.layout_graphs`,
`models/echo_scene.py`), tiny config.

On the CPU: with the scope open, `layout_eps` and the DDPM, DDIM and
DPM++ layout chains give the bits they give without it; which calls are
graphed (the first call of a signature eager, the second a capture and a
replay, later ones replays; none outside the scope, with autograd, in
training mode or off the card), read from the program's spans with a
stand-in graph that replays eagerly and GRAPH_DEVICE set to the CPU;
`sample_fn` graphs its layout chain whatever the sampler; a scope leaves
nothing behind when it closes or raises.

On a card (`cuda` marker; no jax: `-m cuda --noconftest`): replays equal
eager calls bit for bit for the bf16 twin, the int8 twin and the f32
module at two row counts in one scope and over a DPM++ 50 chain; a scope
gives back the memory it took; two threads on two streams capture at once
over one module, as the data-parallel sampler runs; a capture under the
profiler keeps every device activity linked to its launch.
"""
import contextlib
import threading
import weakref

import pytest
import torch

from echoscene_torch import trace
from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS, synthetic_batch
from echoscene_torch.models import echo_scene
from echoscene_torch.models.config import tiny_config
from echoscene_torch.models.sgdiff import (SGDiff, compact_graph,
                                           shape_row_capacity)

torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]
EAGER, CAPTURE, REPLAY = [], ["layout_capture", "layout_graph"], \
    ["layout_graph"]


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


class Case:
    """A sampling module, the layout denoiser's inputs at the batch's
    compacted rows (and at fewer), and the layout chains over them."""

    def __init__(self, device="cpu", sample_dtype="bfloat16", sampler="ddpm",
                 time_num=12, sample_steps=4):
        cfg = tiny_config()
        cfg.sample_dtype = sample_dtype
        cfg.layout_diffusion.sampler = sampler
        cfg.layout_diffusion.time_num = time_num
        cfg.layout_diffusion.sample_steps = sample_steps
        torch.manual_seed(0)
        self.device = torch.device(device)
        self.sg = SGDiff(cfg, NUM_OBJS, NUM_PREDS, device=device)
        self.batch = synthetic_batch(3, cfg.max_nodes, cfg.max_triples,
                                     seed=1).to(self.device)
        self.rows = shape_row_capacity(self.batch)
        self.model = self.sg.inference_module()
        with torch.no_grad():
            self.ctx = self.model.encode_context(
                self.batch, torch.zeros((self.batch.num_nodes,
                                         cfg.embedding_dim),
                                        device=self.device), False)

    def args(self, rows=None, seed=0):
        """layout_eps's inputs at `rows` rows, the state and steps drawn
        from `seed`."""
        rows = rows or self.rows
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((rows, self.sg.cfg.layout_denoiser.in_channels),
                        generator=g).to(self.device)
        t = torch.randint(0, self.sg.cfg.layout_diffusion.time_num, (rows,),
                          generator=g).to(self.device)
        return (x, t, self.ctx["obj_embed"][:rows]) + compact_graph(
            self.batch, rows)

    def chain(self, method, model=None):
        """The layout chain `method` over the compacted rows, as
        `sample_fn` runs it."""
        model = model or self.model
        _, _, obj, triples, obj_mask, tri_mask = self.args()
        shape = (self.rows, self.sg.cfg.layout_denoiser.in_channels)
        gen = torch.Generator(device=self.device).manual_seed(5)
        diff = self.sg.layout_diff

        def denoise(x, t):
            return model.layout_eps(x, t, obj, triples, obj_mask, tri_mask)
        if method == "ddpm":
            return diff.sample_chain(denoise, shape, noise_rows=self.rows,
                                     generator=gen, device=self.device)
        x_T = torch.randn(shape, generator=gen, device=self.device)
        return diff.sample_chain_fast(
            denoise, shape, self.sg.layout_fast_tables[method],
            method=method, x_T=x_T, generator=gen, device=self.device)


class StandIn:
    """`_LayoutGraph` on the CPU: it captures nothing and replays eagerly."""

    made = []

    def __init__(self, forward, args):
        self.forward = forward
        StandIn.made.append(weakref.ref(self))

    def replay(self, args):
        return self.forward(*args)


@pytest.fixture
def on_cpu(monkeypatch):
    """Graphs on the CPU, by the stand-in."""
    monkeypatch.setattr(echo_scene, "GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(echo_scene, "_LayoutGraph", StandIn)
    StandIn.made = []


def _layout_children(fn):
    """fn()'s value and, for each `layout_eps` span it recorded, the names
    of its children."""
    trace.take()
    with torch.profiler.profile(activities=CPU):
        value = fn()
    spans = trace.take()
    return value, [[c.name for c in spans if c.parent == i]
                   for i, sp in enumerate(spans) if sp.name == "layout_eps"]


# --- on the CPU -------------------------------------------------------------
@pytest.mark.parametrize("part", ["layout_eps", "ddpm", "ddim", "dpmpp"])
def test_scope_keeps_the_bits_on_cpu(part):
    case = Case()
    model = case.model

    def run():
        with torch.no_grad():
            if part == "layout_eps":
                return [model.layout_eps(*case.args(rows, seed))
                        for rows, seed in [(None, 0), (None, 1), (None, 2),
                                           (8, 3), (None, 4)]]
            return [case.chain(part)]
    plain = run()
    with model.layout_graphs():
        scoped, children = _layout_children(run)
    assert all(c == EAGER for c in children) and children
    for a, b in zip(plain, scoped, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case_name", [
    "graphed", "outside the scope", "grad on", "train mode", "cpu",
    "new signature"])
def test_which_calls_are_graphed(case_name, monkeypatch):
    case = Case()
    model = case.model
    if case_name != "cpu":
        monkeypatch.setattr(echo_scene, "GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(echo_scene, "_LayoutGraph", StandIn)
    rows = [None] * 3
    if case_name == "new signature":
        rows = [None, None, None, 8, 8, 8, None]
    calls = [case.args(r, seed) for seed, r in enumerate(rows)]
    with torch.no_grad():
        want = [model.layout_eps(*a) for a in calls]
    if case_name == "train mode":
        model.train()

    def run():
        with torch.set_grad_enabled(case_name == "grad on"):
            return [model.layout_eps(*a) for a in calls]
    if case_name == "outside the scope":
        got, children = _layout_children(run)
    else:
        with model.layout_graphs():
            got, children = _layout_children(run)
    expect = {"graphed": [EAGER, CAPTURE, REPLAY],
              "new signature": [EAGER, CAPTURE, REPLAY, EAGER, CAPTURE,
                                REPLAY, REPLAY]}.get(case_name,
                                                     [EAGER] * 3)
    assert children == expect
    if case_name != "train mode":   # batch statistics in training mode
        for a, b in zip(want, got, strict=True):
            assert torch.equal(a, b.detach())


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp"])
def test_sample_fn_graphs_its_layout_chain(sampler, on_cpu):
    case = Case(sampler=sampler)
    out, children = _layout_children(lambda: case.sg.sample_fn(
        case.batch, torch.Generator().manual_seed(3), gen_shape=False,
        shape_rows=case.rows))
    steps = 12 if sampler == "ddpm" else 4
    assert children == [EAGER, CAPTURE] + [REPLAY] * (steps - 2)
    assert echo_scene._open_scopes() == {}
    assert all(ref() is None for ref in StandIn.made)


@pytest.mark.parametrize("how", ["closes", "raises"])
def test_scope_leaves_nothing_behind(how, on_cpu):
    case = Case()
    model = case.model
    fails = pytest.raises(RuntimeError, match="the chain failed")
    with fails if how == "raises" else contextlib.nullcontext():
        with torch.no_grad(), model.layout_graphs():
            for seed in range(3):
                model.layout_eps(*case.args(seed=seed))
            assert len(echo_scene._open_scopes()[model]) == 1
            assert StandIn.made[0]() is not None
            if how == "raises":
                raise RuntimeError("the chain failed")
    assert model not in echo_scene._open_scopes()
    assert len(StandIn.made) == 1 and StandIn.made[0]() is None


# --- on the card ------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("sample_dtype", ["bfloat16", "int8", "float32"])
def test_cuda_replay_matches_eager(sample_dtype):
    """Two row counts in one scope, in turns; every call against the same
    call made eagerly."""
    _needs_cuda()
    case = Case("cuda", sample_dtype)
    model = case.model
    rows = [None, None, None, 8, 8, 8, None, 8]
    calls = [case.args(r, seed) for seed, r in enumerate(rows)]
    with torch.no_grad():
        want = [model.layout_eps(*a) for a in calls]
        with model.layout_graphs():
            got = [model.layout_eps(*a) for a in calls]
            graphs = echo_scene._open_scopes()[model]
            assert len(graphs) == 2
            assert all(isinstance(g, echo_scene._LayoutGraph)
                       for g in graphs.values())
    for a, b in zip(want, got, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_dpmpp_50_chain_matches_eager():
    _needs_cuda()
    case = Case("cuda", sampler="dpmpp", time_num=1000, sample_steps=50)
    with torch.no_grad():
        want = case.chain("dpmpp")
        with case.model.layout_graphs():
            got, children = _layout_children(lambda: case.chain("dpmpp"))
    assert children == [EAGER, CAPTURE] + [REPLAY] * 48
    assert torch.equal(want, got)


@pytest.mark.cuda
def test_cuda_scope_gives_back_its_memory():
    """The first chain on a caller stream makes its capture stream and
    pool, which stay (with the stream's cuBLAS workspace); every later
    scope leaves the allocated bytes as they were."""
    _needs_cuda()
    case = Case("cuda", sampler="dpmpp", time_num=1000, sample_steps=20)
    model = case.model

    def scoped():
        with torch.no_grad(), model.layout_graphs():
            case.chain("dpmpp")
            for rows in (8, 8, 8):
                model.layout_eps(*case.args(rows))
        torch.cuda.synchronize()
    scoped()
    for _ in range(2):
        before = torch.cuda.memory_allocated()
        scoped()
        assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_cuda_two_threads_capture_at_once():
    """One module, two threads each on its own stream (the data-parallel
    sampler's shards on one card), chains started together."""
    _needs_cuda()
    case = Case("cuda", sampler="dpmpp", time_num=1000, sample_steps=50)
    with torch.no_grad():
        want = case.chain("dpmpp")
    torch.cuda.synchronize()
    outs, errors = [None, None], []
    start = threading.Barrier(2)

    def run(i):
        try:
            stream = torch.cuda.Stream("cuda")
            with torch.no_grad(), torch.cuda.stream(stream):
                stream.wait_stream(torch.cuda.default_stream())
                start.wait(timeout=60)
                with case.model.layout_graphs():
                    outs[i] = case.chain("dpmpp")
                stream.synchronize()
        except BaseException as e:  # raised again below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    for out in outs:
        assert torch.equal(want, out)


@pytest.mark.cuda
def test_cuda_capture_under_profiler_links_launches():
    from portbench.trace import traced

    _needs_cuda()
    case = Case("cuda", sampler="dpmpp", time_num=1000, sample_steps=50)
    with torch.no_grad():
        want = case.chain("dpmpp")

        def chain():
            with case.model.layout_graphs():
                return case.chain("dpmpp")
        got, tr = traced(chain, case.device)
    assert torch.equal(want, got)
    assert tr.attributed() >= 0.99
    # the replays' kernels are in the trace: 48 steps at least as many as
    # the eager step launched
    assert len(tr.device) > 48
