"""The program's spans (`echoscene_torch/trace.py`) on the CPU, tiny config.

With the profiler off a sampling call and a train step record nothing;
under `torch.profiler` they record the tree of the program's layers (one
root per call, one denoiser span per chain step, one norm span per shape
torso norm, one decode span per chunk, the int8 conversion only under
int8, the optimizer's spans only on the micro-step that applies them),
each span holding its `echoscene.<name>` profiler range within 50 us at
either end; the outputs are bit-identical either way; the recorder keeps
at most its bound.
"""
import pytest
import torch

from echoscene_torch import trace
from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS, synthetic_batch
from echoscene_torch.models.config import tiny_config
from echoscene_torch.models.sgdiff import SGDiff, shape_row_capacity
from echoscene_torch.nn.unet3d import torso_norm_sites

torch.set_num_threads(1)
CHUNK = 4
CLOCK_NS = 50_000
CPU = [torch.profiler.ProfilerActivity.CPU]


def _sgdiff(sample_dtype="bfloat16", compute_dtype="float32", grad_accum=1):
    cfg = tiny_config()
    cfg.sample_dtype = sample_dtype
    cfg.compute_dtype = compute_dtype
    cfg.grad_accum = grad_accum
    torch.manual_seed(0)
    return SGDiff(cfg, NUM_OBJS, NUM_PREDS, device="cpu")


def _sample(sg):
    batch = synthetic_batch(3, sg.cfg.max_nodes, sg.cfg.max_triples, seed=1)
    rows = shape_row_capacity(batch)
    out = sg.sample_fn(batch, torch.Generator().manual_seed(3),
                       shape_rows=rows, decode_chunk=CHUNK)
    return out, rows


def _train(sg, steps):
    state = sg.init_train_state()
    batch = synthetic_batch(3, sg.cfg.max_nodes, sg.cfg.max_triples, seed=1,
                            diffusion_bs=sg.cfg.diffusion_bs, sdf_res=16)
    return [sg.train_step(state, batch, torch.Generator().manual_seed(4 + i))
            for i in range(steps)]


def _profiled(fn):
    """fn() under the profiler: its value, the spans it recorded and the
    profiler's `echoscene.*` ranges as (name, start_ns, end_ns)."""
    trace.take()
    with torch.profiler.profile(activities=CPU) as prof:
        # the session's first range pays the profiler's set-up (0.1 ms
        # here), as the benchmark's window range does before the program's
        with torch.profiler.record_function("warm-up"):
            pass
        value = fn()
    spans = trace.take()
    ranges = sorted(((e.name()[len(trace.PREFIX):], e.start_ns(),
                      e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(trace.PREFIX)),
                    key=lambda r: r[1])
    return value, spans, ranges


def _children(spans, i):
    return [spans[j].name for j in range(len(spans))
            if spans[j].parent == i]


def _consistent(spans):
    """Parents open before their children and hold them; the call is the
    root's."""
    for i, sp in enumerate(spans):
        assert sp.start_ns <= sp.end_ns
        if sp.parent is None:
            assert sp.call == spans[i].call
            continue
        parent = spans[sp.parent]
        assert sp.parent < i and sp.call == parent.call
        assert parent.start_ns <= sp.start_ns <= sp.end_ns <= parent.end_ns


@pytest.mark.parametrize("path", ["sample", "train"])
def test_nothing_recorded_without_profiler(path):
    trace.take()
    if path == "sample":
        _sample(_sgdiff())
    else:
        _train(_sgdiff(compute_dtype="bfloat16"), 1)
    assert not trace.enabled()
    assert trace.take() == []


@pytest.mark.parametrize("sample_dtype", ["bfloat16", "int8"])
def test_sample_fn_records_its_tree(sample_dtype):
    sg = _sgdiff(sample_dtype)
    (_, rows), spans, _ = _profiled(lambda: _sample(sg))
    _consistent(spans)
    roots = [i for i, sp in enumerate(spans) if sp.parent is None]
    assert [spans[i].name for i in roots] == ["sample_fn"]
    root = roots[0]
    assert {sp.call for sp in spans} == {spans[root].call}
    assert _children(spans, root) == ["twin_build", "encode_context",
                                      "layout_chain", "shape_chain",
                                      "decode"]
    by_name = {sp.name: i for i, sp in enumerate(spans)}
    cfg = sg.cfg
    layout_steps = (cfg.layout_diffusion.time_num
                    if cfg.layout_diffusion.sampler == "ddpm"
                    else cfg.layout_diffusion.sample_steps)
    assert _children(spans, by_name["twin_build"]) == (
        ["twin_int8"] if sample_dtype == "int8" else [])
    assert _children(spans, by_name["layout_chain"]) == \
        ["layout_eps"] * layout_steps
    assert _children(spans, by_name["shape_chain"]) == \
        ["shape_eps"] * cfg.shape_branch.ddim_steps
    assert _children(spans, by_name["decode"]) == \
        ["decode_chunk"] * -(-rows // CHUNK)
    # each shape denoiser call: one `norm3d` a torso norm, none of them
    # fused on the CPU
    norms = sum(s["calls"] for s in torso_norm_sites(
        cfg.shape_branch.denoiser, rows))
    for i, sp in enumerate(spans):
        if sp.name == "shape_eps":
            assert _children(spans, i) == ["norm3d"] * norms
    for name in ("encode_context", "layout_eps", "norm3d",
                 "decode_chunk", "twin_int8"):
        for i, sp in enumerate(spans):
            if sp.name == name:
                assert _children(spans, i) == []


@pytest.mark.parametrize("compute_dtype,grad_accum", [
    ("float32", 1), ("bfloat16", 1), ("bfloat16", 2)])
def test_train_step_records_its_tree(compute_dtype, grad_accum):
    sg = _sgdiff(compute_dtype=compute_dtype, grad_accum=grad_accum)
    _, spans, _ = _profiled(lambda: _train(sg, grad_accum))
    _consistent(spans)
    roots = [i for i, sp in enumerate(spans) if sp.parent is None]
    assert [spans[i].name for i in roots] == ["train_step"] * grad_accum
    assert len({spans[i].call for i in roots}) == grad_accum
    parts = ["encode_context", "layout_eps", "shape_eps"]
    cast = ["cast"] if compute_dtype == "bfloat16" else []
    for k, root in enumerate(roots):
        applies = k == grad_accum - 1
        assert _children(spans, root) == (
            ["forward", "backward", "grad_norm"]
            + (["clip", "adamw"] if applies else []))
        forward = next(i for i in range(root, len(spans))
                       if spans[i].name == "forward")
        assert _children(spans, forward) == cast + parts


def test_spans_hold_their_profiler_ranges():
    """Every span holds its range; the ends agree within CLOCK_NS on one
    of three calls (a stall of the host between a stamp and its range,
    such as the page faults after the twin's copy, can pass 50 us here on
    a busy machine)."""
    sg = _sgdiff("int8", compute_dtype="bfloat16")

    def both():
        _sample(sg)
        _train(sg, 1)
    gaps = []
    for _ in range(3):
        _, spans, ranges = _profiled(both)
        assert len(spans) == len(ranges) > 30
        gap = 0
        for sp, (name, start, end) in zip(
                sorted(spans, key=lambda s: s.start_ns), ranges):
            assert sp.name == name
            assert sp.start_ns <= start and end <= sp.end_ns, name
            gap = max(gap, start - sp.start_ns, sp.end_ns - end)
        gaps.append(gap)
        if gap <= CLOCK_NS:
            break
    assert min(gaps) <= CLOCK_NS, gaps


@pytest.mark.parametrize("path", ["sample", "train"])
def test_outputs_identical_with_tracing(path):
    def run():
        if path == "sample":
            return _sample(_sgdiff("int8"))[0]
        # float32: the CPU's bf16 convolution gradients are not repeatable
        sg = _sgdiff(compute_dtype="float32")
        metrics = _train(sg, 2)[-1]
        metrics.update(sg.module.state_dict())
        return metrics
    off = run()
    on, spans, _ = _profiled(run)
    assert spans
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_recorder_keeps_at_most_its_bound(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.take()
    with torch.profiler.profile(activities=CPU):
        with trace.span("outer"):
            for i in range(4):
                with trace.span(f"inner{i}"):
                    pass
    spans = trace.take()
    assert [sp.name for sp in spans] == ["inner0", "inner1", "inner2"]
    # the outer span closed last and was not kept: its children are roots
    assert [sp.parent for sp in spans] == [None] * 3
    assert len({sp.call for sp in spans}) == 1
    assert trace.take() == []
