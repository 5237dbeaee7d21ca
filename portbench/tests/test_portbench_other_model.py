"""A cell of a model other than EchoScene joins the benchmark through new
files and list entries alone: a configuration with none of EchoScene's
keys, a traffic mix of a new kind whose module (registered here, a small
convolutional autoencoder trained on the generator's SDF grids) owns all
that is particular to the model, its limits and a per-layer metric.  The
benchmark's tree is copied, the new files added beside the old ones, and
`BENCHMARK.json`'s lists appended to, its end-to-end metric among them;
`run.py`, `check.py`, `calibrate.py` and the spec tests then take the cell
as they are."""
import copy
import json
import os
import shutil
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F

import test_portbench_spec as spec_tests
from portbench import calibrate, check, model_config, run as bench, scenes
from portbench.weights import draw_, spec_of

torch.set_num_threads(1)
KIND, CONFIG, CELL = "grid_fit", "grid_ae_f32", "grid_fit_f32"
METRIC, STEP_MS = "grid_fit_grids_per_s", "grid_step_ms.fit"
NUMBERS = ("first_loss", "change")


class Net(torch.nn.Module):
    """The program: one strided convolution down, one transposed up."""

    def __init__(self, cfg):
        super().__init__()
        w = cfg["width"]
        self.enc = torch.nn.Conv3d(1, w, 3, stride=2, padding=1)
        self.dec = torch.nn.ConvTranspose3d(w, 1, 4, stride=2, padding=1)

    def forward(self, x):
        return self.dec(torch.relu(self.enc(x)))


def weight_spec(cfg):
    with torch.device("meta"):
        return spec_of(Net(cfg), ())


def grids(mix, seed, i, device):
    b = mix["batch"]
    return scenes.analytic_sdfs(b, b, mix["resolution"], mix["sdf_clip"],
                                seed, i, device).permute(0, 4, 1, 2, 3)


def l1(x, rec):
    return (x - rec).abs().mean()


class GridFit:
    """The kind's driver: SGD steps of `Net` over a feed of seeded grids,
    the first `checked_steps` kept for the check."""

    def __init__(self, cfg, mix, seed, device, spec, trace):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.trace = torch.device(device), trace
        self.net = Net(cfg).to(self.device)
        draw_(dict(self.net.named_parameters()), spec, seed, self.device)
        self.p0 = [p.detach().clone() for p in self.net.parameters()]
        self.opt = torch.optim.SGD(self.net.parameters(), lr=cfg["lr"])
        self.feed = [grids(mix, seed, i, self.device)
                     for i in range(mix["feed"])]
        self.done, self.step_s, self.trace_data = 0, [], None
        self.losses = [self.step() for _ in range(mix["checked_steps"])]
        self.change = float(torch.stack([
            (p.detach() - q).norm() for p, q in zip(self.net.parameters(),
                                                    self.p0)]).norm())

    def step(self):
        x = self.feed[self.done % len(self.feed)]
        self.opt.zero_grad()
        loss = l1(x, self.net(x))
        loss.backward()
        self.opt.step()
        self.done += 1
        return float(loss.detach())

    def window(self, seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            s = time.perf_counter()
            self.step()
            self.step_s.append(time.perf_counter() - s)
        self.window_s = time.perf_counter() - t0

    def attempted(self):
        return len(self.step_s)

    def end_to_end(self, setup_s):
        return {METRIC: self.mix["batch"] * len(self.step_s) / self.window_s,
                "setup_s": setup_s}

    def release(self):
        del self.net, self.opt

    def check(self):
        return numbers(self, reference(self.cfg, self.mix, self.seed,
                                       self.device))


def reference(cfg, mix, seed, device):
    """Plain functional convolutions and SGD on weights the reference draws
    itself: the first loss and the change after the checked steps."""
    p = {n: torch.zeros(s, device=device, requires_grad=True)
         for n, s, _ in weight_spec(cfg)}
    draw_(p, weight_spec(cfg), seed, device)
    p0 = {n: v.detach().clone() for n, v in p.items()}
    losses = []
    for i in range(mix["checked_steps"]):
        x = grids(mix, seed, i % mix["feed"], device)
        h = F.relu(F.conv3d(x, p["enc.weight"], p["enc.bias"], stride=2,
                            padding=1))
        loss = l1(x, F.conv_transpose3d(h, p["dec.weight"], p["dec.bias"],
                                        stride=2, padding=1))
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v -= cfg["lr"] * g
        losses.append(float(loss.detach()))
    change = float(torch.stack([(p[n].detach() - p0[n]).norm()
                                for n in p]).norm())
    return {"losses": losses, "change": change}


def numbers(run, ref):
    return {"first_loss": abs(run.losses[0] - ref["losses"][0])
            / ref["losses"][0],
            "change": abs(run.change - ref["change"]) / ref["change"]}


def unchanged(self):
    """The fault: a step that returns its state unchanged."""
    self.done += 1
    return float(l1(self.feed[0], self.net(self.feed[0])).detach())


def calibration_line(workload, cfg, mix, seed, spec, also, dev="cpu"):
    run = GridFit(cfg, mix, seed, dev, spec, False)
    ref = reference(cfg, mix, seed, dev)
    line = {"workload": workload, "seed": seed,
            "program": numbers(run, ref)}
    if "fault" in also:
        broken = type("Broken", (GridFit,), {"step": unchanged})
        line["program_unchanged"] = numbers(
            broken(cfg, mix, seed, dev, spec, False), ref)
    return line


FILES = {
    f"configs/{CONFIG}.json": {
        "source": "a stand-in: a two-layer 3D convolutional autoencoder",
        "reduced": [], "width": 4, "lr": 0.5},
    f"traffic/{KIND}.json": {
        "kind": KIND, "batch": 4, "resolution": 8, "sdf_clip": 0.2,
        "feed": 2, "checked_steps": 2},
    f"limits/{CELL}.json": {"limits": {"first_loss": 1e-5, "change": 1e-4}},
}
READER = ("def read(run):\n"
          "    return (1e3 * sum(run.step_s) / len(run.step_s)\n"
          "            if run.step_s else None)\n")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """The benchmark's files and the cell's new ones in a copy, the copy's
    `BENCHMARK.json` the repository's with the cell appended to its
    lists, and the kind's module registered; returns that spec."""
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(bench.HERE, sub), here / sub)
    for name, body in FILES.items():
        (here / name).write_text(json.dumps(body))
    (here / "metrics" / f"{STEP_MS}.py").write_text(READER)
    spec = copy.deepcopy(bench.load_spec())
    spec["configs"].append({
        "name": CONFIG, "source": FILES[f"configs/{CONFIG}.json"]["source"],
        "file": f"portbench/configs/{CONFIG}.json", "reduced": [],
        "why": "a model with none of EchoScene's keys"})
    spec["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": KIND, "chips": 1,
        "why": "SGD steps over seeded SDF grids"})
    spec["end_to_end"].append({
        "name": METRIC, "unit": "grids/s", "better": "higher", "bound": 0.01,
        "source": "host_clock", "workloads": [CELL]})
    spec["per_layer"].append({
        "name": STEP_MS, "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "train step", "moves": METRIC,
        "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(bench, "ROOT", str(tmp_path))
    for mod in (bench, model_config, scenes, check):
        monkeypatch.setattr(mod, "HERE", str(here))
    kind = types.ModuleType(f"portbench.{KIND}")
    kind.Driver, kind.weight_spec, kind.NUMBERS = GridFit, weight_spec, \
        NUMBERS
    kind.CALIBRATION_SEEDS = {"fault": "also a step that returns its state"}
    kind.calibration_line = calibration_line
    monkeypatch.setitem(sys.modules, kind.__name__, kind)
    return spec


def test_the_configuration_is_not_echoscene(tree):
    cfg = model_config.load(CONFIG)
    assert not {"graph", "layout_branch", "shape_branch"} & set(cfg)


@pytest.mark.parametrize("name", ["test_top_level_keys",
                                  "test_names_and_units",
                                  "test_metric_keys_and_bounds",
                                  "test_every_cell_resolves",
                                  "test_no_width_is_reduced"])
def test_spec_tests_take_the_cell(tree, name):
    getattr(spec_tests, name)(tree)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_from_its_files(tree, trace):
    result = bench.run_cell(CELL, 2 ** 31 + 9, 0.3, trace, device="cpu")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(NUMBERS)
    want = {STEP_MS} if trace else {METRIC, "setup_s"}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_cell_runs_with_its_inputs_passed(tree):
    result = bench.run_cell(CELL, 11, 0.1, False, device="cpu", spec=tree,
                            cfg=model_config.load(CONFIG),
                            mix=scenes.load(KIND))
    assert result["correct"], result["checks"]


def test_step_returning_its_state_is_not_correct(tree, monkeypatch):
    monkeypatch.setattr(GridFit, "step", unchanged)
    result = bench.run_cell(CELL, 12, 0.1, False, device="cpu")
    assert not result["correct"], result["checks"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


def test_calibrate_takes_the_cell(tree, capsys):
    assert calibrate.main(["--workload", CELL, "--seeds", "3", "4",
                           "--fault-seeds", "4"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [3, 4]
    assert all(x["program"]["first_loss"] < 1e-5 for x in lines)
    assert "program_unchanged" not in lines[0]
    assert lines[1]["program_unchanged"]["change"] == pytest.approx(1.0)
