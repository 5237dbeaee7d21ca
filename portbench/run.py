"""Run one cell of the benchmark:

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
per-layer metrics are found by name (`BENCHMARK.json`, `portbench/configs/`,
`portbench/traffic/`, `portbench/metrics/`).  Set-up builds the program
with weights drawn from the seed and warms every shape the window uses;
the window measures `--seconds`; then the check compares what the window
produced with the float32 reference.  The last line of standard output is
one JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` `breakdown`, then `checks`); the last lines of standard
error are the compared numbers beside their limits.  Without a CUDA device
the run prints no result and exits with 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build",
                                               "torch_extensions"),
          "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton")}
# top-level modules no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "echoscene_tpu")


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, taken
    whole) is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def load_spec() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(spec: Dict, workload: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for_e2e(spec: Dict, workload: str) -> List[Dict]:
    """The end-to-end metrics the cell reports: those that list it or list
    no cells."""
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def metrics_for(spec: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those that list no cells and move an end-to-end metric it reports."""
    e2e = {m["name"] for m in metrics_for_e2e(spec, workload)}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def reader(name: str):
    """The `read` function of per-layer metric `name`
    (`portbench/metrics/<name>.py`)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def kind(name: str):
    """The module of a traffic kind, `portbench/<name>.py`, which owns all
    that is particular to its model: `Driver`, `weight_spec(cfg)`,
    `NUMBERS` (the names its `check()` returns), `CALIBRATION_SEEDS` and
    `calibration_line` (`calibrate.py`)."""
    return importlib.import_module(f"portbench.{name}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, spec: Optional[Dict] = None,
             cfg: Optional[Dict] = None, mix: Optional[Dict] = None
             ) -> Dict:
    """One run of `workload`; returns the result object.  `device` None
    means the CUDA device, which must be there; the tests pass "cpu" and a
    small `cfg` / `mix` in place of the cell's files."""
    for k, v in CACHES.items():
        os.environ[k] = v
    import torch
    from . import check, model_config, scenes
    spec = spec or load_spec()
    cell = cell_of(spec, workload)
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell needs {cell['chips']}")
        device = "cuda:0"
    dev = torch.device(device)
    cfg = cfg or model_config.load(cell["config"])
    mix = mix or scenes.load(cell["traffic"])
    limits = check.limits(workload)
    mod = kind(mix["kind"])
    run = mod.Driver(cfg, mix, seed, dev, mod.weight_spec(cfg), trace)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    run.window(seconds)
    result: Dict = {"correct": False, "attempted": run.attempted(),
                    "failed": 0}
    if trace:
        values = {}
        for m in metrics_for(spec, workload):
            v = reader(m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
    else:
        e2e = run.end_to_end(setup_s)
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in metrics_for_e2e(spec, workload)}
    if dev.type == "cuda":
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(dev),
                            "count": cell["chips"],
                            "memory_peak_bytes": int(
                                torch.cuda.max_memory_allocated(dev))}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    tr = run.trace_data
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s()
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    run.release()
    got = run.check()
    result["correct"] = all(got[k] <= limits[k] for k in limits)
    result["checks"] = {k: {"value": got[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoDevice as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(f"portbench: {result['attempted']} window calls or steps",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
