"""The check for forbidden modules compares whole top-level names."""
import sys
import types

from portbench.run import forbidden_modules


def test_whole_top_level_names(monkeypatch):
    for name in ("echoscene_tpu_like", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "echoscene_tpu.core",
                        types.ModuleType("echoscene_tpu.core"))
    assert forbidden_modules() == ["echoscene_tpu", "jax"]


def test_the_harness_imports_nothing_forbidden():
    import os
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = ("import sys, portbench.run, portbench.check, portbench.generate,"
            " portbench.flops, portbench.trace; import echoscene_torch."
            "models.sgdiff; print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root)
    assert out.stdout.strip() == "[]"
