"""What the benchmark's process may load: no JAX, no JAX libraries, no JAX
package (top-level names compared whole), and a reference that imports
nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

PROGRAM = "pcss_unet_tpu_torch"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pcss_unet_tpu_torch_like", object())
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pcss_unet_tpu.infer", object())
    assert harness.forbidden_modules() == ["pcss_unet_tpu"]


@pytest.mark.parametrize("cell", ["w16-2k.render", "w64-ref.train"])
def test_a_drivers_run_loads_no_jax(cell):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from conftest import tiny
from benchmark import harness
wl, cfg = tiny({cell!r})
out = harness.driver(wl["driver"]).run(wl, cfg, seed=2**31 + 21, seconds=0.2, trace=False,
                                       device="cpu", t_start=harness.clock())
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "program": {PROGRAM!r} in sys.modules, "correct": out["correct"]}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True, "correct": True}


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (PROGRAM, "pcss_unet_tpu", "jax", "flax"), \
                    f"{path.name} imports {n}"


@pytest.mark.cuda
def test_tiny_cells_trace_on_the_card(card):
    from benchmark.tests.conftest import tiny
    for cell in ("w16-2k.render", "w64-ref.render"):
        wl, cfg = tiny(cell)
        out = harness.driver(wl["driver"]).run(wl, cfg, seed=2 ** 31 + 22, seconds=0.5,
                                               trace=True, device=card,
                                               t_start=harness.clock())
        assert out["correct"], out["readings"]
        t = out["record"]["trace"]
        assert t["busy_s"] > 0 and t["launches_per_unit"] > 0
        assert all(0 < v <= 100 for v in t["roofline"].values())
