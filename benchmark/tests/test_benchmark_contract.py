"""The benchmark's files against its contract: every name in
``BENCHMARK.json`` is found by name, an added file is picked up with no
code edit, the result line carries exactly the contract's keys, and the
command refuses to run without a card or without the program."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.drivers import render
from benchmark.tests.conftest import ROOT, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_in_the_spec_is_found_by_name():
    spec = harness.benchmark_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert harness.config(c["name"])["name"] == c["name"]
    pairs = set()
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"]
        assert harness.driver(wl["driver"]).run
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for cell in (w["name"] for w in spec["workloads"]):
        e2e = {m["name"] for m in harness.cell_metrics(spec, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(spec, cell, True)
        assert layer and all(m["moves"] in e2e for m in layer)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert not any("K1" in n or "K4" in n for n in names)


def test_an_added_cell_configuration_and_metric_need_no_code(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", copy, ignore=shutil.ignore_patterns("__pycache__"))
    wl = json.loads((copy / "workloads" / "w16-2k.render.json").read_text())
    wl["config"] = "w16-wide"
    (copy / "workloads" / "w16-wide.render.json").write_text(json.dumps(wl))
    cfg = json.loads((copy / "configs" / "w16-2k.json").read_text())
    cfg["name"] = "w16-wide"
    (copy / "configs" / "w16-wide.json").write_text(json.dumps(cfg))
    (copy / "metrics" / "frames_seen.render.py").write_text(
        "def read(rec):\n    return rec.get('frame_ms')\n")
    (copy / "roofline" / "K9.py").write_text(
        "NAMES = ('k9_kernel',)\n\ndef bound_s(call):\n    return 1.0\n")
    monkeypatch.setattr(harness, "HERE", copy)
    assert harness.workload("w16-wide.render")["config"] == "w16-wide"
    assert harness.config("w16-wide")["encoder_widths"] == [16, 32, 128, 256]
    assert harness.metric_reader("frames_seen.render")({"frame_ms": 2.5}) == 2.5
    assert "K9" in harness.rooflines()
    spec = harness.benchmark_spec()
    spec["workloads"].append({"name": "w16-wide.render", "config": "w16-wide",
                              "traffic": "render", "chips": 1, "why": "-"})
    spec["per_layer"].append({"name": "frames_seen.render", "unit": "ms",
                              "moves": "frame_ms", "workloads": ["w16-wide.render"]})
    got = [m["name"] for m in harness.cell_metrics(spec, "w16-wide.render", True)]
    assert got == ["frames_seen.render"]
    e2e = [m["name"] for m in harness.cell_metrics(spec, "w16-wide.render", False)]
    assert e2e == ["setup_s"]     # its own metrics come with its entry's names


def test_the_result_line_carries_exactly_the_contract_keys():
    wl, cfg = tiny("w16-2k.render")
    out = render.run(wl, cfg, seed=2 ** 31 + 5, seconds=0.3, trace=False,
                     device="cpu", t_start=harness.clock())
    for breakdown in (None, {"device_ops": [], "idle_gaps": []}):
        line = json.loads(harness.result_line(
            out["correct"], out["attempted"], out["failed"],
            {"frame_ms": harness.metric_value(out["record"]["frame_ms"], "ms")},
            out["device"], out["checks"], breakdown))
        want = ["correct", "attempted", "failed", "metrics", "device"]
        want += ["breakdown"] if breakdown else []
        assert list(line) == want + ["check"]
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert all(set(c) == {"value", "limit"} for c in line["check"].values())
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("where", ["checkout", "bare"])
def test_the_command_refuses_without_a_card_or_the_program(tmp_path, where):
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cwd = ROOT
    if where == "bare":
        cwd = tmp_path
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "w16-2k.render", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
