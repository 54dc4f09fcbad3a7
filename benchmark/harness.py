"""What every cell shares: finding its files by name, the clock and device
helpers, the run's record, and the result line.

A cell is ``workloads/<cell>.json``: its configuration (``configs/
<config>.json``), its driver (``drivers/<driver>.py``), its traffic
parameters and the limits of its correctness comparison.  The metrics a
cell reports are the entries of ``BENCHMARK.json`` that name it (or name
none and move an end-to-end metric it reports); a per-layer metric is read
by ``metrics/<metric>.py``, a kernel's operations and bytes by
``roofline/<kernel>.py``.  Adding a cell, a configuration, a metric or a
kernel is adding files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pcss_unet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload file {path}")
    return load_json(path)


def config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no configuration file {path}")
    return load_json(path)


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> float | None``."""
    mod = _module("metrics", name)
    if mod is None:
        raise SystemExit(f"no reader benchmark/metrics/{name}.py")
    return mod.read


def rooflines() -> dict:
    """Every ``roofline/<kernel>.py``, by kernel name."""
    out = {}
    for path in sorted((HERE / "roofline").glob("[!_]*.py")):
        out[path.stem] = _module("roofline", path.stem)
    return out


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in mine else [])]


def clock() -> float:
    return time.perf_counter()


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def metric_value(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None) -> str:
    """The contract's last line; ``check`` (each compared number beside its
    limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = checks
    return json.dumps(out)


class Done:
    """Completion of the work queued so far on ``device``'s stream: a CUDA
    event on the card; on the CPU (the tests) the work is already done."""

    def __init__(self, device):
        self.event = None
        if torch_device_type(device) == "cuda":
            import torch
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def torch_device_type(device) -> str:
    return getattr(device, "type", str(device).split(":")[0])


def synchronize(device) -> None:
    if torch_device_type(device) == "cuda":
        import torch
        torch.cuda.synchronize()


def device_info(device, trace_rec: dict | None = None) -> dict:
    """The result line's ``device``: the card's name and count, the peak
    memory allocated in the process, and with a trace its busy seconds and
    the traced window's length."""
    import torch
    if torch_device_type(device) == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace_rec is not None:
        info["busy_s"] = trace_rec["busy_s"]
        info["window_s"] = trace_rec["window_s"]
    return info


class no_tf32:
    """TF32 off for the reference (a float32 product stays float32);
    the program's settings come back on exit."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def judge(readings: dict, limits: dict) -> tuple[dict, bool]:
    """Each number the workload's ``limits`` name, beside its limit, and
    whether every one is within it."""
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))
