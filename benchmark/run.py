"""Run one cell of the benchmark once and print the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by name
(``harness``); its driver makes the inputs from the seed on the card, warms
up every shape it will use (``setup_s``), measures for ``--seconds``, and
then holds what the timed path produced against the plain reference
(``correct``).  With ``--trace 1`` the run also traces a short segment
after the window and prints the cell's per-layer metrics instead of its
end-to-end ones.  Without a CUDA card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache of the run at a fixed path in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    spec = harness.benchmark_spec()
    metrics = harness.cell_metrics(spec, args.workload, bool(args.trace))

    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(wl.get("chips", 1)):
        print(f"benchmark: the cell needs {wl.get('chips', 1)} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))

    run = harness.driver(wl["driver"]).run
    out = run(wl, cfg, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device="cuda", t_start=T_START)

    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}; the program may not "
              "use JAX or the JAX package", file=sys.stderr)
        return 3
    values = {}
    for m in metrics:
        # end-to-end metrics the driver takes itself; per-layer ones their
        # readers take from the run's record
        v = (harness.metric_reader(m["name"])(out["record"]) if args.trace
             else out["record"].get(m["name"]))
        if v is not None:
            values[m["name"]] = harness.metric_value(v, m["unit"])
    checks = out["checks"]
    print(f"setup {json.dumps(out['record'].get('setup_phases'))}", file=sys.stderr)
    print(f"readings {json.dumps(out['readings'])}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(harness.result_line(out["correct"], out["attempted"], out["failed"],
                              values, out["device"], checks,
                              out.get("breakdown") if args.trace else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
