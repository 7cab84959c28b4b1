"""Run one cell of BENCHMARK.json once, on the machine it is started on.

  python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix; the mix names its
generator, a module of this package with ``run(ctx)`` (train_cell,
render_cell). Set-up makes the inputs and weights from the seed, builds
the program's objects and warms every shape the window meets; the window
then runs for --seconds; the check compares what the window's path
produced with the plain reference. With --trace 0
the result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from a torch.profiler trace of the window.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device[, breakdown] and, last, the numbers compared with
their limits, which also end standard error. Without as many CUDA devices
as the cell asks for, the run prints no result and exits 2; if JAX, flax,
optax or the JAX package was loaded, it prints no result and exits 3.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "intrinsic_neural_fields_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level packages among the loaded modules, by whole
    top-level name (intrinsic_neural_fields_tpu_torch is not
    intrinsic_neural_fields_tpu)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(registry, workload, seed, seconds, trace, device):
    """Run the cell on `device` and return (Outcome, the metrics dict)."""
    import importlib

    from .common import Ctx

    w = registry.workload(workload)
    traffic = registry.traffic(w["traffic"])
    ctx = Ctx(cfg=registry.config(w["config"]), traffic=traffic,
              limits=registry.limits(workload), seed=seed, seconds=seconds,
              trace=bool(trace), device=device)
    driver = importlib.import_module(f".{traffic['generator']}", __package__)
    out = driver.run(ctx)
    out.phases = ctx.phases
    metrics = {}
    if trace:
        for m, read in registry.per_layer(workload):
            v = read(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in registry.end_to_end(workload):
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    return out, metrics


def result_line(out, metrics, device_info):
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device_info}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None):
    args = parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from .registry import Registry

    registry = Registry()
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out, metrics = run_cell(registry, args.workload, args.seed, args.seconds, args.trace, device)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace:
        info["busy_s"] = out.busy_s
        info["window_s"] = out.window_s
    print("setup phases (s): " + ", ".join(f"{n} {s:.3f}" for n, s in out.phases)
          + f"; check after the window {out.check_s:.3f}", file=sys.stderr)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result_line(out, metrics, info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
