"""The readings a cell's correctness limits are set from, in one process:

  python -m benchmark.control --workload <cell> --seeds <a,b,...> \
      --control-seeds <x,y,z> [--seconds <s>]

For each of --seeds, the cell's set-up, a window of --seconds and its
check: the program's numbers (the lower readings). For each of
--control-seeds, the reference put in the program's place, computed in the
precision below the configuration's (the control), and with each fault the
cell can have planted in it. The cell's generator module (its traffic's
"generator") says which, in its ``readings(ctx, program)``. Each seed
prints one JSON line; the last line is the summary: per number, the
largest program reading and the least control and fault readings. The
harness's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from .common import Ctx
from .registry import Registry


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    w = reg.workload(args.workload)
    traffic = reg.traffic(w["traffic"])
    readings = importlib.import_module(f".{traffic['generator']}", __package__).readings
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    summary = {}
    for program, seeds in ((True, args.seeds), (False, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",")):
            ctx = Ctx(cfg=reg.config(w["config"]), traffic=traffic, limits=reg.limits(w["name"]),
                      seed=seed, seconds=args.seconds, trace=False, device=dev)
            out = readings(ctx, program)
            print(json.dumps({"seed": seed, **out}), flush=True)
            for kind, numbers in out.items():
                if not isinstance(numbers, dict):
                    continue
                for name, v in numbers.items():
                    s = summary.setdefault(name, {})
                    pick = max if kind == "program" else min
                    s[kind] = v if kind not in s else pick(s[kind], v)
            torch.cuda.empty_cache()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
