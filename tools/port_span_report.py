"""One traced benchmark run with the program's spans read out in full
(card only):

  python tools/port_span_report.py --workload <cell> --seed <n> [--seconds 10]

Runs the cell as ``python -m benchmark.run --trace 1`` does and prints one
JSON line: the end-to-end numbers of the traced window, its per-layer
metrics, the device's idle share split by the innermost program span the
host was in (``idle_self``, ``_spans.idle_by_span``: each span's own time,
its children's left out; ``outside``: no span open), the idle share inside
each span name, children included (``idle_inside``), the share of the
binning spans that reused the face table (``mesh_hit_share``, %, where
they say), and for a train cell
the clock check (``clock``, ``_spans.epoch_kernels``): each epoch inside
the window against the fwd_bwd kernels that start between its span and the
next epoch's, in ms: the first one's start after its ``train.replay``
span's start (>= 0) and after its end (at most a launch's latency, 2 ms),
as [min, median, max, epoch of the min, epoch of the max], and every epoch
that breaks either or whose kernels do not number its steps.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LATENCY_NS = 2_000_000  # the latest a replay's first kernel may start after its span ends


def clock_check(epochs):
    """The summary of _spans.epoch_kernels' epochs described above."""
    def stats(key):
        ms = [e[key] / 1e6 for e in epochs if e[key] is not None]
        if not ms:
            return None
        lo, hi = min(range(len(ms)), key=ms.__getitem__), max(range(len(ms)), key=ms.__getitem__)
        return [ms[lo], statistics.median(ms), ms[hi], lo, hi]

    off = [dict(e, epoch=i) for i, e in enumerate(epochs)
           if e["kernels"] != e["steps"] or e["after_start_ns"] is None
           or e["after_start_ns"] < 0 or e["after_end_ns"] > LATENCY_NS]
    return {"epochs": len(epochs), "kernel_after_replay_start": stats("after_start_ns"),
            "kernel_after_replay_end": stats("after_end_ns"), "off": off, "held": not off}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from benchmark.metrics import _spans
    from benchmark.registry import Registry
    from benchmark.run import run_cell

    if not torch.cuda.is_available():
        raise SystemExit("port_span_report: needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out, metrics = run_cell(Registry(), args.workload, args.seed, args.seconds, 1, device)
    run = out.record
    records = _spans.window(run)
    line = {"workload": args.workload, "seed": args.seed, "correct": out.correct,
            "device": torch.cuda.get_device_name(device),
            "power_limit": subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip(),
            "e2e": out.e2e, "idle_share": 100.0 * (1.0 - out.busy_s / out.window_s),
            "per_layer": {k: v["value"] for k, v in metrics.items()},
            "spans": None if records is None else len(records)}
    if records is not None:
        order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
        line["idle_self"] = order(_spans.idle_by_span(run, records))
        line["idle_inside"] = order({n: _spans.idle_inside_share(run, records, n)
                                     for n in {r["name"] for r in records}})
        bins = [r for r in _spans.named(records, "raster.bin") if "mesh_hit" in r["attrs"]]
        if bins:
            line["mesh_hit_share"] = 100.0 * sum(r["attrs"]["mesh_hit"] for r in bins) / len(bins)
        if run["kind"] == "train":
            line["clock"] = clock_check(_spans.epoch_kernels(run, records))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
