#!/usr/bin/env python
"""Does torch.profiler see every kernel of a profiled data-parallel epoch?

  python tools/port_profile_records.py [--device cuda] [--rows 753664] [--k 512]
      [--repeats 20] [--pads-ms 0,50]

chip_smoke.py profiles one DP epoch (two replicas on one card, the HQ
recipe's 6 x 128 network at k=512, batch 4096, fused_mlp with the grads-only
wgrad and the Adam kernel) and requires the profiler to see D x steps
launches of each of the three kernels. This runs that profile `--repeats`
times for each window padding in `--pads-ms` (a sleep inside the profiler's
window before the epoch starts and after its final sync), first on a fresh
process, then again after bench.py's train leg has run at its full size
with its 4.3 GB table still alive, as in the smoke. Each profile prints one
JSON line: the kernels key_averages counted (chip_smoke.py's own count),
the raw device records of the three kernels, the time from the epoch's
start to the first record and from the last record to the epoch's sync
(host wall clock against the records' timestamps), and the least time
from a launch call to its kernel's start (below 0 the record is stamped
before its launch). Then a summary per phase and padding,
and the card's name and power limit (nvidia-smi). Run it with stderr
merged into stdout (2>&1): the profiler's own warnings land in order among
the lines. `--device cpu` rehearses the same steps on CPU replicas, where
the profiler sees no device records.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("KINETO_LOG_LEVEL", "2")  # the profiler's warnings, e.g. dropped records

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

HQ = {"num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
B = 4096
KERNELS = ("fwd_bwd", "wgrad", "fused_adam")


def emit(step, **fields):
    print(json.dumps({"step": step, **fields}), flush=True)


def profile_once(run, pad_s, epoch):
    """One profiled DP epoch in chip_smoke.py's PaddedProfile; the line's
    fields."""
    from chip_smoke import PaddedProfile, _device_us_by_kernel, _port_kernel
    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    train_epoch, state, data, nb, dev = run
    D = len(train_epoch.devices)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with PaddedProfile(pad_s) as p:
        _, m = train_epoch(state, fold_in(PRNGKey(0), epoch), data, nb, B)
        float(m["loss"])
    _, counts = _device_us_by_kernel(p.prof, with_counts=True)
    seen = dict.fromkeys(KERNELS, 0)
    for name, n in counts.items():
        kernel = _port_kernel(name)
        if kernel is not None:
            seen[kernel] = seen.get(kernel, 0) + n
    return {"pad_ms": 1e3 * pad_s, "expected": D * nb, "seen": seen,
            "short": any(seen[k] != D * nb for k in KERNELS),
            "epoch_ms": (p.end_ns - p.start_ns) / 1e6, **p.margins()}


def make_run(dev, rows, k):
    from port_dp_cards import make_data

    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
    from intrinsic_neural_fields_tpu_torch.train.steps import AdamHyper, create_train_state
    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    devices = [dev, dev]
    data = make_data(rows, k, dev)
    model = make_model({"k": k, **HQ}, seed=0, device=dev)
    train_epoch, _ = make_dp_epoch_fns(model, "L1", devices, shuffle="blocks", fused=True)
    state = create_train_state(model, AdamHyper(1e-4), dev)
    state, m = train_epoch(state, fold_in(PRNGKey(0), 0), data, rows // B, B)  # warm
    float(m["loss"])
    return train_epoch, state, data, rows // B, dev


def phase(name, run, pads, repeats):
    summary = {}
    for pad in pads:
        lines = []
        for i in range(repeats):
            line = profile_once(run, pad / 1e3, 100 + i)
            emit("profile", phase=name, repeat=i, **line)
            lines.append(line)
        short = [ln for ln in lines if ln["short"]]
        summary[f"pad_{pad:g}ms"] = {
            "profiles": len(lines), "short": len(short),
            "missing": [{k: ln["expected"] - ln["seen"][k] for k in KERNELS} for ln in short],
            **{f"{f}_min": min((ln[f] for ln in lines if ln.get(f) is not None), default=None)
               for f in ("first_after_start_ms", "end_after_last_ms",
                         "launch_to_start_min_ms")}}
    emit("summary", phase=name, **summary)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=753664)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--pads-ms", default="0,50")
    args = ap.parse_args(argv)
    from intrinsic_neural_fields_tpu_torch import bench, resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    pads = [float(p) for p in args.pads_ms.split(",")]
    run = make_run(dev, args.rows, args.k)
    phase("fresh", run, pads, args.repeats)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        leg = bench.train_leg(bench.make_arrays(), device=dev)
        emit("bench_train_leg", seconds=time.perf_counter() - t0,
             rays_per_s_best=leg.rays_per_s_best, peak_mem_gb=leg.peak_mem_gb)
        phase("after_bench_train_leg", run, pads, args.repeats)
        del leg
    print(bench.card_name(dev), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
